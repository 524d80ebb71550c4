// K7: the transposing skew, frames -> wavefront stream through a tile.
//
// Replaces the TPU kernel dither_pie_tpu/ops/wavefront.py
// `_skew_transpose_call`: (r, lf, d_t) u8 or f32 -> (d_t, r, lf), a 2-D
// transpose per plane fused with the float cast. Its input there is the
// "stride lemma" form of the frames: a row-major plane viewed with a row
// stride s short of its width shows row y shifted right by s*y, so
// in[r, y, d] is the pixel (y, d - s*y) and the transpose alone gives the
// skewed stream. XLA pads and copies to make that form; in PyTorch it is a
// free view (`as_strided`), so this kernel takes the view's strides and
// reads the frames in place:
//   out[d, r, y] = cast(in[r, y, d])   where 0 <= d - s*y < W, else 0.
// Outside that parallelogram the view shows other rows' pixels (the TPU
// scan masks them; this port's streams hold 0 there), so the kernel takes
// (s, W) and writes 0 without reading. The result equals K1's stream
// (skew.cu, C = 3) for NHWC frames and K6's (skew.cu, C = 1) for compact
// planes, bit for bit and everywhere.
//
// Rows: r = c*rows_inner + b starts at c*stride_outer + b*stride_inner, so
// the channel-major row order c*B + b is reached from NHWC frames
// (stride_outer 1, stride_inner H*W*3, stride_d 3) as well as from compact
// planes (one row stride, stride_d 1) without a copy.
//
// Instantiated u8 -> u8, f32 -> f32 and u8 -> f32. The last is the TPU
// kernel's cast; this port's scan reads u8 itself, so only the same-type
// forms are on a path (float32 frames take f32 -> f32).
//
// What bounds it: bytes. The frames are read once and D*R*H elements
// written (about twice the input at 1080p, s = 2); there is no arithmetic.
// A gather of one element a thread, neighbouring threads a row of the
// frame apart, touches its own 32-byte sector with every load. Here a block
// moves a 64 x 64 tile through shared memory: the loads run along d
// (neighbouring threads on neighbouring elements of a frame row), the
// stores along y (neighbouring elements of the stream), and each sector is
// touched by one or two warps. The tile's rows are padded by 4 bytes, which
// makes their stride an odd number of 32-bit banks, so the transposed read
// of a column meets no bank conflict. A warp still moves only 32 bytes per
// u8 access; packing four pixels into one 32-bit access is the next step.

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

constexpr int TILE = 64;
constexpr int TILE_ROWS = 4;  // rows of the tile that one pass of the block moves

template <typename TI, typename TO>
__global__ void __launch_bounds__(TILE * TILE_ROWS)
skew_transpose_kernel(const TI* __restrict__ in, TO* __restrict__ out, int R,
                      int rows_inner, int64_t stride_outer,
                      int64_t stride_inner, int64_t stride_y, int64_t stride_d,
                      int H, int W, int D, int s) {
    constexpr int PAD = 4 / sizeof(TI);
    __shared__ TI tile[TILE][TILE + PAD];
    const int d0 = blockIdx.x * TILE;
    const int y0 = blockIdx.y * TILE;
    const int tx = threadIdx.x % TILE;
    const int ty = threadIdx.x / TILE;
    for (int r = blockIdx.z; r < R; r += gridDim.z) {
        const TI* row = in + (r / rows_inner) * stride_outer +
                        (r % rows_inner) * stride_inner;
        // Load along d: tile[y][d].
        for (int j = ty; j < TILE; j += TILE_ROWS) {
            const int y = y0 + j;
            const int d = d0 + tx;
            const int x = d - s * y;
            TI v = TI(0);
            if (y < H && d < D && x >= 0 && x < W) {
                v = row[y * stride_y + d * stride_d];
            }
            tile[j][tx] = v;
        }
        __syncthreads();
        // Store along y: out[d][r][y].
        for (int j = ty; j < TILE; j += TILE_ROWS) {
            const int d = d0 + j;
            const int y = y0 + tx;
            if (d < D && y < H) {
                out[((int64_t)d * R + r) * H + y] = (TO)tile[tx][j];
            }
        }
        __syncthreads();
    }
}

template <typename TI, typename TO>
int launch(const TI* in, TO* out, int R, int rows_inner, int64_t stride_outer,
           int64_t stride_inner, int64_t stride_y, int64_t stride_d, int H,
           int W, int D, int s, void* stream) {
    if (R < 1 || H < 1 || D < 1 || rows_inner < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const int tiles_y = (H + TILE - 1) / TILE;
    if (tiles_y > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((D + TILE - 1) / TILE, tiles_y, R < 65535 ? R : 65535);
    skew_transpose_kernel<TI, TO>
        <<<grid, TILE * TILE_ROWS, 0, (cudaStream_t)stream>>>(
            in, out, R, rows_inner, stride_outer, stride_inner, stride_y,
            stride_d, H, W, D, s);
    return (int)cudaGetLastError();
}

}  // namespace

int dpt_skew_transpose_u8(const uint8_t* in, uint8_t* out, int R,
                          int rows_inner, int64_t stride_outer,
                          int64_t stride_inner, int64_t stride_y,
                          int64_t stride_d, int H, int W, int D, int s,
                          void* stream) {
    return launch<uint8_t, uint8_t>(in, out, R, rows_inner, stride_outer,
                                    stride_inner, stride_y, stride_d, H, W, D,
                                    s, stream);
}

int dpt_skew_transpose_f32(const float* in, float* out, int R, int rows_inner,
                           int64_t stride_outer, int64_t stride_inner,
                           int64_t stride_y, int64_t stride_d, int H, int W,
                           int D, int s, void* stream) {
    return launch<float, float>(in, out, R, rows_inner, stride_outer,
                                stride_inner, stride_y, stride_d, H, W, D, s,
                                stream);
}

int dpt_skew_transpose_u8_f32(const uint8_t* in, float* out, int R,
                              int rows_inner, int64_t stride_outer,
                              int64_t stride_inner, int64_t stride_y,
                              int64_t stride_d, int H, int W, int D, int s,
                              void* stream) {
    return launch<uint8_t, float>(in, out, R, rows_inner, stride_outer,
                                  stride_inner, stride_y, stride_d, H, W, D,
                                  s, stream);
}
