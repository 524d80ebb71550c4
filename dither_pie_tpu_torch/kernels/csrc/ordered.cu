// K4: fused ordered (threshold-screen) dithering.
//
// Replaces the TPU kernel dither_pie_tpu/ops/ordered_pallas.py
// `_compiled_padded` (body `_build`). It computes the same function, for
// every pixel i = (b, y, x) of a (B, H, W, 3) batch, u8 or float32 (a
// float32 pixel is taken as it is, never truncated: the wavelet mode's
// reconstruction is not integer-valued):
//   d_p    = (dr*dr + dg*dg) + db*db, dr = r - pal[p].r, ... in float32
//   (d1, i1), (d2, i2) = running top-2 over p = 0..P-1, strict <, so the
//                        lowest index wins every tie
//   factor = d1 + d2 == 0 ? 0 : d1 / (d1 + d2)
//   idx    = factor <= screen[y, x] ? i1 : i2
//   out    = (u8)(int)palette[idx] (3 bytes), or (u8)idx with emit_idx
//
// Design.
//  * One thread per pixel in a grid-stride loop over B*H*W, reading NHWC
//    directly: neighbouring threads read neighbouring 3-byte (u8) or
//    12-byte (float32) pixels and write neighbouring 3-byte ones. The
//    kernel is a template on the input type; everything after the three
//    loads is one body. The TPU kernel's planar (3, rows, 128k) repack, row and lane
//    padding and sentinel palette entries were its tiling; none is needed.
//  * The (H, W) screen is read at i mod H*W for every frame, not tiled over
//    the batch: a 1080p float32 screen is 8.3 MB and stays in the 50 MB L2.
//  * The palette is staged once per block in shared memory as three
//    float32 planes (dynamic, 12 bytes per entry: P <= 4096 fits the 48 KB
//    a block gets without opting in). Every thread of a warp reads the
//    same entry, a broadcast without bank conflicts.
//  * Rounding: the differences, squares, sums and the division use the _rn
//    intrinsics and the build adds --fmad=false, so no multiply-add is
//    contracted into an FMA; the result is bit for bit the plain PyTorch
//    version's (dither_pie_tpu_torch/ops/ordered_fused.py).
//  * What bounds it: at 16 x 1080p with P = 16 it moves 99.5 MB in (398 MB
//    of float32 frames), 99.5 MB out and the 8.3 MB screen (~62 us at
//    3.35 TB/s; ~151 us from float32), and runs ~12 FP32
//    operations per palette entry per pixel (~6.4 G operations, plus one
//    shared-memory load per plane and entry). So it sits near the balance
//    at P = 16 and is bound by arithmetic as P grows. Holding the palette
//    in registers or constant memory and giving each thread several pixels
//    are the first steps to make it faster.

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
ordered_fused_kernel(const T* __restrict__ img,
                     const float* __restrict__ pal, int P,
                     const float* __restrict__ screen, int64_t n, int64_t hw,
                     uint8_t* __restrict__ out, int emit_idx) {
    extern __shared__ float spal[];  // [0, P): r, [P, 2P): g, [2P, 3P): b
    float* pr = spal;
    float* pg = spal + P;
    float* pb = spal + 2 * P;
    for (int k = threadIdx.x; k < P; k += blockDim.x) {
        pr[k] = pal[3 * k];
        pg[k] = pal[3 * k + 1];
        pb[k] = pal[3 * k + 2];
    }
    __syncthreads();

    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        const float r = (float)img[3 * i];
        const float g = (float)img[3 * i + 1];
        const float b = (float)img[3 * i + 2];
        float d1 = __int_as_float(0x7f800000);  // +inf
        float d2 = d1;
        int i1 = 0, i2 = 0;
        for (int p = 0; p < P; ++p) {
            const float dr = __fsub_rn(r, pr[p]);
            const float dg = __fsub_rn(g, pg[p]);
            const float db = __fsub_rn(b, pb[p]);
            const float d = __fadd_rn(
                __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dg, dg)),
                __fmul_rn(db, db));
            if (d < d1) {
                d2 = d1;
                i2 = i1;
                d1 = d;
                i1 = p;
            } else if (d < d2) {
                d2 = d;
                i2 = p;
            }
        }
        const float tot = __fadd_rn(d1, d2);
        const float factor = tot == 0.f ? 0.f : __fdiv_rn(d1, tot);
        const int idx = factor <= screen[i % hw] ? i1 : i2;
        if (emit_idx) {
            out[i] = (uint8_t)idx;
        } else {
            // f32 -> i32 truncates, as the TPU kernel's astype does.
            out[3 * i] = (uint8_t)(int)pr[idx];
            out[3 * i + 1] = (uint8_t)(int)pg[idx];
            out[3 * i + 2] = (uint8_t)(int)pb[idx];
        }
    }
}

template <typename T>
int launch(const T* img, const float* pal, int P, const float* screen,
           int64_t n, int64_t hw, uint8_t* out, int emit_idx, void* stream) {
    const int threads = 256;
    const int blocks = dpt_grid_blocks(n, threads);
    const size_t smem = 3 * (size_t)P * sizeof(float);
    ordered_fused_kernel<T><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        img, pal, P, screen, n, hw, out, emit_idx);
    return (int)cudaGetLastError();
}

}  // namespace

int dpt_ordered_fused_u8(const uint8_t* img, const float* pal, int P,
                         const float* screen, int64_t n, int64_t hw,
                         uint8_t* out, int emit_idx, void* stream) {
    return launch<uint8_t>(img, pal, P, screen, n, hw, out, emit_idx, stream);
}

int dpt_ordered_fused_f32(const float* img, const float* pal, int P,
                          const float* screen, int64_t n, int64_t hw,
                          uint8_t* out, int emit_idx, void* stream) {
    return launch<float>(img, pal, P, screen, n, hw, out, emit_idx, stream);
}
