// K3: unskew the scan's packed colours and unpack them to uint8, NHWC or
// planar.
//
// Replaces the TPU kernel dither_pie_tpu/ops/wavefront.py
// `_unskew_unpack_call` (reached through `_unskew_unpack_colors`): the same
// function, out[b, y, x, c] = (col[x + s*y, b, y] >> (16 - 8c)) & 255. The
// TPU kernel emits three planes, which `planar_out` hands on as they are
// and XLA otherwise restacks into NHWC; this one writes either layout
// directly: NHWC out[b, y, x, c], or the planes out[c, b, y, x] of the
// planar video flow.
//
// What bounds it: bytes, 4 read and 3 written per pixel, no arithmetic
// beyond shifts. One thread per output pixel keeps the stores coalesced
// (neighbouring x; in the planar layout each of the three stores is a run
// of whole bytes in its own plane); the loads step by B*H int32 between
// neighbouring x and lean on L2. A shared-memory tile transpose is the
// obvious next step if this kernel ever shows in the breakdown.

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

template <bool PLANAR>
__global__ void unskew_unpack_kernel(const int32_t* __restrict__ col,
                                     uint8_t* __restrict__ out, int B, int H,
                                     int W, int s) {
    const int64_t n = (int64_t)B * H * W;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int x = (int)(i % W);
        const int64_t q = i / W;
        const int y = (int)(q % H);
        const int b = (int)(q / H);
        const int32_t v = col[((int64_t)(x + s * y) * B + b) * H + y];
        const uint8_t r = (uint8_t)((v >> 16) & 255);
        const uint8_t g = (uint8_t)((v >> 8) & 255);
        const uint8_t bl = (uint8_t)(v & 255);
        if (PLANAR) {
            out[i] = r;
            out[n + i] = g;
            out[2 * n + i] = bl;
        } else {
            out[3 * i] = r;
            out[3 * i + 1] = g;
            out[3 * i + 2] = bl;
        }
    }
}

}  // namespace

int dpt_unskew_unpack(const int32_t* col, uint8_t* out, int B, int H, int W,
                      int s, int planar, void* stream) {
    const int threads = 256;
    const int blocks = dpt_grid_blocks((int64_t)B * H * W, threads);
    if (planar) {
        unskew_unpack_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            col, out, B, H, W, s);
    } else {
        unskew_unpack_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            col, out, B, H, W, s);
    }
    return (int)cudaGetLastError();
}
