// K9: unskew the scan's palette indices and select their colours, NHWC
// uint8.
//
// Replaces the TPU kernel dither_pie_tpu/ops/wavefront.py
// `_unskew_select_call` (reached through `_unskew_select_colors`):
// out[b, y, x, c] = (int)palette[idx[x + s*y, b, y], c], the palette's
// float32 -> int32 cast truncating. The TPU kernel served at most 256
// colours (its scalar memory) through a chain of selects (it has no
// gather) and emitted three planes; this one gathers from a palette of any
// size and writes NHWC directly. It is the epilogue of K8, whose indices
// lie in 0..P-1; it does not check them.
//
// What bounds it: bytes, 4 read and 3 written per pixel, plus the gather,
// which the read-only cache serves (a 4096-colour palette is 48 KB). One
// thread per output pixel keeps the stores coalesced (neighbouring x); the
// index loads step by B*H int32 between neighbouring x and lean on L2, as
// K3's do.

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

__global__ void unskew_select_kernel(const int32_t* __restrict__ idx,
                                     const float* __restrict__ pal,
                                     uint8_t* __restrict__ out, int B, int H,
                                     int W, int s) {
    const int64_t n = (int64_t)B * H * W;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int x = (int)(i % W);
        const int64_t q = i / W;
        const int y = (int)(q % H);
        const int b = (int)(q / H);
        const float* c = pal + 3 * (int64_t)idx[((int64_t)(x + s * y) * B + b) * H + y];
        out[3 * i] = (uint8_t)(int32_t)c[0];
        out[3 * i + 1] = (uint8_t)(int32_t)c[1];
        out[3 * i + 2] = (uint8_t)(int32_t)c[2];
    }
}

}  // namespace

int dpt_unskew_select(const int32_t* idx, const float* pal, uint8_t* out,
                      int B, int H, int W, int s, void* stream) {
    const int threads = 256;
    const int blocks = dpt_grid_blocks((int64_t)B * H * W, threads);
    unskew_select_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        idx, pal, out, B, H, W, s);
    return (int)cudaGetLastError();
}
