// K5: unskew the scan's palette indices into the (B, H, W) index stream.
//
// Replaces the TPU kernel dither_pie_tpu/ops/wavefront.py
// `_unskew_transpose_call` (reached through `_unskew_idx_packed`):
// out[b, y, x] = idx[x + s*y, b, y]. The TPU kernel emits int32 and XLA
// narrows it afterwards; this one writes the stream's own type, uint8 for
// palettes of up to 256 colours and uint16 above, so the narrow stream is
// the only thing written. It is the epilogue of the index scan, whose
// indices lie in 0..P-1; it does not check them.
//
// What bounds it: bytes, 4 read and 1 or 2 written per pixel (and it reads
// only the W*H valid entries of each frame's D*H), no arithmetic. The TPU's
// aligned 128-step windows, in-VMEM transposes and bit-selected lane rolls
// exist because it cannot gather; here each thread gathers its element.
// One thread per output element keeps the stores coalesced (neighbouring
// x); the loads step by B*H int32 between neighbouring x and lean on L2,
// as K3's do.

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

template <typename T>
__global__ void unskew_idx_kernel(const int32_t* __restrict__ idx,
                                  T* __restrict__ out, int B, int H, int W,
                                  int s) {
    const int64_t n = (int64_t)B * H * W;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int x = (int)(i % W);
        const int64_t q = i / W;
        const int y = (int)(q % H);
        const int b = (int)(q / H);
        out[i] = (T)idx[((int64_t)(x + s * y) * B + b) * H + y];
    }
}

template <typename T>
int launch(const int32_t* idx, T* out, int B, int H, int W, int s,
           void* stream) {
    const int threads = 256;
    const int blocks = dpt_grid_blocks((int64_t)B * H * W, threads);
    unskew_idx_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        idx, out, B, H, W, s);
    return (int)cudaGetLastError();
}

}  // namespace

int dpt_unskew_idx_u8(const int32_t* idx, uint8_t* out, int B, int H, int W,
                      int s, void* stream) {
    return launch<uint8_t>(idx, out, B, H, W, s, stream);
}

int dpt_unskew_idx_u16(const int32_t* idx, uint16_t* out, int B, int H, int W,
                       int s, void* stream) {
    return launch<uint16_t>(idx, out, B, H, W, s, stream);
}
