// K1: skew NHWC frames into the wavefront stream.
//
// Replaces the TPU kernel dither_pie_tpu/ops/wavefront.py
// `_skew_fullrow_call` (reached through `_skew_packed_fused`): the same
// function, out[d, c*B + b, y] = x[b, y, d - s*y, c], with the batch folded
// into rows c*B + b and the frame's row index y as the fastest axis, so the
// scan reads one contiguous run of H values per (step, row).
//
// What bounds it: bytes. It reads the frames once and writes D*3B*H
// elements (D = W + s*(H-1), so ~2x the input at 1080p with s = 2); there
// is no arithmetic. The TPU needed bit-selected lane rolls because it
// cannot gather; here each thread gathers its own element. One thread per
// OUTPUT element keeps the stores coalesced (neighbouring threads write
// neighbouring y); the loads stride by a row of the frame and lean on L2.
// Positions outside the image parallelogram are written 0, so the output
// is fully defined and equals the plain PyTorch version element for
// element. The element type passes through unchanged (u8 stays u8, f32
// stays f32): exact, and a quarter of the bytes for u8 video frames.
//
// Who calls which form: `ops.wavefront.skew` sends uint8 frames here and
// float32 frames to K7 (skew_transpose.cu). The float32 instantiation stays
// as K7's counterpart: `skew_gather` reaches it, and only chip_smoke.py and
// the card's tests call that with float32 frames, to hold K7's stream to
// this one bit for bit.

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

template <typename T>
__global__ void skew_kernel(const T* __restrict__ in, T* __restrict__ out,
                            int B, int H, int W, int D, int s) {
    const int64_t rows = 3 * (int64_t)B;
    const int64_t n = (int64_t)D * rows * H;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int y = (int)(i % H);
        const int64_t q = i / H;
        const int r = (int)(q % rows);
        const int d = (int)(q / rows);
        const int c = r / B;
        const int b = r - c * B;
        const int x = d - s * y;
        out[i] = (x >= 0 && x < W)
                     ? in[(((int64_t)b * H + y) * W + x) * 3 + c]
                     : T(0);
    }
}

template <typename T>
int launch(const T* in, T* out, int B, int H, int W, int D, int s,
           void* stream) {
    const int threads = 256;
    const int blocks = dpt_grid_blocks((int64_t)D * 3 * B * H, threads);
    skew_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        in, out, B, H, W, D, s);
    return (int)cudaGetLastError();
}

}  // namespace

int dpt_skew_u8(const uint8_t* in, uint8_t* out, int B, int H, int W, int D,
                int s, void* stream) {
    return launch<uint8_t>(in, out, B, H, W, D, s, stream);
}

int dpt_skew_f32(const float* in, float* out, int B, int H, int W, int D,
                 int s, void* stream) {
    return launch<float>(in, out, B, H, W, D, s, stream);
}
