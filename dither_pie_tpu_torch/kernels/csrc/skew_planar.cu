// K6: skew compact planes into the wavefront stream.
//
// Replaces the TPU kernel dither_pie_tpu/ops/wavefront.py
// `_skew_transpose_fused_call`: compact planar frames in, skewed stream
// out, no padded intermediate. The planes are (R, H, W) with R = 3B rows in
// the order c*B + b, which a (3, B, H, W) channel-major batch (the layout
// ffmpeg's gbrp gives) already is, as a free view; the stream is
// out[d, r, y] = in[r, y, d - s*y], 0 outside the image. For the same
// frames it equals K1's stream bit for bit: K1 reads NHWC and folds the
// deinterleave into its loads, this one reads planes. Any R is served (a
// one-plane aux map too), not only multiples of 3.
//
// What bounds it: bytes. It reads the planes once and writes D*R*H
// elements (D = W + s*(H-1), ~2x the input at 1080p with s = 2); there is
// no arithmetic. On the TPU this needs windowed reads and chains of lane
// rolls; here each thread gathers its element. One thread per OUTPUT
// element keeps the stores coalesced (neighbouring y); the loads stride by
// a row of the plane (W - s elements) between neighbouring y and lean on
// L2, as K1's do. The element type passes through unchanged (u8 stays u8,
// f32 stays f32).
//
// Who calls which form: `ops.wavefront.skew_planar` sends uint8 planes here
// and float32 planes to K7 (skew_transpose.cu). The float32 instantiation
// stays as K7's counterpart: `skew_planar_gather` reaches it, and only
// chip_smoke.py and the card's tests call that with float32 planes, to hold
// K7's stream to this one bit for bit.

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

template <typename T>
__global__ void skew_planar_kernel(const T* __restrict__ in,
                                   T* __restrict__ out, int R, int H, int W,
                                   int D, int s) {
    const int64_t n = (int64_t)D * R * H;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int y = (int)(i % H);
        const int64_t q = i / H;
        const int r = (int)(q % R);
        const int d = (int)(q / R);
        const int x = d - s * y;
        out[i] = (x >= 0 && x < W) ? in[((int64_t)r * H + y) * W + x] : T(0);
    }
}

template <typename T>
int launch(const T* in, T* out, int R, int H, int W, int D, int s,
           void* stream) {
    const int threads = 256;
    const int blocks = dpt_grid_blocks((int64_t)D * R * H, threads);
    skew_planar_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        in, out, R, H, W, D, s);
    return (int)cudaGetLastError();
}

}  // namespace

int dpt_skew_planar_u8(const uint8_t* in, uint8_t* out, int R, int H, int W,
                       int D, int s, void* stream) {
    return launch<uint8_t>(in, out, R, H, W, D, s, stream);
}

int dpt_skew_planar_f32(const float* in, float* out, int R, int H, int W,
                        int D, int s, void* stream) {
    return launch<float>(in, out, R, H, W, D, s, stream);
}
