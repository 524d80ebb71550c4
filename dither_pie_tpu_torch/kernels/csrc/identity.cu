// T3: identity copy of a uint8 tensor.
//
// Replaces the Pallas identity of tools/xla_layout_repro.py
// (`_pallas_identity`): out = in for a (3, N, W) u8 plane, there in blocks
// of 512 rows whose operand layout was the thing under test. On this card a
// tensor's layout is its strides and nothing reassigns it, so what the probe
// keeps is the copy itself: the measured ceiling of a kernel that reads
// every byte once and writes it once, to stand beside the 3.35 TB/s that
// the bounds of the other kernels are computed from.
//
// Design. A grid-stride loop of 16-byte accesses (one uint4 a thread and
// step, neighbouring threads on neighbouring addresses) over the first
// n / 16 vectors, then the n mod 16 tail bytes one by one. The vector path
// needs both base pointers on a 16-byte boundary; a tensor sliced off its
// allocation's start may not be, and then every byte takes the scalar path.
// Any size, any shape: the tensor is contiguous and is copied as bytes.
//
// What bounds it: bytes, 2 n over the memory rate (0.371 ms for one
// 100 x 1080p batch of 622 MB).

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

__global__ void __launch_bounds__(256)
identity_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                int64_t n, int vectors) {
    const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    int64_t done = 0;
    if (vectors) {
        const int64_t n_vec = n >> 4;
        const uint4* in4 = reinterpret_cast<const uint4*>(in);
        uint4* out4 = reinterpret_cast<uint4*>(out);
        for (int64_t i = tid; i < n_vec; i += stride) out4[i] = in4[i];
        done = n_vec << 4;
    }
    for (int64_t i = done + tid; i < n; i += stride) out[i] = in[i];
}

}  // namespace

int dpt_identity_u8(const uint8_t* in, uint8_t* out, int64_t n, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const bool aligned = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const int vectors = aligned && n >= 16;
    const int threads = 256;
    const int blocks = dpt_grid_blocks(vectors ? n >> 4 : n, threads);
    identity_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(in, out, n,
                                                                  vectors);
    return (int)cudaGetLastError();
}
