// T3: identity copy of a uint8 tensor.
//
// Replaces the Pallas identity of tools/xla_layout_repro.py
// (`_pallas_identity`): out = in for a (3, N, W) u8 plane, there in blocks
// of 512 rows whose operand layout was the thing under test. On this card a
// tensor's layout is its strides and nothing reassigns it, so what the probe
// keeps is the copy itself: the measured ceiling of a kernel that reads
// every byte once and writes it once, to stand beside the 3.35 TB/s that
// the bounds of the other kernels are computed from. Any size, any base
// alignment: the tensor is contiguous and is copied as bytes.
//
// What bounds it: bytes, 2 n over the memory rate (0.371 ms for one
// 100 x 1080p plane of 622 MB). The plan (`tools.layout_repro.
// identity_plan`; the launcher refuses any other) cuts the copy in three:
// a head of up to 15 bytes that brings `out` to a 16-byte boundary, a body
// of whole 16-byte words, and a tail of up to 15 bytes. Head and tail go
// byte by byte (block 0). Two forms move the body:
//
// * stride (in and out agree mod 16): a grid-stride loop of 16-byte
//   accesses, one uint4 a thread and step, neighbouring threads on
//   neighbouring addresses. The plan's default grid has a block for every
//   256 words, so each thread copies one word and the loop runs once: on an
//   H100 that matched clone(), where grids of 4 to 512 blocks an SM that
//   loop were 1-6 % slower, and a ring of TMA bulk copies through shared
//   memory was no faster whatever its spans, stages and blocks (PERF.md,
//   the identity's findings).
// * shifted (in and out disagree mod 16): out's words stay aligned, and
//   each is built from the two aligned input words that hold its bytes, by
//   a funnel shift that is the same for the whole copy. The body is cut
//   into spans of `span` bytes on 16-byte boundaries, dealt to a persistent
//   grid of a few blocks an SM: block b streams spans b, b + G, b + 2G, ...
//   (G blocks). A simple path: held bitwise, timed, not tuned.

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

constexpr int IDENTITY_THREADS = 256;

// Head and tail: bytes [0, head) and [head + body, n), by block 0.
__device__ __forceinline__ void copy_ends(const uint8_t* __restrict__ in,
                                          uint8_t* __restrict__ out, int64_t n,
                                          int64_t head, int64_t body) {
    if (blockIdx.x != 0) return;
    for (int64_t i = threadIdx.x; i < head; i += blockDim.x) out[i] = in[i];
    for (int64_t i = head + body + threadIdx.x; i < n; i += blockDim.x) out[i] = in[i];
}

__global__ void __launch_bounds__(IDENTITY_THREADS)
identity_stride_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                       int64_t n, int64_t head, int64_t body) {
    copy_ends(in, out, n, head, body);
    const uint4* in4 = reinterpret_cast<const uint4*>(in + head);
    uint4* out4 = reinterpret_cast<uint4*>(out + head);
    const int64_t words = body >> 4;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < words; i += stride) {
        out4[i] = in4[i];
    }
}

// The spans of this block: the k-th at body offset (blockIdx.x +
// k*gridDim.x) * span; every one but the body's last is `span` bytes long.
// Without a body the plan's span is 0, and there are none.
struct Spans {
    int64_t body, span, count;
    __device__ Spans(int64_t body_, int64_t span_) : body(body_), span(span_) {
        const int64_t total = span > 0 ? (body + span - 1) / span : 0;
        count = blockIdx.x < total ? (total - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    }
    __device__ int64_t start(int64_t k) const { return (blockIdx.x + k * gridDim.x) * span; }
    __device__ int64_t end(int64_t k) const { return min(body, start(k) + span); }
};

// The 16 bytes that start 4*W4 + sh/8 bytes into the 32 bytes (a, b).
template <int W4>
__device__ __forceinline__ uint4 funnel16(const uint4& a, const uint4& b, int sh) {
    const uint32_t u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    return make_uint4(__funnelshift_r(u[W4], u[W4 + 1], sh),
                      __funnelshift_r(u[W4 + 1], u[W4 + 2], sh),
                      __funnelshift_r(u[W4 + 2], u[W4 + 3], sh),
                      __funnelshift_r(u[W4 + 3], u[W4 + 4], sh));
}

__global__ void __launch_bounds__(IDENTITY_THREADS)
identity_shifted_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                        int64_t n, int64_t head, int64_t body, int64_t span) {
    copy_ends(in, out, n, head, body);
    const Spans sp(body, span);
    // Output word w's bytes start r bytes into the aligned input word src[w]
    // (r in 1..15, the same for every word) and end in src[w + 1], which
    // also holds bytes of the tensor: both loads stay inside its words.
    const uintptr_t first = reinterpret_cast<uintptr_t>(in + head);
    const int r = (int)(first & 15);
    const int sh = 8 * (r & 3);
    for (int64_t k = 0; k < sp.count; ++k) {
        const int64_t words = (sp.end(k) - sp.start(k)) >> 4;
        const uint4* src = reinterpret_cast<const uint4*>(first - r + sp.start(k));
        uint4* dst = reinterpret_cast<uint4*>(out + head + sp.start(k));
        for (int64_t w = threadIdx.x; w < words; w += IDENTITY_THREADS) {
            const uint4 a = __ldg(src + w), b = __ldg(src + w + 1);
            uint4 q;
            switch (r >> 2) {
                case 0: q = funnel16<0>(a, b, sh); break;
                case 1: q = funnel16<1>(a, b, sh); break;
                case 2: q = funnel16<2>(a, b, sh); break;
                default: q = funnel16<3>(a, b, sh); break;
            }
            __stcs(dst + w, q);
        }
    }
}

}  // namespace

int dpt_identity_u8(const uint8_t* in, uint8_t* out, int64_t n, const DptIdentityPlan& plan,
                    void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    const int in16 = (int)(reinterpret_cast<uintptr_t>(in) % 16);
    const int out16 = (int)(reinterpret_cast<uintptr_t>(out) % 16);
    const int64_t head = n < (16 - out16) % 16 ? n : (16 - out16) % 16;
    const int64_t body = (n - head) / 16 * 16;
    const int form = in16 == out16 ? DPT_IDENTITY_STRIDE : DPT_IDENTITY_SHIFTED;
    // At most one block a unit of work (a block's first step of words, or a
    // span), and one block without a body: it copies the head and tail.
    int64_t units = 1;
    bool span_ok;
    if (form == DPT_IDENTITY_STRIDE) {
        span_ok = plan.span == 0;
        if (body > 0) units = (body / 16 + IDENTITY_THREADS - 1) / IDENTITY_THREADS;
    } else {
        span_ok = plan.span >= 0 && plan.span % 16 == 0 && (body > 0) == (plan.span > 0);
        if (body > 0 && plan.span > 0) units = (body + plan.span - 1) / plan.span;
    }
    if (plan.form != form || plan.head != head || plan.body != body || !span_ok ||
        plan.blocks < 1 || plan.blocks > units || plan.blocks > (int64_t(1) << 31) - 1 ||
        plan.threads != IDENTITY_THREADS) {
        return (int)cudaErrorInvalidConfiguration;
    }
    if (n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned blocks = (unsigned)plan.blocks;
    if (form == DPT_IDENTITY_STRIDE) {
        identity_stride_kernel<<<blocks, IDENTITY_THREADS, 0, st>>>(in, out, n, head, body);
    } else {
        identity_shifted_kernel<<<blocks, IDENTITY_THREADS, 0, st>>>(in, out, n, head, body,
                                                                    plan.span);
    }
    return (int)cudaGetLastError();
}
