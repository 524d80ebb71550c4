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
// byte by byte (block 0). The body is cut into spans of `span` bytes on
// 16-byte boundaries, dealt to a persistent grid of a few blocks an SM:
// block b streams spans b, b + G, b + 2G, ... (G blocks). On an H100 one
// long span a block ran slower than short spans dealt in turn, which keep
// the whole grid in a narrow window of memory (PERF.md, the identity's
// findings). Two forms move a span:
//
// * bulk (in and out agree mod 16): a ring of `stages` stages of one span
//   each in dynamic shared memory. One thread starts the Tensor Memory
//   Accelerator's bulk copy (cp.async.bulk) of each span into its stage,
//   whose mbarrier counts the bytes in, then the bulk copy of the stage back
//   out (a bulk group) and refills the stage of the span before once that
//   group has read it (wait_group.read 1), so stages - 1 loads and two
//   stores stay in flight. Both directions carry an L2 evict-first hint:
//   the stream is many times the 50 MB L2 and is read once. No thread holds
//   the data in registers.
// * shifted (in and out disagree mod 16): out's words stay aligned, and
//   each is built from the two aligned input words that hold its bytes, by
//   a funnel shift that is the same for the whole copy. A simple path: held
//   bitwise, timed, not tuned.

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

constexpr int BULK_THREADS = 32;  // lane 0 drives the ring; the warp copies the head and tail
constexpr int SHIFTED_THREADS = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Head and tail: bytes [0, head) and [head + body, n), by block 0.
__device__ __forceinline__ void copy_ends(const uint8_t* __restrict__ in,
                                          uint8_t* __restrict__ out, int64_t n,
                                          int64_t head, int64_t body) {
    if (blockIdx.x != 0) return;
    for (int64_t i = threadIdx.x; i < head; i += blockDim.x) out[i] = in[i];
    for (int64_t i = head + body + threadIdx.x; i < n; i += blockDim.x) out[i] = in[i];
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

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

__global__ void __launch_bounds__(BULK_THREADS)
identity_bulk_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                     int64_t n, int64_t head, int64_t body, int64_t span, int stages) {
    extern __shared__ __align__(128) uint8_t ring[];  // stages x span, then the barriers
    copy_ends(in, out, n, head, body);
    const Spans sp(body, span);
    if (threadIdx.x != 0 || sp.count == 0) return;
    const uint8_t* src = in + head;
    uint8_t* dst = out + head;
    const uint32_t ring0 = smem_u32(ring);
    const uint32_t bar0 = ring0 + (uint32_t)(stages * span);  // 8 bytes a stage
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
    for (int st = 0; st < stages; ++st) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * st) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

    auto stage_of = [&](int64_t k) { return ring0 + (uint32_t)((k % stages) * span); };
    auto bytes_of = [&](int64_t k) { return (uint32_t)(sp.end(k) - sp.start(k)); };
    auto load = [&](int64_t k) {  // span k into its stage k % stages
        const uint32_t bar = bar0 + 8 * (uint32_t)(k % stages);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     ::"r"(bar), "r"(bytes_of(k)) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
            " [%0], [%1], %2, [%3], %4;"
            ::"r"(stage_of(k)), "l"(src + sp.start(k)), "r"(bytes_of(k)), "r"(bar),
              "l"(policy)
            : "memory");
    };
    for (int64_t k = 0; k < sp.count && k < stages; ++k) load(k);
    for (int64_t k = 0; k < sp.count; ++k) {
        wait_parity(bar0 + 8 * (uint32_t)(k % stages), (uint32_t)((k / stages) & 1));
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;"
            ::"l"(dst + sp.start(k)), "r"(stage_of(k)), "r"(bytes_of(k)), "l"(policy)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        // The store of span k - 1 has read its stage: refill it.
        if (k >= 1 && k - 1 + stages < sp.count) {
            asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
            load(k - 1 + stages);
        }
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The 16 bytes that start 4*W4 + sh/8 bytes into the 32 bytes (a, b).
template <int W4>
__device__ __forceinline__ uint4 funnel16(const uint4& a, const uint4& b, int sh) {
    const uint32_t u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    return make_uint4(__funnelshift_r(u[W4], u[W4 + 1], sh),
                      __funnelshift_r(u[W4 + 1], u[W4 + 2], sh),
                      __funnelshift_r(u[W4 + 2], u[W4 + 3], sh),
                      __funnelshift_r(u[W4 + 3], u[W4 + 4], sh));
}

__global__ void __launch_bounds__(SHIFTED_THREADS)
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
        for (int64_t w = threadIdx.x; w < words; w += SHIFTED_THREADS) {
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
    const int form = in16 == out16 ? DPT_IDENTITY_BULK : DPT_IDENTITY_SHIFTED;
    // Spans of the body, and at most one block a span (one block without a
    // body: it copies the head and tail).
    const int64_t spans = body > 0 && plan.span > 0 ? (body + plan.span - 1) / plan.span : 1;
    const int threads = form == DPT_IDENTITY_BULK ? BULK_THREADS : SHIFTED_THREADS;
    const bool ring_ok = form == DPT_IDENTITY_BULK
                             ? plan.stages >= 2 && plan.stages <= 32 &&
                                   plan.smem_bytes == plan.stages * (plan.span + 8) &&
                                   plan.smem_bytes <= DPT_SMEM_BYTES
                             : plan.stages == 0 && plan.smem_bytes == 0;
    if (plan.form != form || plan.head != head || plan.body != body || plan.span % 16 ||
        plan.span < 0 || (body > 0) != (plan.span > 0) || plan.blocks < 1 ||
        plan.blocks > spans || plan.blocks > (int64_t(1) << 31) - 1 ||
        plan.threads != threads || !ring_ok) {
        return (int)cudaErrorInvalidConfiguration;
    }
    if (n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned blocks = (unsigned)plan.blocks;
    if (form == DPT_IDENTITY_BULK) {
        const cudaError_t rc = cudaFuncSetAttribute(
            identity_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
        if (rc != cudaSuccess) return (int)rc;
        identity_bulk_kernel<<<blocks, threads, plan.smem_bytes, st>>>(
            in, out, n, head, body, plan.span, plan.stages);
    } else {
        identity_shifted_kernel<<<blocks, threads, 0, st>>>(in, out, n, head, body, plan.span);
    }
    return (int)cudaGetLastError();
}
