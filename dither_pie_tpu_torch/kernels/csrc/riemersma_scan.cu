// R1: Riemersma error diffusion along the Hilbert curve, a block of two
// warps a frame: a chain warp and a producer warp.
//
// Replaces no Pallas kernel: it replaces the `jax.lax.scan` over the curve
// in `_scan_fn` of dither_pie_tpu/ops/riemersma_scan.py:134 (its step
// `one()`, :102-121), which the JAX package runs on the device under
// DITHER_PIE_TPU_RIEMERSMA=scan. A scan of 2,073,600 steps a 1080p frame is
// too long for a loop of PyTorch calls (minutes), so on the hot path it is
// this kernel, and ops/riemersma_scan.py holds the loop as its plain
// version.
//
// What it computes: (B, H, W, 3) uint8 or float32 frames and a (P, 3)
// float32 palette -> (B, H, W, 3) uint8 colours, each frame bit for bit the
// host engine's ed_riemersma_f32 (native/ed_scan.cpp) for P <= 4096. The
// curve comes as `order` (N,) int32, the linear pixel index of each valid
// curve step, and `mask` (N,) uint8, bit k set where raw slot k + 1 after
// the step is a valid receiver; the d-th set bit k feeds the working value
// d steps ahead with FS weight k (ops/riemersma_scan.py, receiver_masks).
// The bit contract: __fsub_rn / __fmul_rn / __fadd_rn (never contracted
// into an FMA, and the build adds --fmad=false), (dr*dr + dg*dg) + db*db,
// the first strict minimum by palette index, no clamp before the search,
// each receiver clamped at once, fminf(fmaxf(q + e*w, 0), 255), and only a
// receiver with a weight changes.
//
// What bounds it: the chain. Step i + 1 searches the value step i's error
// just reached, so a frame is N dependent steps, each as long as its
// dependent path: a lane's distance, the warp's minimum (REDUX), the lane
// that holds it (VOTE, FLO) and the shuffle of its next value, 121 cycles at
// the latencies riemersma_latency_kernel measures (PERF.md, R1's row). A
// warp issues in order, so an instruction of the step that is not on that
// path still takes an issue slot, and one that waits stalls the ones after
// it. Bytes and operations are far below the chain. Only B chain warps run,
// one on each of B SMs up to 132 frames (two an SM at 264), so the
// throughput grows with the frames a launch.
//
// Design:
// * warp specialisation. Warp 0 runs the chain; warp 1, the producer,
//   issues from another scheduler sub-partition, so its work never takes
//   the chain's issue slot. The producer loads a chunk's orders and masks,
//   decodes each mask into the four receivers' weights, gathers the pixels
//   through the orders, and stores the chunk as records into a ring of
//   R1_SLOTS chunks in shared memory; it writes the chosen colours of a
//   chunk to `out` once the chain has released its slot. The handoff is a
//   "full" and an "empty" mbarrier a slot (32 arrivals each, arrive and
//   try_wait.parity), waited on once a chunk: the chain's step loop has no
//   device-memory access and no block-wide barrier.
// * a record a step: the step's weights (float4, 0 for no receiver) and
//   the pixel that enters the ring after the step, that of step t + 5
//   (float4), two 16-byte loads at constant offsets from the slot's base.
//   The pixels of steps 0..4 come in a head of five records.
// * every chain lane keeps the 5-deep ring of working values and applies
//   the receives itself, so the reductions are the only work that crosses
//   lanes. The step loop is unrolled by 5, so the ring rotates by register
//   renaming. A chunk is R1_CHUNK steps, a multiple of 5; the chain runs
//   whole chunks, the steps past the curve on zero records (never written
//   out).
// * the search. Colour c lies in lane 31 - (c mod 32). P <= 32: a colour
//   a lane in registers; P <= 256 and P <= 512: 8 and 16 colours
//   31 - l + 32 j a lane in registers, their minimum by a tree of strict
//   compares over index-ordered halves; above: from shared memory in four
//   independent running minima merged by (distance, index). The palette's
//   planes are padded with +inf as far as the form reads (whole passes of
//   128 colours in shared memory), so no search checks a bound. Then one
//   __reduce_min_sync over the distance bits (REDUX runs one at a time: the
//   step has one), a ballot of the lanes at the minimum and its highest
//   lane (FLO, no bit reversal), which holds the lowest index (a tie of
//   lanes above 32 colours takes a second reduction over their indices).
//   While the reduction runs, every lane computes the step's four receives
//   as if its colour won, from its own error (dist2's __fsub_rn(r0, p) is
//   bit for bit the error's __fsub_rn(r0, cr)); the winner's twelve values
//   come by shuffles, the next step's first.
// * uint8 frames: every working value stays in [0, 255], so a receive with
//   weight 0 leaves it as it is (clamp(q + e * 0) == q) and the w > 0
//   select goes; float32 frames (values outside [0, 255] until a receive
//   clamps them) keep it.
//
// riemersma_latency_kernel (tools/riemersma_ab.py --latency, chip_smoke.py
// phase 23) measures with clock64 the latency of each kind of instruction
// on that dependent path, for its bound.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "launchers.h"

namespace {

constexpr int R1_CHUNK = 160;                 // curve steps a chunk, a multiple of 5
constexpr int R1_PER_LANE = R1_CHUNK / 32;    // steps the producer's lanes stage each
constexpr int R1_SLOTS = 4;                   // chunks in the ring
constexpr int R1_REG_COLOURS = 16;            // most colours a lane in registers, P <= 512
constexpr int R1_PAL_ALIGN = 128;             // Search<0>'s palette: whole passes
constexpr unsigned R1_FULL = 0xffffffffu;
static_assert(R1_CHUNK % 5 == 0 && R1_CHUNK % 32 == 0, "a chunk is whole rings and lanes");

// Shared memory, in this order: the 2 * R1_SLOTS barriers, the head's five
// records, then a slot after another (R1_CHUNK records of 32 bytes, the
// orders, the chosen indices), then the palette's three float planes of Pp
// colours each.
constexpr int R1_BAR_BYTES = 2 * R1_SLOTS * 8;
constexpr int R1_HEAD_BYTES = 5 * 16;
constexpr int R1_SLOT_BYTES = R1_CHUNK * 32 + R1_CHUNK * 4 + R1_CHUNK * 4;
constexpr int R1_RING_BYTES = R1_BAR_BYTES + R1_HEAD_BYTES + R1_SLOTS * R1_SLOT_BYTES;
static_assert(R1_RING_BYTES % 16 == 0, "the palette starts on 16 bytes");

// The search form by palette size: colours a lane in registers (1, 8,
// R1_REG_COLOURS), or 0 for the shared-memory search.
__host__ __device__ constexpr int colours_a_lane(int P) {
    return P <= 32 ? 1 : (P <= 256 ? 8 : (P <= 32 * R1_REG_COLOURS ? R1_REG_COLOURS : 0));
}

// The palette's planes: as far as the search form reads, +inf past P.
__host__ __device__ constexpr int pal_padded(int P) {
    return colours_a_lane(P) > 0 ? 32 * colours_a_lane(P)
                                 : (P + R1_PAL_ALIGN - 1) / R1_PAL_ALIGN * R1_PAL_ALIGN;
}

// The Floyd-Steinberg weight of raw offset k + 1 (7, 1, 5, 3) / 16, exact.
__device__ __forceinline__ float fs_weight(int k) {
    return k == 0 ? 0.4375f : (k == 1 ? 0.0625f : (k == 2 ? 0.3125f : 0.1875f));
}

__device__ __forceinline__ float dist2(float dr, float dg, float db) {
    return __fadd_rn(__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dg, dg)), __fmul_rn(db, db));
}

template <bool SELECT>
__device__ __forceinline__ float receive(float q, float e, float w) {
    const float v = fminf(fmaxf(__fadd_rn(q, __fmul_rn(e, w)), 0.0f), 255.0f);
    return SELECT ? (w > 0.0f ? v : q) : v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
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

// Colour c lies in lane 31 - (c mod 32): the lowest palette index of a set
// of lanes is then the highest lane, which FLO (bfind) finds in a ballot
// with no bit reversal.
__device__ __forceinline__ int lane_of(int c) { return 31 - (c & 31); }

__device__ __forceinline__ int highest_lane(unsigned ballot) {
    int r;
    asm("bfind.u32 %0, %1;" : "=r"(r) : "r"(ballot));
    return r;
}

// A lane's nearest colour of its own: the distance's bits (a non-negative
// float orders as its unsigned bits), its palette index, and the error
// (dr, dg, db) = (r0, g0, b0) - that colour. The palette's planes run to
// Pp = pal_padded(P), as far as the form reads, +inf past P (never strictly
// nearer). NPL = 1: colour 31 - lane in registers; NPL = 8 or 16: colours
// 31 - lane + 32 j, j < NPL, in registers; NPL = 0: colours 31 - lane +
// 32 j < Pp from shared memory. A lane's colours are in index order, and
// each merge keeps the lower index at equal distances: the lane keeps its
// first strict minimum.
template <int NPL>
struct Search;  // NPL >= 2, below

template <>
struct Search<1> {
    float pr, pg, pb;
    __device__ void load(const float* s_r, const float* s_g, const float* s_b, int lane) {
        pr = s_r[lane_of(lane)];
        pg = s_g[lane_of(lane)];
        pb = s_b[lane_of(lane)];
    }
    __device__ __forceinline__ void lane_best(float r0, float g0, float b0, const float*,
                                              const float*, const float*, int, int lane,
                                              unsigned& key, unsigned& bi, float& dr, float& dg,
                                              float& db) const {
        dr = __fsub_rn(r0, pr);
        dg = __fsub_rn(g0, pg);
        db = __fsub_rn(b0, pb);
        key = __float_as_uint(dist2(dr, dg, db));
        bi = (unsigned)lane_of(lane);
    }
};

template <int NPL>
struct Search {
    static_assert((NPL & (NPL - 1)) == 0, "a tree over halves");
    float pr[NPL], pg[NPL], pb[NPL];
    __device__ void load(const float* s_r, const float* s_g, const float* s_b, int lane) {
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
            const int c = lane_of(lane) + 32 * j;
            pr[j] = s_r[c];
            pg[j] = s_g[c];
            pb[j] = s_b[c];
        }
    }
    __device__ __forceinline__ void lane_best(float r0, float g0, float b0, const float* s_r,
                                              const float* s_g, const float* s_b, int, int lane,
                                              unsigned& key, unsigned& bi, float& dr, float& dg,
                                              float& db) const {
        float d[NPL];
        int j_of[NPL];
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
            d[j] = dist2(__fsub_rn(r0, pr[j]), __fsub_rn(g0, pg[j]), __fsub_rn(b0, pb[j]));
            j_of[j] = j;
        }
        // A tree over index-ordered halves: the upper half wins only
        // strictly.
#pragma unroll
        for (int span = 1; span < NPL; span *= 2) {
#pragma unroll
            for (int j = 0; j < NPL; j += 2 * span) {
                const bool up = d[j + span] < d[j];
                d[j] = up ? d[j + span] : d[j];
                j_of[j] = up ? j_of[j + span] : j_of[j];
            }
        }
        key = __float_as_uint(d[0]);
        bi = (unsigned)(lane_of(lane) + 32 * j_of[0]);
        dr = __fsub_rn(r0, s_r[bi]);
        dg = __fsub_rn(g0, s_g[bi]);
        db = __fsub_rn(b0, s_b[bi]);
    }
};

template <>
struct Search<0> {
    __device__ void load(const float*, const float*, const float*, int) {}
    __device__ __forceinline__ void lane_best(float r0, float g0, float b0, const float* s_r,
                                              const float* s_g, const float* s_b, int Pp,
                                              int lane, unsigned& key, unsigned& bi, float& dr,
                                              float& dg, float& db) const {
        // P > 512: four running minima, a over colours c0 + 32 a + 128 i,
        // their 12 loads issued together each pass; merged by (distance,
        // index).
        const int c0 = lane_of(lane);
        float best[4];
        int ib[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int c = c0 + 32 * a;
            best[a] = dist2(__fsub_rn(r0, s_r[c]), __fsub_rn(g0, s_g[c]), __fsub_rn(b0, s_b[c]));
            ib[a] = c;
        }
        for (int base = 128; base < Pp; base += 128) {
            float pr[4], pg[4], pb[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int c = base + c0 + 32 * a;
                pr[a] = s_r[c];
                pg[a] = s_g[c];
                pb[a] = s_b[c];
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const float d =
                    dist2(__fsub_rn(r0, pr[a]), __fsub_rn(g0, pg[a]), __fsub_rn(b0, pb[a]));
                const bool take = d < best[a];
                best[a] = take ? d : best[a];
                ib[a] = take ? base + c0 + 32 * a : ib[a];
            }
        }
#pragma unroll
        for (int span = 1; span < 4; span *= 2) {
#pragma unroll
            for (int a = 0; a < 4; a += 2 * span) {
                const bool up = best[a + span] < best[a] ||
                                (best[a + span] == best[a] && ib[a + span] < ib[a]);
                best[a] = up ? best[a + span] : best[a];
                ib[a] = up ? ib[a + span] : ib[a];
            }
        }
        key = __float_as_uint(best[0]);
        bi = (unsigned)ib[0];
        dr = __fsub_rn(r0, s_r[bi]);
        dg = __fsub_rn(g0, s_g[bi]);
        db = __fsub_rn(b0, s_b[bi]);
    }
};

// The warp's pick from every lane's best (key, bi): the first strict
// minimum over the palette, the lowest index at equal distances. One
// __reduce_min_sync finds the minimum (REDUX runs one at a time, so the
// step has one); a ballot of the lanes at it and its highest lane (the
// lowest index when P <= 32, and whenever one lane holds the minimum) name
// the winner. Lanes with several colours that tie take a second reduction
// over their indices. Returns the winning lane; `idx` its index.
template <bool ONE_COLOUR>
__device__ __forceinline__ int warp_pick(unsigned key, unsigned bi, unsigned& idx) {
    const unsigned m = __reduce_min_sync(R1_FULL, key);
    const bool eq = key == m;
    const unsigned at_min = __ballot_sync(R1_FULL, eq);
    int src = highest_lane(at_min);
    if (!ONE_COLOUR && (at_min & (at_min - 1))) {
        src = lane_of((int)__reduce_min_sync(R1_FULL, eq ? bi : R1_FULL));
    }
    idx = ONE_COLOUR ? (unsigned)lane_of(src) : __shfl_sync(R1_FULL, bi, src);
    return src;
}

// The chain warp: every chunk's steps, slot by slot. While the reduction
// runs, every lane computes the step's four receives as if its colour won
// (each from its own error); the winner's twelve values then come by
// shuffles, the next step's first. So between one step's pick and the next
// step's reduction the warp issues only the distance.
template <bool SELECT, int NPL>
__device__ __forceinline__ void run_chain(unsigned char* smem, const float* s_r,
                                          const float* s_g, const float* s_b, int Pp,
                                          int n_chunks, int lane) {
    const uint32_t bars = smem_u32(smem);
    const float4* head = reinterpret_cast<const float4*>(smem + R1_BAR_BYTES);
    unsigned char* slots = smem + R1_BAR_BYTES + R1_HEAD_BYTES;

    Search<NPL> search;
    search.load(s_r, s_g, s_b, lane);

    // The ring: working values of steps i .. i + 4; ring[k] is step i's
    // when i = k mod 5, as the unrolled step names it.
    float rr[5], rg[5], rb[5];
    bar_wait(bars, 0);  // chunk 0 and the head
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        const float4 v = head[k];
        rr[k] = v.x;
        rg[k] = v.y;
        rb[k] = v.z;
    }
    for (int c = 0; c < n_chunks; ++c) {
        const int slot = c % R1_SLOTS;
        if (c > 0) bar_wait(bars + 8 * slot, (uint32_t)(c / R1_SLOTS) & 1u);
        const float4* rec = reinterpret_cast<const float4*>(slots + slot * R1_SLOT_BYTES);
        int* s_idx = reinterpret_cast<int*>(slots + slot * R1_SLOT_BYTES + R1_CHUNK * 36);
#pragma unroll 2
        for (int g = 0; g < R1_CHUNK; g += 5) {
#pragma unroll
            for (int k = 0; k < 5; ++k) {
                const int t = g + k;
                const float4 wv = rec[2 * t];
                const float4 fv = rec[2 * t + 1];
                const float w[4] = {wv.x, wv.y, wv.z, wv.w};
                unsigned key, bi;
                float dr, dg, db;
                search.lane_best(rr[k], rg[k], rb[k], s_r, s_g, s_b, Pp, lane, key, bi, dr, dg,
                                 db);
                float cr[4], cg[4], cb[4];
#pragma unroll
                for (int d = 0; d < 4; ++d) {
                    const int q = (k + 1 + d) % 5;
                    cr[d] = receive<SELECT>(rr[q], dr, w[d]);
                    cg[d] = receive<SELECT>(rg[q], dg, w[d]);
                    cb[d] = receive<SELECT>(rb[q], db, w[d]);
                }
                unsigned idx;
                const int src = warp_pick<NPL == 1>(key, bi, idx);
#pragma unroll
                for (int d = 0; d < 4; ++d) {
                    const int q = (k + 1 + d) % 5;
                    rr[q] = __shfl_sync(R1_FULL, cr[d], src);
                    rg[q] = __shfl_sync(R1_FULL, cg[d], src);
                    rb[q] = __shfl_sync(R1_FULL, cb[d], src);
                }
                if (lane == 0) s_idx[t] = (int)idx;
                rr[k] = fv.x;
                rg[k] = fv.y;
                rb[k] = fv.z;
            }
        }
        bar_arrive(bars + 8 * (R1_SLOTS + slot));
    }
}

// The producer warp: fills slot c % R1_SLOTS with chunk c once the chain
// has released it, after writing out the chunk that held it before.
template <typename TI>
__device__ __forceinline__ void run_producer(unsigned char* smem, const float* s_r,
                                             const float* s_g, const float* s_b,
                                             const TI* __restrict__ frame,
                                             const int32_t* __restrict__ order,
                                             const uint8_t* __restrict__ mask, int N,
                                             int n_chunks, uint8_t* __restrict__ fout,
                                             int lane) {
    const uint32_t bars = smem_u32(smem);
    float4* head = reinterpret_cast<float4*>(smem + R1_BAR_BYTES);
    unsigned char* slots = smem + R1_BAR_BYTES + R1_HEAD_BYTES;

    auto pixel = [&](int pos) {
        const int o = pos < N ? order[pos] : -1;
        if (o < 0) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const TI* p = frame + 3 * (int64_t)o;
        return make_float4(static_cast<float>(p[0]), static_cast<float>(p[1]),
                           static_cast<float>(p[2]), 0.0f);
    };

    if (lane < 5) head[lane] = pixel(lane);
    for (int c = 0; c < n_chunks + R1_SLOTS; ++c) {
        const int slot = c % R1_SLOTS;
        unsigned char* base = slots + slot * R1_SLOT_BYTES;
        float4* rec = reinterpret_cast<float4*>(base);
        int* s_ord = reinterpret_cast<int*>(base + R1_CHUNK * 32);
        const int* s_idx = reinterpret_cast<const int*>(base + R1_CHUNK * 36);
        // The first R1_SLOTS waits pass: every slot starts empty.
        bar_wait(bars + 8 * (R1_SLOTS + slot), ((uint32_t)(c / R1_SLOTS) & 1u) ^ 1u);
        if (c >= R1_SLOTS) {
#pragma unroll
            for (int j = 0; j < R1_PER_LANE; ++j) {
                const int t = lane + 32 * j;
                if ((c - R1_SLOTS) * R1_CHUNK + t < N) {
                    const int id = s_idx[t];
                    uint8_t* q = fout + 3 * (int64_t)s_ord[t];
                    q[0] = (uint8_t)(int)s_r[id];
                    q[1] = (uint8_t)(int)s_g[id];
                    q[2] = (uint8_t)(int)s_b[id];
                }
            }
        }
        if (c >= n_chunks) continue;
#pragma unroll
        for (int j = 0; j < R1_PER_LANE; ++j) {
            const int t = lane + 32 * j;
            const int pos = c * R1_CHUNK + t;
            const bool in = pos < N;
            s_ord[t] = in ? order[pos] : -1;
            unsigned bits = in ? mask[pos] : 0u;
            float w[4];
#pragma unroll
            for (int d = 0; d < 4; ++d) {
                w[d] = bits ? fs_weight(__ffs(bits) - 1) : 0.0f;
                bits &= bits - 1;
            }
            rec[2 * t] = make_float4(w[0], w[1], w[2], w[3]);
            rec[2 * t + 1] = pixel(pos + 5);
        }
        bar_arrive(bars + 8 * slot);
    }
}

// NPL: colours a lane in registers (1, 8, R1_REG_COLOURS), or 0 for
// shared memory. Warp 0 the chain, warp 1 the producer.
template <typename TI, int NPL>
__global__ void __launch_bounds__(64)
riemersma_kernel(const TI* __restrict__ frames, const float* __restrict__ pal, int P,
                 const int32_t* __restrict__ order, const uint8_t* __restrict__ mask, int N,
                 int64_t frame_elems, uint8_t* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int Pp = pal_padded(P);
    float* s_r = reinterpret_cast<float*>(smem + R1_RING_BYTES);
    float* s_g = s_r + Pp;
    float* s_b = s_g + Pp;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    const float inf = __int_as_float(0x7f800000);
    for (int c = threadIdx.x; c < Pp; c += 64) {
        s_r[c] = c < P ? pal[3 * c] : inf;
        s_g[c] = c < P ? pal[3 * c + 1] : inf;
        s_b[c] = c < P ? pal[3 * c + 2] : inf;
    }
    if (threadIdx.x == 0) {
        const uint32_t bars = smem_u32(smem);
        for (int s = 0; s < 2 * R1_SLOTS; ++s) bar_init(bars + 8 * s, 32);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();  // the palette and the barriers, once; the roles part here

    // uint8 frames keep every working value in [0, 255]: no select.
    constexpr bool kSelect = !std::is_same<TI, uint8_t>::value;
    const int n_chunks = (N + R1_CHUNK - 1) / R1_CHUNK;
    if (warp == 0) {
        run_chain<kSelect, NPL>(smem, s_r, s_g, s_b, Pp, n_chunks, lane);
    } else {
        run_producer<TI>(smem, s_r, s_g, s_b, frames + blockIdx.x * frame_elems, order, mask,
                         N, n_chunks, out + blockIdx.x * frame_elems, lane);
    }
}

template <typename TI, int NPL>
int launch(const TI* frames, const float* pal, int P, const int32_t* order,
           const uint8_t* mask, int N, int B, int64_t frame_elems, uint8_t* out,
           cudaStream_t stream) {
    const int smem = dpt_riemersma_smem_bytes(P);
    if (smem > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            riemersma_kernel<TI, NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    riemersma_kernel<TI, NPL><<<B, 64, smem, stream>>>(frames, pal, P, order, mask, N,
                                                       frame_elems, out);
    return (int)cudaGetLastError();
}

template <typename TI>
int launch_for(const TI* frames, const float* pal, int P, const int32_t* order,
               const uint8_t* mask, int N, int B, int64_t elems, uint8_t* out,
               cudaStream_t s) {
    switch (colours_a_lane(P)) {
        case 1: return launch<TI, 1>(frames, pal, P, order, mask, N, B, elems, out, s);
        case 8: return launch<TI, 8>(frames, pal, P, order, mask, N, B, elems, out, s);
        case R1_REG_COLOURS:
            return launch<TI, R1_REG_COLOURS>(frames, pal, P, order, mask, N, B, elems, out, s);
        default: return launch<TI, 0>(frames, pal, P, order, mask, N, B, elems, out, s);
    }
}

// ---------------------------------------------------------------------------
// The latency probe: one warp, chains of R1_LAT_UNROLL dependent
// instructions of one kind, timed by clock64, `iters` times each.
// out[k] = cycles of chain k over all its instructions (k < 6); out[6] =
// the probe's clock64 cycles and out[7] its %globaltimer nanoseconds,
// which give the SM clock under load; out[9] the instructions a chain.
// ---------------------------------------------------------------------------

constexpr int R1_LAT_UNROLL = 64;

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__global__ void __launch_bounds__(32)
riemersma_latency_kernel(float seed, int iters, long long* out) {
    __shared__ int s_chase[32];
    const int lane = threadIdx.x;
    s_chase[lane] = lane;
    __syncwarp();
    const uint64_t ns0 = global_ns();
    const long long c_all = clock64();
    long long t0, t1;
    float f = seed + (float)lane;
    unsigned u = (unsigned)lane + 7u;
    int v = lane;
    float q = seed;
    const float e = seed * 0.25f, w = 0.4375f;

    // 0: FADD
    t0 = clock64();
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < R1_LAT_UNROLL; ++k) asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(f) : "f"(seed));
    }
    t1 = clock64();
    if (lane == 0) out[0] = t1 - t0;
    // 1: the receive's FADD, FMNMX, FMNMX
    t0 = clock64();
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < R1_LAT_UNROLL; ++k) {
            asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(q) : "f"(e * w));
            asm volatile("max.f32 %0, %0, 0f00000000;" : "+f"(q));
            asm volatile("min.f32 %0, %0, 0f437F0000;" : "+f"(q));
        }
    }
    t1 = clock64();
    if (lane == 0) out[1] = t1 - t0;
    // 2: REDUX.MIN
    t0 = clock64();
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < R1_LAT_UNROLL; ++k) {
            asm volatile("redux.sync.min.u32 %0, %0, 0xffffffff;" : "+r"(u));
        }
    }
    t1 = clock64();
    if (lane == 0) out[2] = t1 - t0;
    // 3: ISETP, VOTE and FLO, the highest lane of a ballot (the pick)
    t0 = clock64();
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < R1_LAT_UNROLL; ++k) {
            v = highest_lane(__ballot_sync(R1_FULL, lane <= v));
            asm volatile("" : "+r"(v));
        }
    }
    t1 = clock64();
    if (lane == 0) out[3] = t1 - t0;
    // 4: SHFL.IDX
    int s = lane;
    t0 = clock64();
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < R1_LAT_UNROLL; ++k) {
            asm volatile("shfl.sync.idx.b32 %0, %0, %0, 0x1f, 0xffffffff;" : "+r"(s));
        }
    }
    t1 = clock64();
    if (lane == 0) out[4] = t1 - t0;
    // 5: LDS, a pointer chase through shared memory
    int p = lane;
    t0 = clock64();
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < R1_LAT_UNROLL; ++k) {
            p = s_chase[p];
            asm volatile("" : "+r"(p));
        }
    }
    t1 = clock64();
    if (lane == 0) out[5] = t1 - t0;
    const long long c_end = clock64();
    const uint64_t ns1 = global_ns();
    const unsigned sink =
        __float_as_uint(f) ^ __float_as_uint(q) ^ u ^ (unsigned)v ^ (unsigned)s ^ (unsigned)p;
    if (lane == 0) {
        out[6] = c_end - c_all;
        out[7] = (long long)(ns1 - ns0);
        out[8] = (long long)sink;  // keeps every chain live
        out[9] = (long long)iters * R1_LAT_UNROLL;
    }
}

}  // namespace

int dpt_riemersma_smem_bytes(int P) {
    // The ring (barriers, head, slots) and the palette's three planes.
    return R1_RING_BYTES + 3 * pal_padded(P) * 4;
}

int dpt_riemersma_scan(const void* frames, int frames_is_f32, const float* pal, int P,
                       const int32_t* order, const uint8_t* mask, int N, int B, int64_t hw,
                       uint8_t* out, void* stream) {
    if (P < 1 || P > DPT_RIEMERSMA_MAX_PALETTE || N < 1 || N > hw || B < 0) {
        return (int)cudaErrorInvalidValue;
    }
    if (B == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t elems = 3 * hw;
    if (frames_is_f32) {
        return launch_for(static_cast<const float*>(frames), pal, P, order, mask, N, B, elems,
                          out, s);
    }
    return launch_for(static_cast<const uint8_t*>(frames), pal, P, order, mask, N, B, elems, out,
                      s);
}

int dpt_riemersma_latency(int iters, long long* out, void* stream) {
    if (iters < 1) return (int)cudaErrorInvalidValue;
    riemersma_latency_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(1.0f, iters, out);
    return (int)cudaGetLastError();
}
