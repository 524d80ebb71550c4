// R1: Riemersma error diffusion along the Hilbert curve, one warp a frame.
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
// critical path: the distances of a lane's colours, the warp's pick of the
// nearest, the chosen colour, the error and one clamped receive. A warp
// issues in order, so every instruction of the step that waits stalls the
// ones after it: the step's own loads go first. Bytes and operations are
// far below the chain (PERF.md, R1's row).
// Only B warps run, one on each of B SMs (of 132) up to 132 frames, so the
// throughput grows with the frames a launch until the SMs fill.
//
// Design, simple and right first:
// * a warp a frame (a block of 32 threads); the palette in dynamic shared
//   memory as three float planes (12 bytes a colour; 192 KB at 16384
//   colours, above 48 KB by cudaFuncSetAttribute). Lane l searches colours
//   l, l + 32, ...; with P <= 32 its one colour sits in registers. The
//   lane's first strict minimum goes into __reduce_min_sync over the
//   distance's bits (a non-negative float orders as its unsigned bits),
//   then over the indices of the lanes that hold that minimum: the lowest
//   palette index among equal distances wins, as in the engine. With P <=
//   32 colour i is lane i's, so the lowest lane of a ballot of the minimum
//   is the pick and its colour comes by shuffles.
// * every lane keeps the 5-deep ring of working values and applies the
//   receives itself, so the reductions are the only step that crosses
//   lanes.
// * no device-memory load on the chain: the curve is staged through a ring
//   of 3 chunks of R1_CHUNK steps in shared memory. While a chunk runs, the
//   lanes hold in registers the pixels of the chunk two ahead (gathered
//   through the orders staged before) and the orders and masks of the chunk
//   three ahead; they are stored after the chunk (each mask decoded into
//   the four receivers' weights, 0 for none), so each load has a whole
//   chunk (~256 steps) to arrive. A step reads its weights and the pixel
//   that enters the ring from shared memory before its search, and receives
//   by selects, without branches. The chosen indices of a chunk are kept in
//   shared memory and written out as colours by all lanes after it.

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

constexpr int R1_CHUNK = 256;                // curve steps a staged chunk
constexpr int R1_PER_LANE = R1_CHUNK / 32;   // steps each lane stages a chunk
constexpr int R1_SLOTS = 3;                  // chunks in the ring
constexpr unsigned R1_FULL = 0xffffffffu;

// The Floyd-Steinberg weight of raw offset k + 1 (7, 1, 5, 3) / 16, exact.
__device__ __forceinline__ float fs_weight(int k) {
    return k == 0 ? 0.4375f : (k == 1 ? 0.0625f : (k == 2 ? 0.3125f : 0.1875f));
}

__device__ __forceinline__ float dist2(float r, float g, float b, float pr, float pg,
                                       float pb) {
    const float dr = __fsub_rn(r, pr);
    const float dg = __fsub_rn(g, pg);
    const float db = __fsub_rn(b, pb);
    return __fadd_rn(__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dg, dg)), __fmul_rn(db, db));
}

__device__ __forceinline__ float receive(float q, float e, float w) {
    return fminf(fmaxf(__fadd_rn(q, __fmul_rn(e, w)), 0.0f), 255.0f);
}

// REG_PAL: P <= 32, each lane's one colour in registers.
template <typename TI, bool REG_PAL>
__global__ void __launch_bounds__(32)
riemersma_kernel(const TI* __restrict__ frames, const float* __restrict__ pal, int P,
                 const int32_t* __restrict__ order, const uint8_t* __restrict__ mask, int N,
                 int64_t frame_elems, uint8_t* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* s_px = reinterpret_cast<float*>(smem);          // [slot][step][3]
    int* s_ord = reinterpret_cast<int*>(s_px + R1_SLOTS * R1_CHUNK * 3);  // [slot][step]
    int* s_idx = s_ord + R1_SLOTS * R1_CHUNK;                // [step] of the running chunk
    float* s_r = reinterpret_cast<float*>(s_idx + R1_CHUNK);
    float* s_g = s_r + P;
    float* s_b = s_g + P;
    float4* s_w = reinterpret_cast<float4*>(s_b + P + ((4 - (3 * P) % 4) % 4));  // [slot][step]

    const int lane = threadIdx.x;
    const TI* frame = frames + blockIdx.x * frame_elems;
    uint8_t* fout = out + blockIdx.x * frame_elems;

    for (int c = lane; c < P; c += 32) {
        s_r[c] = pal[3 * c];
        s_g[c] = pal[3 * c + 1];
        s_b[c] = pal[3 * c + 2];
    }

    int mo[R1_PER_LANE];
    uint8_t mm[R1_PER_LANE];
    TI pr[R1_PER_LANE], pg[R1_PER_LANE], pb[R1_PER_LANE];

    // Orders and masks of a chunk into registers (order -1 past the curve).
    auto load_meta = [&](int chunk) {
#pragma unroll
        for (int j = 0; j < R1_PER_LANE; ++j) {
            const int pos = chunk * R1_CHUNK + lane + 32 * j;
            const bool in = pos < N;
            mo[j] = in ? order[pos] : -1;
            mm[j] = in ? mask[pos] : (uint8_t)0;
        }
    };
    // Orders, and the masks decoded into the weights of the receivers at
    // offsets 1..4 (0: none), into the chunk's slot.
    auto store_meta = [&](int chunk) {
        const int base = (chunk % R1_SLOTS) * R1_CHUNK;
#pragma unroll
        for (int j = 0; j < R1_PER_LANE; ++j) {
            s_ord[base + lane + 32 * j] = mo[j];
            unsigned bits = mm[j];
            float w[4];
#pragma unroll
            for (int d = 0; d < 4; ++d) {
                w[d] = bits ? fs_weight(__ffs(bits) - 1) : 0.0f;
                bits &= bits - 1;
            }
            s_w[base + lane + 32 * j] = make_float4(w[0], w[1], w[2], w[3]);
        }
    };
    // Pixels of a chunk into registers, through its staged orders.
    auto gather = [&](int chunk) {
        const int base = (chunk % R1_SLOTS) * R1_CHUNK;
#pragma unroll
        for (int j = 0; j < R1_PER_LANE; ++j) {
            const int o = s_ord[base + lane + 32 * j];
            if (o >= 0) {
                const TI* p = frame + 3 * (int64_t)o;
                pr[j] = p[0];
                pg[j] = p[1];
                pb[j] = p[2];
            } else {
                pr[j] = pg[j] = pb[j] = TI(0);
            }
        }
    };
    auto store_px = [&](int chunk) {
        float* base = s_px + (chunk % R1_SLOTS) * R1_CHUNK * 3;
#pragma unroll
        for (int j = 0; j < R1_PER_LANE; ++j) {
            float* q = base + 3 * (lane + 32 * j);
            q[0] = static_cast<float>(pr[j]);
            q[1] = static_cast<float>(pg[j]);
            q[2] = static_cast<float>(pb[j]);
        }
    };

    for (int q = 0; q < R1_SLOTS; ++q) {
        load_meta(q);
        store_meta(q);
    }
    __syncwarp();
    for (int q = 0; q < 2; ++q) {
        gather(q);
        store_px(q);
    }
    __syncwarp();

    // The ring: working values of steps i .. i + 4 (0 past the curve).
    float rr[5], rg[5], rb[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        rr[k] = s_px[3 * k];
        rg[k] = s_px[3 * k + 1];
        rb[k] = s_px[3 * k + 2];
    }
    const bool have = lane < P;
    float lr = 0.0f, lg = 0.0f, lb = 0.0f;
    if (REG_PAL && have) {
        lr = s_r[lane];
        lg = s_g[lane];
        lb = s_b[lane];
    }

    const int n_chunks = (N + R1_CHUNK - 1) / R1_CHUNK;
    for (int c = 0; c < n_chunks; ++c) {
        gather(c + 2);
        load_meta(c + 3);
        const int steps = min(R1_CHUNK, N - c * R1_CHUNK);
        const float* px_here = s_px + (c % R1_SLOTS) * R1_CHUNK * 3;
        const float* px_next = s_px + ((c + 1) % R1_SLOTS) * R1_CHUNK * 3;
        const float4* w_here = s_w + (c % R1_SLOTS) * R1_CHUNK;
        for (int t = 0; t < steps; ++t) {
            // The step's loads first: none depends on the chain.
            const float4 wv = w_here[t];
            const int tf = t + 5;
            const float* f = tf < R1_CHUNK ? px_here + 3 * tf : px_next + 3 * (tf - R1_CHUNK);
            const float fr = f[0], fg = f[1], fb = f[2];
            const float r0 = rr[0], g0 = rg[0], b0 = rb[0];
            unsigned key = R1_FULL;
            int best_i = lane;
            if (REG_PAL) {
                if (have) key = __float_as_uint(dist2(r0, g0, b0, lr, lg, lb));
            } else if (have) {
                float best = dist2(r0, g0, b0, s_r[lane], s_g[lane], s_b[lane]);
                for (int cc = lane + 32; cc < P; cc += 32) {
                    const float d = dist2(r0, g0, b0, s_r[cc], s_g[cc], s_b[cc]);
                    if (d < best) {
                        best = d;
                        best_i = cc;
                    }
                }
                key = __float_as_uint(best);
            }
            const unsigned m = __reduce_min_sync(R1_FULL, key);
            unsigned idx;
            float cr, cg, cb;
            if (REG_PAL) {
                // Colour i is lane i's: the lowest lane at the minimum.
                idx = __ffs(__ballot_sync(R1_FULL, key == m)) - 1;
                cr = __shfl_sync(R1_FULL, lr, idx);
                cg = __shfl_sync(R1_FULL, lg, idx);
                cb = __shfl_sync(R1_FULL, lb, idx);
            } else {
                idx = __reduce_min_sync(R1_FULL, key == m ? (unsigned)best_i : R1_FULL);
                cr = s_r[idx];
                cg = s_g[idx];
                cb = s_b[idx];
            }
            if (lane == 0) s_idx[t] = (int)idx;
            const float er = __fsub_rn(r0, cr);
            const float eg = __fsub_rn(g0, cg);
            const float eb = __fsub_rn(b0, cb);
            const float w[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int d = 1; d <= 4; ++d) {
                const bool on = w[d - 1] > 0.0f;
                rr[d] = on ? receive(rr[d], er, w[d - 1]) : rr[d];
                rg[d] = on ? receive(rg[d], eg, w[d - 1]) : rg[d];
                rb[d] = on ? receive(rb[d], eb, w[d - 1]) : rb[d];
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                rr[k] = rr[k + 1];
                rg[k] = rg[k + 1];
                rb[k] = rb[k + 1];
            }
            rr[4] = fr;
            rg[4] = fg;
            rb[4] = fb;
        }
        __syncwarp();
        const int* ord_here = s_ord + (c % R1_SLOTS) * R1_CHUNK;
#pragma unroll
        for (int j = 0; j < R1_PER_LANE; ++j) {
            const int t = lane + 32 * j;
            if (t < steps) {
                const int id = s_idx[t];
                uint8_t* q = fout + 3 * (int64_t)ord_here[t];
                q[0] = (uint8_t)(int)s_r[id];
                q[1] = (uint8_t)(int)s_g[id];
                q[2] = (uint8_t)(int)s_b[id];
            }
        }
        __syncwarp();
        store_px(c + 2);
        store_meta(c + 3);
        __syncwarp();
    }
}

template <typename TI, bool REG_PAL>
int launch(const TI* frames, const float* pal, int P, const int32_t* order,
           const uint8_t* mask, int N, int B, int64_t frame_elems, uint8_t* out,
           cudaStream_t stream) {
    const int smem = dpt_riemersma_smem_bytes(P);
    if (smem > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            riemersma_kernel<TI, REG_PAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    riemersma_kernel<TI, REG_PAL><<<B, 32, smem, stream>>>(frames, pal, P, order, mask, N,
                                                           frame_elems, out);
    return (int)cudaGetLastError();
}

}  // namespace

int dpt_riemersma_smem_bytes(int P) {
    // Pixels, orders, indices, the palette padded to 16 bytes, the weights.
    return (R1_SLOTS * R1_CHUNK * 3 + R1_SLOTS * R1_CHUNK + R1_CHUNK + (3 * P + 3) / 4 * 4) * 4 +
           R1_SLOTS * R1_CHUNK * 16;
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
        const float* f = static_cast<const float*>(frames);
        return P <= 32 ? launch<float, true>(f, pal, P, order, mask, N, B, elems, out, s)
                       : launch<float, false>(f, pal, P, order, mask, N, B, elems, out, s);
    }
    const uint8_t* f = static_cast<const uint8_t*>(frames);
    return P <= 32 ? launch<uint8_t, true>(f, pal, P, order, mask, N, B, elems, out, s)
                   : launch<uint8_t, false>(f, pal, P, order, mask, N, B, elems, out, s);
}
