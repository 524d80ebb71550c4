// K4: fused ordered (threshold-screen) dithering.
//
// Replaces the TPU kernel dither_pie_tpu/ops/ordered_pallas.py
// `_compiled_padded` (body `_build`). It computes the same function, for
// every pixel (b, y, x) of a (B, H, W, 3) batch, u8 or float32 (a float32
// pixel is taken as it is, never truncated: the wavelet mode's
// reconstruction is not integer-valued):
//   d_p    = (dr*dr + dg*dg) + db*db, dr = r - pal[p].r, ... in float32
//   (d1, i1), (d2, i2) = running top-2 over p = 0..P-1, strict <, so the
//                        lowest index wins every tie (d2 = +inf, i2 = 0
//                        with P = 1)
//   factor = d1 + d2 == 0 ? 0 : d1 / (d1 + d2)
//   idx    = factor <= screen[y, x] ? i1 : i2
//   out    = (u8)(int)palette[idx] (3 bytes), or (u8)idx with emit_idx
// and equals the plain PyTorch version (ops/ordered_fused.py) bit for bit.
//
// What bounds it: at 16 x 1080p with P = 16 it moves 99.5 MB in (398 MB
// of float32 frames), 99.5 MB out and the 8.3 MB screen (~62 us at
// 3.35 TB/s; ~151 us from float32). The distances are the work: one
// palette step a pixel was three scalar shared-memory loads, eight _rn
// float operations and a branchy top-2 update, so the old kernel (one
// thread a pixel, a grid-stride loop with a 64-bit i % hw) was bound by
// instruction issue at ~8x its bound. This design cuts the instructions a
// palette step and the per-pixel overhead.
//
// Two bodies, chosen by data inside the kernel (both held bitwise to the
// plain version; neither is a fallback):
//  * Integer body: u8 frames and a palette whose every value is an integer
//    in [0, 255]. Each block votes on that while it stages the palette
//    (__syncthreads_and); no host synchronisation, no second launch. Every
//    difference, square and sum is then an exact integer below 2^24 in
//    float32, so the order of operations changes no bit and
//    d = |x|^2 - 2 x.p + |p|^2 exactly. A palette step is __dp4a on packed
//    r | g<<8 | b<<16 words (x.p), one multiply-add to the key
//    k = c_p - 8192 x.p, c_p = |p|^2 * 4096 + p (the per-pixel |x|^2 * 4096
//    is left out of every key and added back at the end), and a branch-free
//    top-2 on the keys: m2 = min(m2, max(m1, k)); m1 = min(m1, k). Keys are
//    unique, and their order is the lexicographic order on (d, p): exactly
//    "strict <, the lowest index wins". A key lies in [-8.0e8, 8.0e8] (the
//    multiply-add's product reaches -1.6e9), so int32 holds it and INT_MAX
//    is m2's sentinel (P = 1: d2 = +inf, i2 = 0). d1 = (m1 >> 12) + |x|^2,
//    i1 = m1 & 4095, and the same for m2, enter the float32 factor exactly.
//  * Float body: float32 frames (wavelet), or a palette that fails the
//    vote. Today's arithmetic in today's order (_rn intrinsics; the build
//    adds --fmad=false), with one 16-byte (r, g, b, 0) shared-memory load a
//    palette step and the top-2 updated by selects.
//
// Both bodies:
//  * The grid is (pixel groups of a row, rows y, ceil(B / FRAMES)): block
//    (bx, y, z) takes row y of frames z, z + grid.z, ...; thread t the
//    PIXELS pixels from x0 = (bx*threads + t)*PIXELS. No division, and the
//    screen row is read once, coalesced (float4 where aligned). A thread
//    loads the next frame's pixels before this frame's palette loop, so
//    their latency hides behind it. The plan (threads, pixels, frames,
//    grid, shared memory) is ops.ordered_fused.ordered_plan; the launcher
//    refuses any other. PIXELS = 4 and FRAMES = 2 were set by timing 4, 8
//    and 12 pixels by 1, 2, 4 and 8 frames on an H100 (PERF.md, PR 9).
//  * A thread loads its 3*PIXELS-byte run of u8 pixels as the aligned
//    32-bit words that cover it (a word that overlaps the tensor lies in
//    its allocation) and realigns them with __funnelshift_r, so any base
//    alignment works (a contiguous slice may start anywhere); float32
//    pixels as float4s where aligned. It stores its colour run (3*PIXELS
//    bytes) or index run (PIXELS bytes) as 32-bit words, the head and tail
//    bytes of a misaligned run one by one. A warp's stores, lanes 12 bytes
//    apart, each write a third of a sector; staging a warp's runs in shared
//    memory and moving them as whole 16-byte words made the I/O alone as
//    fast as clone(), but the kernel no faster (its instruction issue
//    hides the I/O), so the stage is not kept (PERF.md, PR 9).
//  * The palette is staged once a block in dynamic shared memory, 16 bytes
//    a colour (64 KB at 4096 colours, above the 48 KB default: the launcher
//    raises the kernel's limit). Every thread of a warp reads the same
//    entry: a broadcast. P is a runtime value, so the palette loop indexes
//    it dynamically and a __grid_constant__ copy could not give constant-bank
//    operands; shared memory serves every P.
//
// The numpy model in tests/test_torch_ordered_rows.py walks the plan, the
// word loads and stores on byte buffers at odd offsets, the vote and the
// integer body's keys, and holds them to the plain version bit for bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "launchers.h"

namespace {

constexpr int PIXELS = 4;         // pixels a thread
constexpr int FRAMES = 2;         // frames a block walks, at most
constexpr int MAX_THREADS = 256;  // threads a block, at most
constexpr int ENTRY_BYTES = 16;   // shared memory a palette colour

// Bytes [0, nb) at src (any alignment) into v[0..NW), nb <= 4*NW: the
// aligned 32-bit words that cover them, realigned by a funnel shift.
template <int NW>
__device__ __forceinline__ void load_run(const uint8_t* src, int nb, uint32_t (&v)[NW]) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(src);
    const uintptr_t a0 = lo & ~uintptr_t(3);
    const int shift = 8 * (int)(lo & 3);
    uint32_t u[NW + 1];
#pragma unroll
    for (int k = 0; k <= NW; ++k) {
        u[k] = a0 + 4 * k < lo + nb ? __ldg(reinterpret_cast<const uint32_t*>(a0 + 4 * k)) : 0u;
    }
#pragma unroll
    for (int m = 0; m < NW; ++m) v[m] = __funnelshift_r(u[m], u[m + 1], shift);
}

// Bytes [0, nb) of the little-endian words v[0..NW) to dst (any
// alignment): an aligned word wholly inside the run is one 32-bit store,
// the run's bytes of its head and tail words are stored one by one.
template <int NW>
__device__ __forceinline__ void store_run(uint8_t* dst, const uint32_t (&v)[NW], int nb) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(dst);
    const uintptr_t hi = lo + nb;
    const uintptr_t a0 = lo & ~uintptr_t(3);
    const int shift = 8 * (int)(lo & 3);
#pragma unroll
    for (int k = 0; k <= NW; ++k) {
        const uintptr_t wa = a0 + 4 * k;
        if (wa >= hi) break;
        // Word k holds bytes [4k - sh, 4k - sh + 4) of the run.
        const uint32_t w = __funnelshift_l(k > 0 ? v[k - 1] : 0u, k < NW ? v[k] : 0u, shift);
        if (wa >= lo && wa + 4 <= hi) {
            *reinterpret_cast<uint32_t*>(wa) = w;
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (wa + i >= lo && wa + i < hi) {
                    reinterpret_cast<uint8_t*>(wa)[i] = (uint8_t)(w >> (8 * i));
                }
            }
        }
    }
}

__device__ __forceinline__ bool is_u8_value(float v) {
    return v >= 0.f && v <= 255.f && v == truncf(v);
}

// The pick of one pixel from its top-2.
__device__ __forceinline__ int pick(float d1, int i1, float d2, int i2, float screen) {
    const float tot = __fadd_rn(d1, d2);
    const float factor = tot == 0.f ? 0.f : __fdiv_rn(d1, tot);
    return factor <= screen ? i1 : i2;
}

// A thread's raw pixels: the 32-bit words of 3*PIX u8 bytes, or 3*PIX
// floats.
template <typename T, int PIX>
struct Raw;
template <int PIX>
struct Raw<uint8_t, PIX> {
    uint32_t w[3 * PIX / 4];
};
template <int PIX>
struct Raw<float, PIX> {
    float v[3 * PIX];
};

// The n <= PIX pixels from pixel px of the batch.
template <int PIX>
__device__ __forceinline__ void load_raw(const uint8_t* img, int64_t px, int n,
                                         Raw<uint8_t, PIX>& raw) {
    load_run(img + 3 * px, 3 * n, raw.w);
}
template <int PIX>
__device__ __forceinline__ void load_raw(const float* img, int64_t px, int n,
                                         Raw<float, PIX>& raw) {
    const float* src = img + 3 * px;
    if (n == PIX && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
        for (int k = 0; k < 3 * PIX / 4; ++k) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src) + k);
            raw.v[4 * k] = v.x, raw.v[4 * k + 1] = v.y;
            raw.v[4 * k + 2] = v.z, raw.v[4 * k + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < 3 * PIX; ++i) raw.v[i] = i < 3 * n ? __ldg(src + i) : 0.f;
    }
}

// Pixel j of the raw u8 words, packed r | g<<8 | b<<16: bytes 3j..3j+2.
template <int PIX>
__device__ __forceinline__ uint32_t packed_pixel(const Raw<uint8_t, PIX>& raw, int j) {
    constexpr int NW = 3 * PIX / 4;
    const int w = 3 * j / 4, off = 3 * j % 4;
    const uint32_t hi = w + 1 < NW ? raw.w[w + 1] : 0u;
    return __funnelshift_r(raw.w[w], hi, 8 * off) & 0xFFFFFFu;
}

template <typename T, int PIX>
__global__ void __launch_bounds__(MAX_THREADS)
ordered_rows_kernel(const T* __restrict__ img, const float* __restrict__ pal, int P,
                    const float* __restrict__ screen, int B, int H, int W,
                    uint8_t* __restrict__ out, int emit_idx) {
    static_assert(PIX % 4 == 0, "a thread's runs are whole 32-bit words");
    extern __shared__ __align__(16) uint8_t smem[];
    constexpr bool U8 = std::is_same<T, uint8_t>::value;

    // Stage the palette: the integer body's (packed colour, c_p) pairs or
    // the float body's (r, g, b, 0) entries, after the block's vote.
    bool integer = false;
    if (U8) {
        int ok = 1;
        for (int k = threadIdx.x; k < P; k += blockDim.x) {
            ok &= is_u8_value(pal[3 * k]) & is_u8_value(pal[3 * k + 1]) &
                  is_u8_value(pal[3 * k + 2]);
        }
        integer = __syncthreads_and(ok);
    }
    if (integer) {
        int2* ip = reinterpret_cast<int2*>(smem);
        for (int k = threadIdx.x; k < P; k += blockDim.x) {
            const int r = (int)pal[3 * k], g = (int)pal[3 * k + 1], b = (int)pal[3 * k + 2];
            ip[k] = make_int2(r | (g << 8) | (b << 16), ((r * r + g * g + b * b) << 12) | k);
        }
    } else {
        float4* fp = reinterpret_cast<float4*>(smem);
        for (int k = threadIdx.x; k < P; k += blockDim.x) {
            fp[k] = make_float4(pal[3 * k], pal[3 * k + 1], pal[3 * k + 2], 0.f);
        }
    }
    __syncthreads();

    const int y = blockIdx.y;
    const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * PIX;
    if (x0 >= W) return;
    const int n = min(PIX, W - x0);

    // The screen's PIX values of this row.
    float sc[PIX];
    const float* srow = screen + (int64_t)y * W + x0;
    if (n == PIX && (reinterpret_cast<uintptr_t>(srow) & 15) == 0) {
#pragma unroll
        for (int k = 0; k < PIX / 4; ++k) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(srow) + k);
            sc[4 * k] = v.x, sc[4 * k + 1] = v.y, sc[4 * k + 2] = v.z, sc[4 * k + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < PIX; ++j) sc[j] = j < n ? __ldg(srow + j) : 0.f;
    }

    // Frames z, z + grid.z, ...: the next frame's pixels are loaded before
    // this frame's palette loop, so their latency hides behind it.
    Raw<T, PIX> cur, next;
    int b = blockIdx.z;
    if (b < B) load_raw(img, ((int64_t)b * H + y) * W + x0, n, cur);
    for (; b < B; b += gridDim.z) {
        const int64_t px = ((int64_t)b * H + y) * W + x0;  // first pixel
        if (b + (int)gridDim.z < B) load_raw(img, px + (int64_t)gridDim.z * H * W, n, next);

        int idx[PIX];
        uint32_t colour[PIX];  // packed r | g<<8 | b<<16 of the pick
        if (integer) {
            uint32_t xp[PIX];
#pragma unroll
            for (int j = 0; j < PIX; ++j) {
                if constexpr (U8) xp[j] = packed_pixel(cur, j);
            }
            const int2* ip = reinterpret_cast<const int2*>(smem);
            int m1[PIX], m2[PIX];
#pragma unroll
            for (int j = 0; j < PIX; ++j) m1[j] = m2[j] = INT_MAX;
            for (int p = 0; p < P; ++p) {
                const int2 e = ip[p];
#pragma unroll
                for (int j = 0; j < PIX; ++j) {
                    const int dot = (int)__dp4a(xp[j], (uint32_t)e.x, 0u);
                    const int k = e.y - dot * 8192;
                    m2[j] = min(m2[j], max(m1[j], k));
                    m1[j] = min(m1[j], k);
                }
            }
#pragma unroll
            for (int j = 0; j < PIX; ++j) {
                const int xx = (int)__dp4a(xp[j], xp[j], 0u);
                const float d1 = (float)((m1[j] >> 12) + xx);
                const bool one = m2[j] == INT_MAX;  // P = 1
                const float d2 = one ? __int_as_float(0x7f800000) : (float)((m2[j] >> 12) + xx);
                idx[j] = pick(d1, m1[j] & 4095, d2, one ? 0 : (m2[j] & 4095), sc[j]);
                colour[j] = (uint32_t)ip[idx[j]].x;
            }
        } else {
            float r[PIX], g[PIX], bl[PIX];
#pragma unroll
            for (int j = 0; j < PIX; ++j) {
                if constexpr (U8) {
                    const uint32_t x = packed_pixel(cur, j);
                    r[j] = (float)(x & 255u);
                    g[j] = (float)((x >> 8) & 255u);
                    bl[j] = (float)(x >> 16);
                } else {
                    r[j] = cur.v[3 * j], g[j] = cur.v[3 * j + 1], bl[j] = cur.v[3 * j + 2];
                }
            }
            const float4* fp = reinterpret_cast<const float4*>(smem);
            float d1[PIX], d2[PIX];
            int i1[PIX], i2[PIX];
#pragma unroll
            for (int j = 0; j < PIX; ++j) {
                d1[j] = d2[j] = __int_as_float(0x7f800000);  // +inf
                i1[j] = i2[j] = 0;
            }
            for (int p = 0; p < P; ++p) {
                const float4 e = fp[p];
#pragma unroll
                for (int j = 0; j < PIX; ++j) {
                    const float dr = __fsub_rn(r[j], e.x);
                    const float dg = __fsub_rn(g[j], e.y);
                    const float db = __fsub_rn(bl[j], e.z);
                    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dg, dg)),
                                              __fmul_rn(db, db));
                    const bool lt1 = d < d1[j];
                    const bool lt2 = d < d2[j];
                    d2[j] = lt1 ? d1[j] : (lt2 ? d : d2[j]);
                    i2[j] = lt1 ? i1[j] : (lt2 ? p : i2[j]);
                    d1[j] = lt1 ? d : d1[j];
                    i1[j] = lt1 ? p : i1[j];
                }
            }
#pragma unroll
            for (int j = 0; j < PIX; ++j) {
                idx[j] = pick(d1[j], i1[j], d2[j], i2[j], sc[j]);
                // f32 -> i32 truncates, as the TPU kernel's astype does.
                const float4 e = fp[idx[j]];
                colour[j] = ((uint32_t)(uint8_t)(int)e.x) | ((uint32_t)(uint8_t)(int)e.y << 8) |
                            ((uint32_t)(uint8_t)(int)e.z << 16);
            }
        }

        if (emit_idx) {
            uint32_t w[PIX / 4];
#pragma unroll
            for (int m = 0; m < PIX / 4; ++m) {
                w[m] = (uint32_t)(idx[4 * m] & 255) | ((uint32_t)(idx[4 * m + 1] & 255) << 8) |
                       ((uint32_t)(idx[4 * m + 2] & 255) << 16) |
                       ((uint32_t)(idx[4 * m + 3] & 255) << 24);
            }
            store_run(out + px, w, n);
        } else {
            // Word m holds bytes 4m..4m+3 of the run: pixel j's colour sits
            // 3j - 4m bytes into it (its bytes outside the word drop out).
            uint32_t w[3 * PIX / 4];
#pragma unroll
            for (int m = 0; m < 3 * PIX / 4; ++m) {
                uint32_t v = 0;
#pragma unroll
                for (int j = 0; j < PIX; ++j) {
                    const int sh = 3 * j - 4 * m;
                    if (sh > -3 && sh < 4) {
                        v |= sh >= 0 ? colour[j] << (8 * sh) : colour[j] >> (-8 * sh);
                    }
                }
                w[m] = v;
            }
            store_run(out + 3 * px, w, 3 * n);
        }
        cur = next;
    }
}

template <typename T>
int launch(const T* img, const float* pal, int P, const float* screen, int B, int H,
           int W, uint8_t* out, int emit_idx, const DptOrderedPlan& plan, void* stream) {
    if (B < 1 || H < 1 || W < 1 || P < 1 || P > DPT_ORDERED_MAX_PALETTE ||
        (emit_idx && P > 256)) {
        return (int)cudaErrorInvalidValue;
    }
    const int groups = (W + PIXELS - 1) / PIXELS;
    const int gx = (groups + MAX_THREADS - 1) / MAX_THREADS;
    const int threads = ((groups + gx - 1) / gx + 31) / 32 * 32;
    const int gz = (B + FRAMES - 1) / FRAMES;
    const dim3 grid(gx, H, gz < 65535 ? gz : 65535);
    const int smem = P * ENTRY_BYTES;
    if (plan.threads != threads || plan.pixels != PIXELS || plan.frames != FRAMES ||
        plan.grid[0] != (int)grid.x || plan.grid[1] != (int)grid.y ||
        plan.grid[2] != (int)grid.z || plan.smem_bytes != smem || H > 65535) {
        return (int)cudaErrorInvalidConfiguration;
    }
    if (smem > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            ordered_rows_kernel<T, PIXELS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    ordered_rows_kernel<T, PIXELS><<<grid, threads, smem, (cudaStream_t)stream>>>(
        img, pal, P, screen, B, H, W, out, emit_idx);
    return (int)cudaGetLastError();
}

}  // namespace

int dpt_ordered_fused_u8(const uint8_t* img, const float* pal, int P, const float* screen,
                         int B, int H, int W, uint8_t* out, int emit_idx,
                         const DptOrderedPlan& plan, void* stream) {
    return launch<uint8_t>(img, pal, P, screen, B, H, W, out, emit_idx, plan, stream);
}

int dpt_ordered_fused_f32(const float* img, const float* pal, int P, const float* screen,
                          int B, int H, int W, uint8_t* out, int emit_idx,
                          const DptOrderedPlan& plan, void* stream) {
    return launch<float>(img, pal, P, screen, B, H, W, out, emit_idx, plan, stream);
}
