// K2 and K8: the wavefront error-diffusion scan, every mode.
//
// K2 (packed colours out) replaces the TPU kernel
// dither_pie_tpu/ops/wavefront.py `_build_kernel_packed` for the modes
// fixed, ostromoukhov, hybrid, perceptual and adaptive and palettes of up
// to 1024 colours; K8 (palette indices out, palettes of up to
// DPT_IDX_MAX_PALETTE colours) replaces the v1 scan `_build_kernel` of the
// same file. They are one kernel body with
// two outputs. For each wavefront step d and every pixel
// (b, y, x = d - s*y) inside the image,
//   cur  = img + c_1 + c_2 + ...                  left fold, consume order
//   cur  = clamp(cur, 0, 255)                     fixed, ostromoukhov, hybrid
//   idx  = first argmin_p (dr*dr + dg*dg) + db*db  strict <, first wins
//          or, with the score branch (dense_search="mxu"),
//          first argmax_p ((r_p*cur_r + g_p*cur_g) + b_p*cur_b) + n_p,
//          n_p = -0.5*((r_p*r_p + g_p*g_p) + b_p*b_p), strict >, first wins
//   err  = cur - palette[idx]
//   out  = (r << 16 | g << 8 | b) of palette[idx], truncated to int (K2)
//          idx                                                      (K8)
// where c_k = f(y - dy_k, x - dx_k) * w_k is what entry k of the diffusion
// kernel carries in from an earlier pixel, its source:
//   fixed         f = err, w_k the variant's pre-divided weight
//   hybrid        f = lum_factor*l + col_factor*(err - l), l = coef * lum(err)
//   adaptive      f = err * gate(source)
//   perceptual    f = err, w_k = fs_k * sens(source)
//   ostromoukhov  f = err, w_k = lut[lum(clamped source pixel)][column_k]
// That is the golden row-major engine's in-place accumulation order, so the
// result is bit-identical to dither_pie_tpu/native/ed_scan.cpp
// `ed_fixed_f32`, `ed_ostromoukhov_f32`, `ed_hybrid_f32`,
// `ed_perceptual_f32` and `ed_adaptive_f32`. Perceptual follows the golden
// engine's product err * (fs_k * sens), not the TPU kernel's
// (err * sens) * fs_k, which rounds differently.
//
// What bounds it: the serial chain of D = W + s*(H-1) steps, each step the
// fold, the palette search, the error and a barrier (rows y-1 and y-2 of
// step d-1 feed row y of step d), and inside a step the issue of the
// search: about 13 instructions a colour and row (3 subtracts, 3
// multiplies, 2 adds, the compare and two selects, a quarter of a 16-byte
// shared load), ~0.035 us a colour-step on one SM at 1080p, where up to 30
// warps of rows are active. One block a frame (the previous body) left 116
// of 132 SMs idle at 16 frames. On an H100 a step costs about c_n + k*P/n
// (tools/time_ed_path.py --sweep, PERF.md): k = 0.035 us, c_1 = 1.6 us,
// and c_n - c_1 = 1.1-1.9 us for the cluster barrier and the merge.
//
// Design.
//  * One frame over a thread-block cluster of n blocks (n in {1, 2, 4, 8},
//    ops/wavefront.py `scan_cluster_plan`: a fixed table by palette size,
//    lowered until all B clusters are resident at once; grid B*n, frame
//    blockIdx.x / n, rank cluster.block_rank()). Every block owns all of the
//    frame's rows (y = tid, tid + blockDim, ...), as the one block of n = 1.
//  * The palette split across the cluster: rank r searches the contiguous
//    colours [lo_r, lo_{r+1}), packed from index 0 in its shared memory
//    (12 bytes a colour, so that four colours load as three 16-byte words;
//    16 with the score branch), with the running minimum (strict <) or the
//    score's running maximum (strict >), and writes (key, index) of every
//    active row into its shared memory, double-buffered by the parity of d
//    (key: the distance, or the negated score). One cluster barrier
//    (release/acquire), then every block reads the n candidates of each of
//    its active rows from its peers (distributed shared memory) in rank
//    order and keeps the first strict minimum of the key: slices are
//    contiguous and in rank order, so that is the first strict extremum
//    over the whole palette, the single block's pick bit for bit; the merge
//    only compares. Every block then errs and records every row with the
//    same float32 operations, so all n blocks hold the same history: no
//    history crosses SMs, only 8-byte candidates do. A block writes slot
//    (d+1) mod 2 only after passing barrier d, which each peer reaches only
//    after reading slot (d-1) mod 2.
//  * The colour of the pick: with n > 1 and up to DPT_MAX_PALETTE colours
//    every block also keeps the whole palette's (r, g, b) in shared memory;
//    K8 above DPT_MAX_PALETTE colours with n > 1 reads the winner's colour
//    from device memory (12 bytes a row-step, an L2 hit).
//  * The error history in shared memory. Each row keeps its last `ring`
//    errors (hist, indexed by column mod ring) and each pixel PULLS f * w_k
//    from its sources; the products are the TPU kernel's pushed products
//    and the fold runs in the same order, so the sums are bitwise those of
//    the push form. hist holds f, the error AFTER the mode's transform;
//    for perceptual and ostromoukhov a fourth float beside it holds the
//    source's sensitivity or its luminance index. ring is the power of two
//    >= n_slots = max(dx + s*dy) + 1: the column a source row writes in the
//    same step (x + s*dy) never aliases one still to be read. ring*C*H
//    floats a frame (50-101 KB at 1080p) live in dynamic shared memory
//    where they fit beside the rest of the block's 227 KB
//    (ops/wavefront.py `scan_smem_plan`; template flag HIST_SMEM); where
//    they do not (jjn and stucki, ring 16, at 1080p and above) each block
//    keeps its own copy in device memory.
//  * The stream is read at the fold, not fetched a step ahead: a fetch of
//    step d+1's pixels into a shared-memory stage during step d was built
//    and measured slower in every mode, at n = 1 and n = 4 (PERF.md).
//    The SM is bound by the issue of up to 30 warps' instructions, which
//    hides one warp's load behind the others' work; the fetch only added
//    instructions. With n > 1 a stage carries each row's working value
//    across the cluster barrier.
//  * Output written once: rank r writes `out` only for the rows y = r
//    (mod n).
//  * The mode, the input type, the output, the search, the history's place
//    and whether the launch is a cluster (n > 1) are template parameters,
//    decided outside the step loop: n = 1 compiles to the single block's
//    loop, with no merge.
//  * Ostromoukhov's (256, 3) weight table sits in shared memory and a
//    thread indexes it (the TPU's halving-tree walk was its missing gather).
//    The aux map of perceptual and adaptive is read in place,
//    aux[b, y, d - s*y]. The score branch runs only where the caller asks
//    for it, for 64 < P <= DPT_MAX_PALETTE.
//  * Rounding: every add and multiply of the fold, the distance, the error
//    and the mode's transform uses the _rn intrinsics, and the build adds
//    --fmad=false, so no multiply-add is contracted into an FMA (the golden
//    engine builds with -ffp-contract=off).
//  * Every thread, those of rows at or beyond H included, reaches every
//    barrier; a last cluster barrier keeps each block's shared memory alive
//    until its peers have read it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launchers.h"
#include "palette_search.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FIXED = 0;
constexpr int OSTROMOUKHOV = 1;
constexpr int HYBRID = 2;
constexpr int PERCEPTUAL = 3;
constexpr int ADAPTIVE = 4;

constexpr int LUT_FLOATS = 256 * 3;

// Clamp as the golden engine's clampf does.
__device__ __forceinline__ float clamp255(float v) {
    return v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
}

// (0.299*r + 0.587*g) + 0.114*b, each operation rounded on its own.
__device__ __forceinline__ float luma(float r, float g, float b) {
    return __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                     __fmul_rn(0.114f, b));
}

// One row's pixel of one step: the stream's three channels and the aux
// value (0 where the mode has none). img_b: the frame's first lane of step
// 0, (D, 3B, H) strides; aux_b: the frame's (H, W) map.
template <typename T, bool HAS_AUX>
__device__ __forceinline__ float4 load_px(const T* __restrict__ img_b,
                                          const float* __restrict__ aux_b,
                                          int64_t step, int64_t plane, int d,
                                          int y, int x, int W) {
    const T* px = img_b + d * step + y;
    float4 p;
    p.x = (float)px[0];
    p.y = (float)px[plane];
    p.z = (float)px[2 * plane];
    p.w = HAS_AUX ? aux_b[(int64_t)y * W + x] : 0.f;
    return p;
}

// The left fold of a pixel's incoming errors, in consume order, and the
// clamp of the modes that clamp before the search. hb: the block's
// history, (ring, C, H) floats.
template <int MODE, int C>
__device__ __forceinline__ void fold(float& cur0, float& cur1, float& cur2,
                                     const DptScanEntries& e,
                                     const float* hb, const float* slut,
                                     int y, int x, int W, int H, int mask) {
#pragma unroll
    for (int k = 0; k < DPT_MAX_ENTRIES; ++k) {
        if (k < e.n) {
            const int ys = y - e.dy[k];
            const int xs = x - e.dx[k];
            if (ys >= 0 && xs >= 0 && xs < W) {
                const float* src = hb + ((xs & mask) * C) * H + ys;
                float wk;
                if (MODE == OSTROMOUKHOV) {
                    wk = slut[3 * __float_as_int(src[3 * H]) + e.col[k]];
                } else if (MODE == PERCEPTUAL) {
                    wk = __fmul_rn(e.w[k], src[3 * H]);
                } else {
                    wk = e.w[k];
                }
                cur0 = __fadd_rn(cur0, __fmul_rn(src[0], wk));
                cur1 = __fadd_rn(cur1, __fmul_rn(src[H], wk));
                cur2 = __fadd_rn(cur2, __fmul_rn(src[2 * H], wk));
            }
        }
    }
    if (MODE == FIXED || MODE == OSTROMOUKHOV || MODE == HYBRID) {
        cur0 = clamp255(cur0);
        cur1 = clamp255(cur1);
        cur2 = clamp255(cur2);
    }
}

// The error of the pick, transformed by the mode, into the row's history;
// returns the output value of the pixel.
template <int MODE, bool EMIT_IDX, int C>
__device__ __forceinline__ int32_t finish(float cur0, float cur1, float cur2,
                                          float a, float c_r, float c_g,
                                          float c_b, int best_i, float* hb,
                                          int y, int x, int H, int mask,
                                          float lum_factor, float col_factor) {
    float e0 = __fsub_rn(cur0, c_r);
    float e1 = __fsub_rn(cur1, c_g);
    float e2 = __fsub_rn(cur2, c_b);
    if (MODE == ADAPTIVE) {
        e0 = __fmul_rn(e0, a);
        e1 = __fmul_rn(e1, a);
        e2 = __fmul_rn(e2, a);
    } else if (MODE == HYBRID) {
        const float lum_err = luma(e0, e1, e2);
        const float l0 = __fmul_rn(0.299f, lum_err);
        const float l1 = __fmul_rn(0.587f, lum_err);
        const float l2 = __fmul_rn(0.114f, lum_err);
        e0 = __fadd_rn(__fmul_rn(lum_factor, l0),
                       __fmul_rn(col_factor, __fsub_rn(e0, l0)));
        e1 = __fadd_rn(__fmul_rn(lum_factor, l1),
                       __fmul_rn(col_factor, __fsub_rn(e1, l1)));
        e2 = __fadd_rn(__fmul_rn(lum_factor, l2),
                       __fmul_rn(col_factor, __fsub_rn(e2, l2)));
    }
    float* dst = hb + ((x & mask) * C) * H + y;
    dst[0] = e0;
    dst[H] = e1;
    dst[2 * H] = e2;
    if (MODE == PERCEPTUAL) {
        dst[3 * H] = a;
    } else if (MODE == OSTROMOUKHOV) {
        // Luminance of the clamped pixel, clamped, truncated.
        dst[3 * H] = __int_as_float((int)clamp255(luma(cur0, cur1, cur2)));
    }
    if (EMIT_IDX) return best_i;
    // f32 -> i32 truncates, as the TPU kernel's astype does.
    return ((int32_t)c_r << 16) | ((int32_t)c_g << 8) | (int32_t)c_b;
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Floats of each part of the dynamic shared memory, in order: the weight
// table, the block's palette slice, the whole palette's colours (n > 1 up
// to DPT_MAX_PALETTE colours), the history, the rows' stage and the
// candidates (the last two with n > 1). The same sums as ops/wavefront.py
// `scan_smem_bytes`.
struct SmemLayout {
    int lut, slice, colours, hist, stage, cand;
    __host__ __device__ int total() const {
        return lut + slice + colours + hist + stage + cand;
    }
};

__host__ __device__ inline SmemLayout smem_layout(int mode, bool score, int P,
                                                  int max_slice, int n,
                                                  int hist_smem, int ring,
                                                  int H) {
    const int C = (mode == OSTROMOUKHOV || mode == PERCEPTUAL) ? 4 : 3;
    SmemLayout l;
    l.lut = mode == OSTROMOUKHOV ? LUT_FLOATS : 0;
    l.slice = round4((score ? 4 : 3) * max_slice);
    l.colours = (n > 1 && P <= DPT_MAX_PALETTE) ? round4(3 * P) : 0;
    l.hist = hist_smem ? round4(ring * C * H) : 0;
    l.stage = n > 1 ? 4 * H : 0;  // float4 (working value, aux) a row
    l.cand = n > 1 ? 4 * H : 0;   // float2 (key, index) a row, two buffers
    return l;
}

template <typename T, int MODE, bool EMIT_IDX, bool SCORE, bool HIST_SMEM,
          bool CLUSTER>
__global__ void __launch_bounds__(1024, 1)
ed_scan_kernel(const T* __restrict__ img, const float* __restrict__ pal, int P,
               DptScanEntries e, const float* __restrict__ aux,
               const float* __restrict__ lut, float lum_factor,
               float col_factor, int s, int ring, int B, int H, int W, int D,
               float* __restrict__ ghist, int n, DptSlices sl, int max_slice,
               int32_t* __restrict__ out) {
    // Floats per pixel of hist, and a colour of the palette: (r, g, b), or
    // with the score branch the augmented (r, g, b, n).
    constexpr int C = (MODE == OSTROMOUKHOV || MODE == PERCEPTUAL) ? 4 : 3;
    constexpr bool HAS_AUX = MODE == PERCEPTUAL || MODE == ADAPTIVE;
    constexpr int PC = SCORE ? 4 : 3;

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = CLUSTER ? (int)cluster.block_rank() : 0;
    const int b = CLUSTER ? blockIdx.x / n : blockIdx.x;
    // The rank's slice, read without indexing the parameter array by a
    // register (which would copy it to local memory).
    int lo = 0, hi = P;
    if (CLUSTER) {
#pragma unroll
        for (int q = 0; q < DPT_MAX_CLUSTER; ++q) {
            if (q == rank) {
                lo = sl.lo[q];
                hi = sl.lo[q + 1];
            }
        }
    }
    const int len = hi - lo;

    extern __shared__ __align__(16) float smem[];
    const SmemLayout l = smem_layout(MODE, SCORE, P, max_slice, n, HIST_SMEM, ring, H);
    float* slut = smem;
    float* sslice = slut + l.lut;
    float* scol = sslice + l.slice;
    float* hb = HIST_SMEM ? scol + l.colours
                          : ghist + (int64_t)blockIdx.x * ring * C * H;
    float4* stage = reinterpret_cast<float4*>(scol + l.colours + l.hist);
    float2* cand = reinterpret_cast<float2*>(scol + l.colours + l.hist + l.stage);

    const int tid = threadIdx.x, bd = blockDim.x;
    if (MODE == OSTROMOUKHOV) {
        for (int i = tid; i < LUT_FLOATS; i += bd) slut[i] = lut[i];
    }
    for (int i = tid; i < PC * len; i += bd) sslice[i] = pal[PC * lo + i];
    for (int i = tid; i < (l.colours ? P : 0); i += bd) {
        scol[3 * i] = pal[PC * i];
        scol[3 * i + 1] = pal[PC * i + 1];
        scol[3 * i + 2] = pal[PC * i + 2];
    }
    const int64_t plane = (int64_t)B * H, step = 3 * plane;
    const T* img_b = img + (int64_t)b * H;
    const float* aux_b = HAS_AUX ? aux + (int64_t)b * H * W : nullptr;
    __syncthreads();

    const int mask = ring - 1;
    for (int d = 0; d < D; ++d) {
        int32_t* out_d = out + ((int64_t)d * B + b) * H;
        float2* cand_d = cand + (d & 1) * H;
        for (int y = tid; y < H; y += bd) {
            const int x = d - s * y;
            int32_t result = 0;
            if (x >= 0 && x < W) {
                const float4 px = load_px<T, HAS_AUX>(img_b, aux_b, step, plane, d, y, x, W);
                float cur0 = px.x, cur1 = px.y, cur2 = px.z;
                fold<MODE, C>(cur0, cur1, cur2, e, hb, slut, y, x, W, H, mask);
                float key;
                const int i = dpt_palette_search<SCORE>(sslice, len, cur0, cur1, cur2, key);
                if (!CLUSTER) {
                    result = finish<MODE, EMIT_IDX, C>(
                        cur0, cur1, cur2, px.w, sslice[PC * i], sslice[PC * i + 1],
                        sslice[PC * i + 2], i, hb, y, x, H, mask, lum_factor, col_factor);
                } else {
                    stage[y] = make_float4(cur0, cur1, cur2, px.w);
                    cand_d[y] = make_float2(key, __int_as_float(lo + i));
                }
            }
            if (!CLUSTER) out_d[y] = result;
        }
        if (CLUSTER) {
            // Candidates written; the peers' become visible.
            cluster.sync();
            for (int y = tid; y < H; y += bd) {
                const int x = d - s * y;
                int32_t result = 0;
                if (x >= 0 && x < W) {
                    // First strict winner in rank order: the slices are
                    // contiguous and ascending, so ties keep the lower index.
                    float2 c[DPT_MAX_CLUSTER];
#pragma unroll
                    for (int q = 0; q < DPT_MAX_CLUSTER; ++q) {
                        if (q < n) c[q] = *cluster.map_shared_rank(cand_d + y, q);
                    }
                    float best = c[0].x;
                    int best_i = __float_as_int(c[0].y);
#pragma unroll
                    for (int q = 1; q < DPT_MAX_CLUSTER; ++q) {
                        if (q < n && c[q].x < best) {
                            best = c[q].x;
                            best_i = __float_as_int(c[q].y);
                        }
                    }
                    // Beyond DPT_MAX_PALETTE colours (the exact search
                    // only) a block holds its slice alone: the colour
                    // comes from device memory.
                    const float* col = l.colours ? scol + 3 * best_i : pal + 3 * best_i;
                    const float4 st = stage[y];
                    result = finish<MODE, EMIT_IDX, C>(
                        st.x, st.y, st.z, st.w, col[0], col[1], col[2], best_i, hb,
                        y, x, H, mask, lum_factor, col_factor);
                }
                if ((y & (n - 1)) == rank) out_d[y] = result;
            }
        }
        // This step's history becomes visible to the next step's folds.
        __syncthreads();
    }
    // No block leaves while a peer may still read its candidates.
    if (CLUSTER) cluster.sync();
}

template <typename T, int MODE, bool EMIT_IDX, bool SCORE, bool HIST_SMEM,
          bool CLUSTER>
int launch(const DptScanArgs& a, cudaStream_t stream) {
    auto kernel = ed_scan_kernel<T, MODE, EMIT_IDX, SCORE, HIST_SMEM, CLUSTER>;
    const SmemLayout l = smem_layout(MODE, SCORE, a.P, a.max_slice, a.n,
                                     a.hist_smem, a.ring, a.H);
    const size_t smem_bytes = (size_t)l.total() * sizeof(float);
    // The wrapper's budget (ops/wavefront.py scan_smem_bytes) must be the
    // kernel's layout.
    if (smem_bytes != (size_t)a.smem_bytes || smem_bytes > DPT_SMEM_BYTES) {
        return (int)cudaErrorInvalidValue;
    }
    if (smem_bytes > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
        if (rc != cudaSuccess) return (int)rc;
    }
    int threads = ((a.H + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.B * a.n, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (a.capacity != nullptr) {
        // Only the question: how many clusters of a.n blocks fit at once.
        return (int)cudaOccupancyMaxActiveClusters(a.capacity, kernel, &cfg);
    }
    const cudaError_t rc = cudaLaunchKernelEx(
        &cfg, kernel, (const T*)a.img, SCORE ? a.pal_aug : a.pal, a.P, a.e,
        a.aux, a.lut, a.lum_factor, a.col_factor, a.s, a.ring, a.B, a.H, a.W,
        a.D, a.hist, a.n, a.slices, a.max_slice, a.out);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
}

template <typename T, int MODE, bool EMIT_IDX, bool SCORE, bool HIST_SMEM>
int launch_cluster(const DptScanArgs& a, cudaStream_t stream) {
    if (a.n > 1) return launch<T, MODE, EMIT_IDX, SCORE, HIST_SMEM, true>(a, stream);
    return launch<T, MODE, EMIT_IDX, SCORE, HIST_SMEM, false>(a, stream);
}

template <typename T, int MODE, bool EMIT_IDX, bool SCORE>
int launch_hist(const DptScanArgs& a, cudaStream_t stream) {
    if (a.hist_smem) return launch_cluster<T, MODE, EMIT_IDX, SCORE, true>(a, stream);
    return launch_cluster<T, MODE, EMIT_IDX, SCORE, false>(a, stream);
}

template <typename T, int MODE, bool EMIT_IDX>
int launch_search(const DptScanArgs& a, cudaStream_t stream) {
    if (a.pal_aug != nullptr) {
        // The score branch serves the packed scan's palette sizes only,
        // whichever the output.
        if (a.P > DPT_MAX_PALETTE) return (int)cudaErrorInvalidValue;
        return launch_hist<T, MODE, EMIT_IDX, true>(a, stream);
    }
    return launch_hist<T, MODE, EMIT_IDX, false>(a, stream);
}

template <typename T, int MODE>
int launch_mode(const DptScanArgs& a, cudaStream_t stream) {
    if (a.P > (a.emit_idx ? DPT_IDX_MAX_PALETTE : DPT_MAX_PALETTE)) {
        return (int)cudaErrorInvalidValue;
    }
    if (a.emit_idx) return launch_search<T, MODE, true>(a, stream);
    return launch_search<T, MODE, false>(a, stream);
}

template <typename T>
int launch_type(const DptScanArgs& a, cudaStream_t stream) {
    switch (a.mode) {
        case FIXED: return launch_mode<T, FIXED>(a, stream);
        case OSTROMOUKHOV: return launch_mode<T, OSTROMOUKHOV>(a, stream);
        case HYBRID: return launch_mode<T, HYBRID>(a, stream);
        case PERCEPTUAL: return launch_mode<T, PERCEPTUAL>(a, stream);
        case ADAPTIVE: return launch_mode<T, ADAPTIVE>(a, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

int dpt_ed_scan(const DptScanArgs& a, void* stream) {
    if (a.n < 1 || a.n > DPT_MAX_CLUSTER || (a.n & (a.n - 1)) != 0 || a.n > a.P) {
        return (int)cudaErrorInvalidValue;
    }
    if (a.slices.lo[0] != 0 || a.slices.lo[a.n] != a.P) return (int)cudaErrorInvalidValue;
    for (int r = 0; r < a.n; ++r) {
        const int len = a.slices.lo[r + 1] - a.slices.lo[r];
        if (len < 1 || len > a.max_slice) return (int)cudaErrorInvalidValue;
    }
    if (a.img_is_f32) {
        return launch_type<float>(a, (cudaStream_t)stream);
    }
    return launch_type<uint8_t>(a, (cudaStream_t)stream);
}
