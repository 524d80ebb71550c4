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
// Design.
//  * One block per frame; its threads own the frame's rows (y = tid,
//    tid + blockDim, ...) and loop over the D = W + s*(H-1) steps with one
//    __syncthreads() per step, because row y at step d reads what rows
//    y-1 and y-2 wrote at earlier steps. The TPU's sequential grid over d
//    becomes this loop inside the block.
//  * The TPU kernel PUSHES each error times each weight into one ring per
//    entry and folds the rings at consume time. Here each row keeps its
//    last `ring` errors (hist, indexed by column mod ring) and each pixel
//    PULLS f * w_k from its sources. The products are the same float32
//    multiplications and the fold runs in the same order, so the sums are
//    bitwise those of the push form, with one vector stored per pixel
//    instead of one product per entry. hist holds f, the error AFTER the
//    mode's transform (projection, gate); for perceptual and ostromoukhov,
//    whose weights belong to the source pixel, a fourth float beside it
//    holds the source's sensitivity or its luminance index. ring is the
//    power of two >= n_slots = max(dx + s*dy) + 1: the column a source row
//    writes in the same step (x + s*dy) never aliases one that is still to
//    be read.
//  * The mode, the input type and the output are template parameters,
//    decided outside the step loop: the fixed mode's loop is the code it
//    had before the other modes arrived.
//  * The search is the running minimum over the palette for any P (the
//    TPU's bit-reversed tournament computes the same first strict minimum
//    for a whole tile at once). The palette sits in dynamic shared memory:
//    12 KB at 1024 colours; K8 opts in to more than 48 KB, up to the
//    192 KB of DPT_IDX_MAX_PALETTE colours.
//  * The score branch (template flag SCORE) replaces the TPU kernel's
//    `mxu_dense` branch, a (pp, 8) @ (8, lf) matrix product per step whose
//    column maximum is the pick: argmin |x - c|^2 = argmax c.x - |c|^2/2.
//    Here the augmented palette [r, g, b, n] sits in shared memory as one
//    float4 a colour (16 KB at 1024 colours) and each thread keeps the
//    running maximum of its own pixel's scores on the CUDA cores: three
//    multiplies and three adds a colour in the order written above, each
//    rounded on its own, so the pick equals the plain version's bit for
//    bit. It is a different function from the exact sweep (two colours
//    whose distances differ can tie or swap once rounded as scores), so it
//    runs only where the caller asks for it, for 64 < P <= DPT_MAX_PALETTE,
//    in every mode and for both outputs. A tensor-core form (mma.sync
//    m16n8k8 TF32 with a hi/lo split of n_p and the working value) is the
//    later step; this one fixes the function it must reproduce.
//  * Ostromoukhov's (256, 3) weight table sits in shared memory and a
//    thread indexes it (the TPU's halving-tree walk was its missing gather).
//  * The aux map of perceptual and adaptive is read in place,
//    aux[b, y, d - s*y]: neighbouring threads are W - s floats apart, so a
//    step touches one 32-byte sector per row, which the next 7 steps of the
//    row find in L1/L2. The TPU sent it through its skew kernel instead.
//  * Rounding: every add and multiply of the fold, the distance, the error
//    and the mode's transform uses the _rn intrinsics, and the build adds
//    --fmad=false, so no multiply-add is contracted into an FMA (the golden
//    engine builds with -ffp-contract=off).
//  * What bounds it: the serial chain of D steps; each step is the barrier
//    plus the search, a few instructions per colour and row, which one SM
//    runs for the whole frame, so the time grows linearly with P. With one
//    block per frame, a batch of 16 occupies 16 of the 132 SMs; spreading a
//    frame's rows over more SMs is the first thing to try for speed.

#include <cuda_runtime.h>

#include "launchers.h"

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

template <typename T, int MODE, bool EMIT_IDX, bool SCORE>
__global__ void __launch_bounds__(1024)
ed_scan_kernel(const T* __restrict__ img, const float* __restrict__ pal, int P,
               DptScanEntries e, const float* __restrict__ aux,
               const float* __restrict__ lut, float lum_factor,
               float col_factor, int s, int ring, int B, int H, int W, int D,
               float* hist, int32_t* __restrict__ out) {
    // Floats per pixel of hist, and whether the search sees a clamped value.
    constexpr int C = (MODE == OSTROMOUKHOV || MODE == PERCEPTUAL) ? 4 : 3;
    constexpr bool CLAMP = MODE == FIXED || MODE == OSTROMOUKHOV || MODE == HYBRID;
    constexpr bool HAS_AUX = MODE == PERCEPTUAL || MODE == ADAPTIVE;

    // Floats a colour of the palette: (r, g, b), or with the score branch
    // the augmented (r, g, b, n).
    constexpr int PC = SCORE ? 4 : 3;

    // Dynamic shared memory: the weight table (ostromoukhov, 3072 bytes, a
    // multiple of 16), then the palette.
    extern __shared__ __align__(16) float smem[];
    float* slut = smem;
    float* spal = smem + (MODE == OSTROMOUKHOV ? LUT_FLOATS : 0);
    const int b = blockIdx.x;
    if (MODE == OSTROMOUKHOV) {
        for (int i = threadIdx.x; i < LUT_FLOATS; i += blockDim.x) slut[i] = lut[i];
    }
    for (int i = threadIdx.x; i < PC * P; i += blockDim.x) spal[i] = pal[i];
    __syncthreads();

    float* hb = hist + (int64_t)b * ring * C * H;
    const int64_t img_step = 3 * (int64_t)B * H;  // one step of the stream
    const int mask = ring - 1;

    for (int d = 0; d < D; ++d) {
        const T* img_d = img + d * img_step + (int64_t)b * H;
        for (int y = threadIdx.x; y < H; y += blockDim.x) {
            const int x = d - s * y;
            int32_t result = 0;
            if (x >= 0 && x < W) {
                float cur0 = (float)img_d[y];
                float cur1 = (float)img_d[(int64_t)B * H + y];
                float cur2 = (float)img_d[2 * (int64_t)B * H + y];
                float a = 0.f;  // this pixel's sensitivity or gate
                if (HAS_AUX) a = aux[((int64_t)b * H + y) * W + x];
#pragma unroll
                for (int k = 0; k < DPT_MAX_ENTRIES; ++k) {
                    if (k < e.n) {
                        const int ys = y - e.dy[k];
                        const int xs = x - e.dx[k];
                        if (ys >= 0 && xs >= 0 && xs < W) {
                            const float* src =
                                hb + (int64_t)((xs & mask) * C) * H + ys;
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
                if (CLAMP) {
                    cur0 = clamp255(cur0);
                    cur1 = clamp255(cur1);
                    cur2 = clamp255(cur2);
                }

                int best_i = 0;
                float best = 0.f;
                if (SCORE) {
                    // Running-max score search, first strict maximum wins.
                    const float4* spal4 = reinterpret_cast<const float4*>(spal);
                    for (int p = 0; p < P; ++p) {
                        const float4 c = spal4[p];
                        const float score = __fadd_rn(
                            __fadd_rn(__fadd_rn(__fmul_rn(c.x, cur0),
                                                __fmul_rn(c.y, cur1)),
                                      __fmul_rn(c.z, cur2)),
                            c.w);
                        if (p == 0 || score > best) {
                            best = score;
                            best_i = p;
                        }
                    }
                } else {
                    // Running-min palette search, first strict minimum wins.
                    for (int p = 0; p < P; ++p) {
                        const float dr = __fsub_rn(cur0, spal[3 * p]);
                        const float dg = __fsub_rn(cur1, spal[3 * p + 1]);
                        const float db = __fsub_rn(cur2, spal[3 * p + 2]);
                        const float dist = __fadd_rn(
                            __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dg, dg)),
                            __fmul_rn(db, db));
                        if (p == 0 || dist < best) {
                            best = dist;
                            best_i = p;
                        }
                    }
                }
                const float cr = spal[PC * best_i];
                const float cg = spal[PC * best_i + 1];
                const float cb = spal[PC * best_i + 2];
                float e0 = __fsub_rn(cur0, cr);
                float e1 = __fsub_rn(cur1, cg);
                float e2 = __fsub_rn(cur2, cb);
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
                float* dst = hb + (int64_t)((x & mask) * C) * H + y;
                dst[0] = e0;
                dst[H] = e1;
                dst[2 * H] = e2;
                if (MODE == PERCEPTUAL) {
                    dst[3 * H] = a;
                } else if (MODE == OSTROMOUKHOV) {
                    // Luminance of the clamped pixel, clamped, truncated.
                    dst[3 * H] = __int_as_float(
                        (int)clamp255(luma(cur0, cur1, cur2)));
                }
                if (EMIT_IDX) {
                    result = best_i;
                } else {
                    // f32 -> i32 truncates, as the TPU kernel's astype does.
                    result = ((int32_t)cr << 16) | ((int32_t)cg << 8) | (int32_t)cb;
                }
            }
            out[((int64_t)d * B + b) * H + y] = result;
        }
        __syncthreads();
    }
}

template <typename T, int MODE, bool EMIT_IDX, bool SCORE>
int launch(const DptScanArgs& a, size_t smem_bytes, cudaStream_t stream) {
    auto kernel = ed_scan_kernel<T, MODE, EMIT_IDX, SCORE>;
    if (smem_bytes > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
        if (rc != cudaSuccess) return (int)rc;
    }
    int threads = ((a.H + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    kernel<<<a.B, threads, smem_bytes, stream>>>(
        (const T*)a.img, SCORE ? a.pal_aug : a.pal, a.P, a.e, a.aux, a.lut,
        a.lum_factor, a.col_factor, a.s, a.ring, a.B, a.H, a.W, a.D, a.hist,
        a.out);
    return (int)cudaGetLastError();
}

template <typename T, int MODE, bool EMIT_IDX>
int launch_search(const DptScanArgs& a, cudaStream_t stream) {
    const size_t lut_bytes = MODE == OSTROMOUKHOV ? LUT_FLOATS * sizeof(float) : 0;
    if (a.pal_aug != nullptr) {
        // The score branch holds 16 bytes a colour, and serves the packed
        // scan's palette sizes only, whichever the output.
        if (a.P > DPT_MAX_PALETTE) return (int)cudaErrorInvalidValue;
        return launch<T, MODE, EMIT_IDX, true>(
            a, lut_bytes + 4 * (size_t)a.P * sizeof(float), stream);
    }
    return launch<T, MODE, EMIT_IDX, false>(
        a, lut_bytes + 3 * (size_t)a.P * sizeof(float), stream);
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
    if (a.img_is_f32) {
        return launch_type<float>(a, (cudaStream_t)stream);
    }
    return launch_type<uint8_t>(a, (cudaStream_t)stream);
}
