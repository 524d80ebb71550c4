// K2: fixed-weight wavefront error-diffusion scan.
//
// Replaces the TPU kernel dither_pie_tpu/ops/wavefront.py
// `_build_kernel_packed` (mode "fixed", running-min search for <= 64
// colours). It computes the same function: for each wavefront step d and
// every pixel (b, y, x = d - s*y) inside the image,
//   cur  = clamp(img + c_1 + c_2 + ..., 0, 255)   left fold, consume order
//   idx  = first argmin_p (dr*dr + dg*dg) + db*db  strict <, first wins
//   err  = cur - palette[idx]
//   out  = (r << 16 | g << 8 | b) of palette[idx], truncated to int
// where c_k = err(y - dy_k, x - dx_k) * w_k is the error that entry k of
// the diffusion kernel carries in from an earlier pixel. That is the
// golden row-major engine's in-place accumulation order, so the result is
// bit-identical to dither_pie_tpu/native/ed_scan.cpp `ed_fixed_f32`.
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
//    PULLS err * w_k from its sources. The products are the same float32
//    multiplications and the fold runs in the same order, so the sums are
//    bitwise those of the push form, with one error vector stored per
//    pixel instead of one product per entry. ring is the power of two
//    >= n_slots = max(dx + s*dy) + 1: the column a source row writes in
//    the same step (x + s*dy) never aliases one that is still to be read.
//  * Rounding: every add and multiply of the fold, the distance and the
//    error uses the _rn intrinsics, and the build adds --fmad=false, so no
//    multiply-add is contracted into an FMA (the golden engine builds with
//    -ffp-contract=off).
//  * What bounds it: the serial chain of D steps and the barrier in each.
//    Per active pixel and step it does ~8*P flops of search and reads
//    3*(1 + n_e) floats that sit in L1/L2 (hist is (B, ring, 3, H): 52 KB
//    per 1080p frame for Floyd-Steinberg, ring 4; 207 KB for jjn and
//    stucki, ring 16). With one block per frame, a batch of 16 occupies
//    16 of the 132 SMs; spreading a frame's rows over more SMs is the
//    first thing to try for speed.

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

template <typename T>
__global__ void __launch_bounds__(1024)
ed_scan_fixed_kernel(const T* __restrict__ img, const float* __restrict__ pal,
                     int P, DptScanEntries e, int s, int ring, int B, int H,
                     int W, int D, float* hist, int32_t* __restrict__ out) {
    __shared__ float spal[3 * DPT_MAX_PALETTE];
    const int b = blockIdx.x;
    for (int i = threadIdx.x; i < 3 * P; i += blockDim.x) spal[i] = pal[i];
    __syncthreads();

    float* hb = hist + (int64_t)b * ring * 3 * H;
    const int64_t img_step = 3 * (int64_t)B * H;  // one step of the stream
    const int mask = ring - 1;

    for (int d = 0; d < D; ++d) {
        const T* img_d = img + d * img_step + (int64_t)b * H;
        for (int y = threadIdx.x; y < H; y += blockDim.x) {
            const int x = d - s * y;
            int32_t packed = 0;
            if (x >= 0 && x < W) {
                float cur0 = (float)img_d[y];
                float cur1 = (float)img_d[(int64_t)B * H + y];
                float cur2 = (float)img_d[2 * (int64_t)B * H + y];
#pragma unroll
                for (int k = 0; k < DPT_MAX_ENTRIES; ++k) {
                    if (k < e.n) {
                        const int ys = y - e.dy[k];
                        const int xs = x - e.dx[k];
                        if (ys >= 0 && xs >= 0 && xs < W) {
                            const float* src =
                                hb + (int64_t)((xs & mask) * 3) * H + ys;
                            const float wk = e.w[k];
                            cur0 = __fadd_rn(cur0, __fmul_rn(src[0], wk));
                            cur1 = __fadd_rn(cur1, __fmul_rn(src[H], wk));
                            cur2 = __fadd_rn(cur2, __fmul_rn(src[2 * H], wk));
                        }
                    }
                }
                // Clamp as the golden engine's clampf does.
                cur0 = cur0 < 0.f ? 0.f : (cur0 > 255.f ? 255.f : cur0);
                cur1 = cur1 < 0.f ? 0.f : (cur1 > 255.f ? 255.f : cur1);
                cur2 = cur2 < 0.f ? 0.f : (cur2 > 255.f ? 255.f : cur2);

                // Running-min palette search, first strict minimum wins.
                int best_i = 0;
                float best = 0.f;
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
                const float cr = spal[3 * best_i];
                const float cg = spal[3 * best_i + 1];
                const float cb = spal[3 * best_i + 2];
                float* dst = hb + (int64_t)((x & mask) * 3) * H + y;
                dst[0] = __fsub_rn(cur0, cr);
                dst[H] = __fsub_rn(cur1, cg);
                dst[2 * H] = __fsub_rn(cur2, cb);
                // f32 -> i32 truncates, as the TPU kernel's astype does.
                packed = ((int32_t)cr << 16) | ((int32_t)cg << 8) | (int32_t)cb;
            }
            out[((int64_t)d * B + b) * H + y] = packed;
        }
        __syncthreads();
    }
}

template <typename T>
int launch(const T* img, const float* pal, int P, DptScanEntries e, int s,
           int ring, int B, int H, int W, int D, float* hist, int32_t* out,
           void* stream) {
    int threads = ((H + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    ed_scan_fixed_kernel<T><<<B, threads, 0, (cudaStream_t)stream>>>(
        img, pal, P, e, s, ring, B, H, W, D, hist, out);
    return (int)cudaGetLastError();
}

}  // namespace

int dpt_ed_scan_fixed_u8(const uint8_t* img, const float* pal, int P,
                         DptScanEntries e, int s, int ring, int B, int H,
                         int W, int D, float* hist, int32_t* out,
                         void* stream) {
    return launch<uint8_t>(img, pal, P, e, s, ring, B, H, W, D, hist, out,
                           stream);
}

int dpt_ed_scan_fixed_f32(const float* img, const float* pal, int P,
                          DptScanEntries e, int s, int ring, int B, int H,
                          int W, int D, float* hist, int32_t* out,
                          void* stream) {
    return launch<float>(img, pal, P, e, s, ring, B, H, W, D, hist, out,
                         stream);
}
