// T2: the dense palette search on its own, exact sweep against score form.
//
// Replaces the two Pallas bodies of tools/proto_mxu_search.py
// (`exact_kernel`, `mxu_kernel`): over a synthetic working tile cur
// (3*nb, lf) float32, row c*nb + b holding channel c of frame b, pick for
// every (b, lane) a palette index, and do so `iters` times over, as the
// scan does once a wavefront step:
//   exact  first strict minimum over p of (dr*dr + dg*dg) + db*db,
//          d = cur - palette[p], palette (pp, 3)
//   score  first strict maximum over p of ((r*x_r + g*x_g) + b*x_b) + n,
//          palette (pp, 4) rows [r, g, b, n = -0.5*((r*r + g*g) + b*b)]
// The TPU probe's score form is one (pp, 4) @ (4, lf) matrix product a
// frame; this one scores on the CUDA cores with each product and sum
// rounded on its own (_rn intrinsics, --fmad=false), the function that the
// scan's score branch (ed_scan.cu) computes, so the flip fraction of score
// against exact that the probe reports is the scan's.
//
// Shape: the scan's. One block per frame b (the scan runs one block a
// frame), its threads over the lf lanes, the palette in shared memory, a
// block-wide barrier per repetition as the scan has per step. The tile is
// read through a volatile pointer so that every repetition loads and
// searches again instead of being hoisted out of the loop.
//
// What bounds it: operations. 8 (exact) or 7 (score) float32 operations a
// colour and lane, a compare and two selects beside them, on nb of the
// card's 132 SMs.

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

template <bool SCORE>
__global__ void __launch_bounds__(1024)
search_probe_kernel(const float* cur, const float* __restrict__ pal, int pp,
                    int nb, int lf, int iters, int32_t* out) {
    constexpr int PC = SCORE ? 4 : 3;
    extern __shared__ __align__(16) float spal[];
    for (int i = threadIdx.x; i < PC * pp; i += blockDim.x) spal[i] = pal[i];
    __syncthreads();
    const int b = blockIdx.x;
    const volatile float* tile = cur;
    for (int it = 0; it < iters; ++it) {
        for (int lane = threadIdx.x; lane < lf; lane += blockDim.x) {
            const float x0 = tile[(int64_t)b * lf + lane];
            const float x1 = tile[(int64_t)(nb + b) * lf + lane];
            const float x2 = tile[(int64_t)(2 * nb + b) * lf + lane];
            int best_i = 0;
            float best = 0.f;
            if (SCORE) {
                const float4* spal4 = reinterpret_cast<const float4*>(spal);
                for (int p = 0; p < pp; ++p) {
                    const float4 c = spal4[p];
                    const float score = __fadd_rn(
                        __fadd_rn(__fadd_rn(__fmul_rn(c.x, x0),
                                            __fmul_rn(c.y, x1)),
                                  __fmul_rn(c.z, x2)),
                        c.w);
                    if (p == 0 || score > best) {
                        best = score;
                        best_i = p;
                    }
                }
            } else {
                for (int p = 0; p < pp; ++p) {
                    const float dr = __fsub_rn(x0, spal[3 * p]);
                    const float dg = __fsub_rn(x1, spal[3 * p + 1]);
                    const float db = __fsub_rn(x2, spal[3 * p + 2]);
                    const float dist = __fadd_rn(
                        __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dg, dg)),
                        __fmul_rn(db, db));
                    if (p == 0 || dist < best) {
                        best = dist;
                        best_i = p;
                    }
                }
            }
            out[(int64_t)b * lf + lane] = best_i;
        }
        __syncthreads();
    }
}

template <bool SCORE>
int launch(const float* cur, const float* pal, int pp, int nb, int lf,
           int iters, int32_t* out, cudaStream_t stream) {
    int threads = ((lf + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    const size_t smem_bytes = (SCORE ? 4 : 3) * (size_t)pp * sizeof(float);
    search_probe_kernel<SCORE><<<nb, threads, smem_bytes, stream>>>(
        cur, pal, pp, nb, lf, iters, out);
    return (int)cudaGetLastError();
}

}  // namespace

int dpt_search_probe(const float* cur, const float* pal, int pp, int nb,
                     int lf, int iters, int score, int32_t* out,
                     void* stream) {
    if (pp < 1 || pp > DPT_PROBE_MAX_PALETTE || nb < 1 || lf < 1 || iters < 1) {
        return (int)cudaErrorInvalidValue;
    }
    if (score) {
        return launch<true>(cur, pal, pp, nb, lf, iters, out,
                            (cudaStream_t)stream);
    }
    return launch<false>(cur, pal, pp, nb, lf, iters, out, (cudaStream_t)stream);
}
