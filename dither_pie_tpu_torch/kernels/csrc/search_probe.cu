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
// Shape: the scan's step (ed_scan.cu), without the fold and the error.
//  * One frame over a thread-block cluster of n blocks (n in {1, 2, 4, 8};
//    grid nb*n, frame blockIdx.x / n, rank cluster.block_rank()), n and
//    the slices from the scan's own plan (ops/wavefront.py
//    `cluster_size_for`, `palette_slices`); every block covers all of the
//    frame's lanes as the scan's blocks cover its rows (lane = tid, tid +
//    blockDim, ..., at most 1024 threads).
//  * Rank r searches its contiguous slice [lo_r, lo_{r+1}), packed from
//    index 0 in shared memory (12 bytes a colour, 16 for the score form),
//    with the strict running minimum (or the score's strict maximum, key =
//    the negated score), and writes (key, index) of every lane into its
//    shared memory, double-buffered by the parity of the repetition. After
//    one cluster barrier it reads its peers' candidates through
//    distributed shared memory in rank order and keeps the first strict
//    minimum: the single sweep's pick, ties included. Rank r writes `out`
//    for the lanes = r (mod n) only. A last cluster barrier keeps shared
//    memory alive until the peers have read it. n = 1 compiles to the
//    single block's loop, with no merge.
//  * A block-wide barrier ends every repetition, as it ends the scan's
//    step. The tile is read through a volatile pointer so that every
//    repetition loads and searches again instead of being hoisted out of
//    the loop.
//
// What bounds it: operations. 8 (exact) or 6 (score) float32 operations a
// colour and lane, a compare and two selects beside them; a repetition
// costs about c_n + k*P/n, as the scan's step (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launchers.h"
#include "palette_search.cuh"

namespace cg = cooperative_groups;

namespace {

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Floats of the dynamic shared memory: the slice, then (n > 1) the
// candidates, two buffers of (key, index) a lane.
__host__ __device__ inline int smem_floats(bool score, int max_slice, int n, int lf) {
    return round4((score ? 4 : 3) * max_slice) + (n > 1 ? 4 * lf : 0);
}

template <bool SCORE, bool CLUSTER>
__global__ void __launch_bounds__(1024, 1)
search_probe_kernel(const float* cur, const float* __restrict__ pal, int nb,
                    int lf, int iters, int n, DptSlices sl, int max_slice,
                    int32_t* __restrict__ out) {
    constexpr int PC = SCORE ? 4 : 3;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = CLUSTER ? (int)cluster.block_rank() : 0;
    const int b = CLUSTER ? blockIdx.x / n : blockIdx.x;
    // The rank's slice, read without indexing the parameter array by a
    // register (which would copy it to local memory).
    int lo = sl.lo[0], hi = sl.lo[1];
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
    float* sslice = smem;
    float2* cand = reinterpret_cast<float2*>(smem + round4(PC * max_slice));
    const int tid = threadIdx.x, bd = blockDim.x;
    for (int i = tid; i < PC * len; i += bd) sslice[i] = pal[PC * lo + i];
    __syncthreads();

    const volatile float* tile = cur;
    int32_t* out_b = out + (int64_t)b * lf;
    for (int it = 0; it < iters; ++it) {
        float2* cand_it = cand + (it & 1) * lf;
        for (int lane = tid; lane < lf; lane += bd) {
            const float x0 = tile[(int64_t)b * lf + lane];
            const float x1 = tile[(int64_t)(nb + b) * lf + lane];
            const float x2 = tile[(int64_t)(2 * nb + b) * lf + lane];
            float key;
            const int i = dpt_palette_search<SCORE>(sslice, len, x0, x1, x2, key);
            if (CLUSTER) {
                cand_it[lane] = make_float2(key, __int_as_float(lo + i));
            } else {
                out_b[lane] = i;
            }
        }
        if (CLUSTER) {
            // Candidates written; the peers' become visible.
            cluster.sync();
            for (int lane = tid; lane < lf; lane += bd) {
                // First strict winner in rank order: the slices are
                // contiguous and ascending, so ties keep the lower index.
                float2 c[DPT_MAX_CLUSTER];
#pragma unroll
                for (int q = 0; q < DPT_MAX_CLUSTER; ++q) {
                    if (q < n) c[q] = *cluster.map_shared_rank(cand_it + lane, q);
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
                if ((lane & (n - 1)) == rank) out_b[lane] = best_i;
            }
        }
        __syncthreads();
    }
    // No block leaves while a peer may still read its candidates.
    if (CLUSTER) cluster.sync();
}

template <bool SCORE, bool CLUSTER>
int launch(const float* cur, const float* pal, int nb, int lf, int iters,
           int n, const DptSlices& sl, int max_slice, int32_t* out,
           cudaStream_t stream) {
    auto kernel = search_probe_kernel<SCORE, CLUSTER>;
    const size_t smem_bytes = (size_t)smem_floats(SCORE, max_slice, n, lf) * sizeof(float);
    if (smem_bytes > (size_t)DPT_SMEM_BYTES) return (int)cudaErrorInvalidValue;
    if (smem_bytes > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
        if (rc != cudaSuccess) return (int)rc;
    }
    int threads = ((lf + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nb * n, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, cur, pal, nb, lf,
                                              iters, n, sl, max_slice, out);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
}

template <bool SCORE>
int launch_cluster(const float* cur, const float* pal, int nb, int lf, int iters,
                   int n, const DptSlices& sl, int max_slice, int32_t* out,
                   cudaStream_t stream) {
    if (n > 1) return launch<SCORE, true>(cur, pal, nb, lf, iters, n, sl, max_slice, out, stream);
    return launch<SCORE, false>(cur, pal, nb, lf, iters, n, sl, max_slice, out, stream);
}

}  // namespace

int dpt_search_probe(const float* cur, const float* pal, int pp, int nb,
                     int lf, int iters, int score, int n, const DptSlices& sl,
                     int32_t* out, void* stream) {
    if (pp < 1 || pp > DPT_PROBE_MAX_PALETTE || nb < 1 || lf < 1 || iters < 1 ||
        n < 1 || n > DPT_MAX_CLUSTER || (n & (n - 1)) != 0 || n > pp) {
        return (int)cudaErrorInvalidValue;
    }
    if (sl.lo[0] != 0 || sl.lo[n] != pp) return (int)cudaErrorInvalidValue;
    int max_slice = 0;
    for (int r = 0; r < n; ++r) {
        const int len = sl.lo[r + 1] - sl.lo[r];
        if (len < 1) return (int)cudaErrorInvalidValue;
        if (len > max_slice) max_slice = len;
    }
    if (score) {
        return launch_cluster<true>(cur, pal, nb, lf, iters, n, sl, max_slice, out,
                                    (cudaStream_t)stream);
    }
    return launch_cluster<false>(cur, pal, nb, lf, iters, n, sl, max_slice, out,
                                 (cudaStream_t)stream);
}
