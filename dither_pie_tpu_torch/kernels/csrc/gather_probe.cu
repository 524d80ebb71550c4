// T1: the gather probe, a per-lane table gather against the select sweep.
//
// Replaces the three Pallas bodies of tools/gather_probe.py:
//   (a) `kernel`        out[r, l] = table[idx[r, l], l]
//   (b) `gather_chain`  k dependent gathers, acc = |table[acc, l] + step|
//                       mod rows
//   (c) `sweep_chain`   the select sweep, the cost shape of the wavefront
//                       scan's palette search: for every one of the table's
//                       P rows best = (acc & (P-1)) == p ? table[p, l] :
//                       best, then acc = |best + acc + step| mod 255
// over a (rows, lanes) int32 table and an (n, lanes) int32 tile. The sweep
// computes table[acc & (P-1), l] by P selects; `gather_chain_kernel` with
// update 2 computes the same value by one load and the same update, so the
// two are equal bit for bit and their times say what a thread's own fetch
// costs beside a sweep, which is what an exact two-stage palette search
// (cell -> candidate list -> exact refine) would trade.
//
// On the TPU a per-lane gather is one vector instruction of a kind the
// compiler lowers only when index and table have one shape. Here a thread
// owns one element (r, l) and a gather is an ordinary load at an address it
// computes; a dependent chain of k of them runs inside one launch (k is a
// runtime argument), so a timing of k = 4 + 64 m against k = 4 cancels the
// launch and the staging of the table.
//
// Design. One thread an element, blocks of up to 1024 threads, so the
// sweep's (8, 128) tile is one block on one SM, the scan's situation (one
// block a frame). The table is staged in dynamic shared memory where it
// fits the 227 KB a block may opt in to (rows <= 454 at 128 lanes; every
// block stages its own copy), and read from device memory above that
// (8 MB at rows = 16384: resident in the 50 MB L2 after the first pass).
// In shared memory a warp's 32 lanes read 32 consecutive words of some
// row each: lane l always reads bank l mod 32, so no two lanes of a warp
// conflict. From device memory the same 32 loads touch up to 32 rows, one
// 32-byte sector each. The sweep reads the table through a volatile
// pointer: every one of its P loads and selects is executed, none is
// predicated away or folded into one indexed load.
//
// What bounds it: latency. One element's chain is k dependent loads (about
// 30 cycles each from shared memory, a few hundred from L2) with an integer
// remainder between them; the bytes (table, tile and output once) are
// microseconds of work.

#include <cassert>

#include <cuda_runtime.h>

#include "launchers.h"

namespace {

__device__ __forceinline__ const int32_t* stage_table(
    const int32_t* __restrict__ table, int32_t* stab, int n_words) {
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) stab[i] = table[i];
    __syncthreads();
    return stab;
}

template <bool SMEM>
__global__ void __launch_bounds__(1024)
gather_chain_kernel(const int32_t* __restrict__ table,
                    const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                    int rows, int n_el, int lanes, int k, int update) {
    extern __shared__ int32_t stab[];
    const int32_t* tab = table;
    if (SMEM) tab = stage_table(table, stab, rows * lanes);
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n_el) return;
    const int l = e % lanes;
    int acc = idx[e];
    // A start value is a row of the table (the sweep's update masks it).
    assert(update == 2 || (acc >= 0 && acc < rows));
    if (update == 0) {
        out[e] = tab[acc * lanes + l];
        return;
    }
    if (update == 1) {
        for (int step = 0; step < k; ++step) {
            const int g = tab[acc * lanes + l];
            acc = abs(g + step) % rows;
        }
    } else {
        const int mask = rows - 1;
        for (int step = 0; step < k; ++step) {
            const int best = tab[(acc & mask) * lanes + l];
            acc = abs(best + acc + step) % 255;
        }
    }
    out[e] = acc;
}

template <bool SMEM>
__global__ void __launch_bounds__(1024)
sweep_chain_kernel(const int32_t* table, const int32_t* __restrict__ idx,
                   int32_t* __restrict__ out, int rows, int n_el, int lanes,
                   int k) {
    extern __shared__ int32_t stab[];
    const int32_t* tab = table;
    if (SMEM) tab = stage_table(table, stab, rows * lanes);
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n_el) return;
    const volatile int32_t* column = tab + e % lanes;
    const int mask = rows - 1;
    int acc = idx[e];
    for (int step = 0; step < k; ++step) {
        const int key = acc & mask;
        int best = 0;
        for (int p = 0; p < rows; ++p) {
            const int v = column[p * lanes];
            best = key == p ? v : best;
        }
        acc = abs(best + acc + step) % 255;
    }
    out[e] = acc;
}

bool bad_shape(int rows, int n, int lanes, int k) {
    return rows < 1 || n < 1 || lanes < 1 || k < 1 ||
           (int64_t)rows * lanes >= (int64_t(1) << 31) ||
           (int64_t)n * lanes >= (int64_t(1) << 31);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

int dpt_gather_chain(const int32_t* table, const int32_t* idx, int32_t* out,
                     int rows, int n, int lanes, int k, int update,
                     int use_smem, void* stream) {
    if (bad_shape(rows, n, lanes, k) || update < 0 || update > 2 ||
        (update == 0 && k != 1) || (update == 2 && (rows & (rows - 1)))) {
        return (int)cudaErrorInvalidValue;
    }
    const int n_el = n * lanes;
    const int threads = n_el < 1024 ? ((n_el + 31) / 32) * 32 : 1024;
    const int blocks = (n_el + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (use_smem) {
        const size_t bytes = (size_t)rows * lanes * sizeof(int32_t);
        if (bytes > DPT_PROBE_SMEM_BYTES) return (int)cudaErrorInvalidValue;
        const cudaError_t rc = allow_smem(gather_chain_kernel<true>, bytes);
        if (rc != cudaSuccess) return (int)rc;
        gather_chain_kernel<true><<<blocks, threads, bytes, s>>>(
            table, idx, out, rows, n_el, lanes, k, update);
    } else {
        gather_chain_kernel<false><<<blocks, threads, 0, s>>>(
            table, idx, out, rows, n_el, lanes, k, update);
    }
    return (int)cudaGetLastError();
}

int dpt_sweep_chain(const int32_t* table, const int32_t* idx, int32_t* out,
                    int rows, int n, int lanes, int k, int use_smem,
                    void* stream) {
    if (bad_shape(rows, n, lanes, k) || (rows & (rows - 1))) {
        return (int)cudaErrorInvalidValue;
    }
    const int n_el = n * lanes;
    const int threads = n_el < 1024 ? ((n_el + 31) / 32) * 32 : 1024;
    const int blocks = (n_el + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (use_smem) {
        const size_t bytes = (size_t)rows * lanes * sizeof(int32_t);
        if (bytes > DPT_PROBE_SMEM_BYTES) return (int)cudaErrorInvalidValue;
        const cudaError_t rc = allow_smem(sweep_chain_kernel<true>, bytes);
        if (rc != cudaSuccess) return (int)rc;
        sweep_chain_kernel<true><<<blocks, threads, bytes, s>>>(
            table, idx, out, rows, n_el, lanes, k);
    } else {
        sweep_chain_kernel<false><<<blocks, threads, 0, s>>>(
            table, idx, out, rows, n_el, lanes, k);
    }
    return (int)cudaGetLastError();
}
