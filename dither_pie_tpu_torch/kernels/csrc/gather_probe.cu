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
// computes table[acc & (P-1), l] by P selects; the gather with update 2
// computes the same value by one load and the same update, so the two are
// equal bit for bit and their times say what a thread's own fetch costs
// beside a sweep, which is what an exact two-stage palette search (cell ->
// candidate list -> exact refine) would trade.
//
// On the TPU a per-lane gather is one vector instruction of a kind the
// compiler lowers only when index and table have one shape. Here a thread
// owns one element (r, l) and a gather is an ordinary load at an address it
// computes; a dependent chain of k of them runs inside one launch (k is a
// runtime argument), so a timing of k = 4 + 64 m against k = 4 cancels the
// launch and the staging of the table.
//
// The gather has three forms, as the plan (tools/gather_probe.py
// `gather_slab_plan`; the launcher refuses any other) picks them by the
// table's size. Every form reads the table from shared memory:
//
// * block (the table fits one block's 227 KB whole: rows <= 454 at 128
//   lanes): one thread an element, blocks of up to 1024 threads, each block
//   staging its own copy, so the sweep's (8, 128) tile is one block on one
//   SM, the scan's situation (one block a frame). A warp's 32 lanes read 32
//   consecutive words of some row each: lane l always reads bank l mod 32,
//   so no two lanes of a warp conflict.
// * multicast (the lane slab fits one block): out[r, l] needs only lane l's
//   column, so a block serves one group of 8 lanes, 32 bytes of every row,
//   and holds the slab table[:, 8g:8g+8] (rows x 32 B, 128 KB at 4096 rows).
//   A thread-block cluster of C blocks shares one load of the slab: the
//   Tensor Memory Accelerator copies its 2D boxes (8 lanes x 256 rows,
//   from a tensor map of the table) with .multicast::cluster, each block
//   issuing every C-th box to all C blocks, so each table sector leaves L2
//   once a cluster instead of once a reading thread (from device memory a
//   warp's 32 scattered loads touched 32 sectors for 128 useful bytes). A
//   lane group's 8 blocks split its output rows and form 4 clusters of
//   C = 2, each loading the slab once: on an H100 the 64 clusters of 2 of a
//   128-lane table run in one wave, where clusters of 4 and 8 ran in two,
//   at twice the time (PERF.md).
// * distributed (the slab does not fit one block: 16384 rows are 512 KB):
//   the slab is split by rows over a cluster of 8 blocks, slab_rows (a power
//   of two) a block, each loading its own part; a gather of row q reads the
//   shared memory of block q / slab_rows through distributed shared memory,
//   its own when the row is local. On an H100 such a remote 4-byte read
//   costs about 30 times a read of the block's own shared memory a chain
//   step (PERF.md): random reads of distributed shared memory are slow.
//
// Beside the plan's forms, gather_chain_l2 runs the block form's body on
// the table where it lies in device memory (an H100's 50 MB L2 holds every
// table of the probe): the reference line, what a dependent gather costs
// where the table is not staged at all.
//
// In the slab forms a warp serves 4 output rows of 8 lanes: idx is loaded
// and out stored as whole 32-byte sectors, and a thread walks 4 output rows
// at once (4 independent chains in flight). The slab lies dense in shared
// memory (row q's 8 words at 8q), so lane l of row q reads bank
// 8 (q mod 4) + l: the 8 lanes never share a bank, and the 4 rows of a
// warp conflict only where two of them agree mod 4 (a numpy model of this
// walk in tests/test_torch_gather_slabs.py counts it). One barrier a block
// (expect-tx bytes, then the copies' completion) guards the slab; cluster
// barriers order the barriers' set-up before any copy lands and keep every
// block's shared memory alive until its peers are done with it.
//
// The sweep reads the table through a volatile pointer: every one of its P
// loads and selects is executed, none is predicated away or folded into one
// indexed load. It stages the table in shared memory where it fits and
// reads device memory above (its 1024-row table, the tool's largest).
//
// What bounds it: latency. One element's chain is k dependent loads (about
// 30 cycles each from shared memory, a few hundred from L2) with an integer
// remainder between them; the bytes (table, tile and output once) are
// microseconds of work.

#include <cassert>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include "launchers.h"

namespace cg = cooperative_groups;

namespace {

constexpr int SLAB_LANES = 8;        // lanes a slab block serves: 32 bytes of a row
constexpr int SLAB_BOX_ROWS = 256;   // rows of one TMA box (a box dimension's limit)
constexpr int SLAB_THREADS = 1024;
constexpr int SLAB_ILP = 4;          // output rows a thread walks at once
constexpr int SLAB_BLOCKS = 8;       // blocks a lane group
constexpr int SLAB_MULTICAST_CLUSTER = 2;  // blocks a cluster of the multicast form
constexpr int SLAB_ALIGN = 128;      // a TMA box's shared-memory alignment
constexpr int SLAB_BARRIER = 16;     // the mbarrier after the slab

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ const int32_t* stage_table(
    const int32_t* __restrict__ table, int32_t* stab, int n_words) {
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) stab[i] = table[i];
    __syncthreads();
    return stab;
}

// The block form: one thread an element, the table staged whole (SMEM), or
// read where it lies (the L2 line).
template <bool SMEM>
__global__ void __launch_bounds__(1024)
gather_block_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ idx,
                    int32_t* __restrict__ out, int rows, int n_el, int lanes, int k,
                    int update) {
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

// The slab forms, on clusters of C blocks. MULTICAST: the whole slab
// (slab_rows rows, the table's rows rounded up to whole boxes) in every
// block of the cluster; otherwise (distributed) rows [rank*slab_rows,
// (rank+1)*slab_rows) in block rank, slab_rows = 1 << slab_shift.
template <bool MULTICAST>
__global__ void __launch_bounds__(SLAB_THREADS, 1)
gather_slab_kernel(const __grid_constant__ CUtensorMap tmap, const int32_t* __restrict__ idx,
                   int32_t* __restrict__ out, int rows, int n, int lanes, int k, int update,
                   int slab_rows, int slab_shift, int rows_per_block, int C) {
    extern __shared__ __align__(SLAB_ALIGN) uint8_t smem_raw[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int clusters_a_group = SLAB_BLOCKS / C;
    const int cid = blockIdx.x / C;
    const int g = cid / clusters_a_group;                         // lane group
    const int bi = (cid - g * clusters_a_group) * C + rank;       // block of the group
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t pad = (SLAB_ALIGN - (raw & (SLAB_ALIGN - 1))) & (SLAB_ALIGN - 1);
    int32_t* slab = reinterpret_cast<int32_t*>(smem_raw + pad);
    const uint32_t slab_s = raw + pad;
    const uint32_t bar = slab_s + (uint32_t)slab_rows * 32u;

    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // Every block's barrier is set up before any copy can land on it.
    cluster.sync();
    if (threadIdx.x == 0) {
        const uint64_t map = reinterpret_cast<uint64_t>(&tmap);
        const int col = g * SLAB_LANES;
        const uint32_t box_bytes = SLAB_BOX_ROWS * SLAB_LANES * 4;
        if (MULTICAST) {
            // Every box lands in every block; this block issues boxes rank,
            // rank + C, ... to all of them.
            const int boxes = slab_rows / SLAB_BOX_ROWS;
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                         ::"r"(bar), "r"(boxes * box_bytes) : "memory");
            const uint16_t mask = (uint16_t)((1u << C) - 1u);
            for (int b = rank; b < boxes; b += C) {
                asm volatile(
                    "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
                    ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;"
                    ::"r"(slab_s + (uint32_t)b * box_bytes), "l"(map), "r"(bar), "h"(mask),
                      "r"(col), "r"(b * SLAB_BOX_ROWS)
                    : "memory");
            }
        } else {
            // This block's part: the boxes of its rows that start inside
            // the table.
            const int first = rank * slab_rows;
            int boxes = 0;
            while (boxes * SLAB_BOX_ROWS < slab_rows && first + boxes * SLAB_BOX_ROWS < rows) {
                ++boxes;
            }
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                         ::"r"(bar), "r"(boxes * box_bytes) : "memory");
            for (int b = 0; b < boxes; ++b) {
                asm volatile(
                    "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
                    " [%0], [%1, {%3, %4}], [%2];"
                    ::"r"(slab_s + (uint32_t)b * box_bytes), "l"(map), "r"(bar), "r"(col),
                      "r"(first + b * SLAB_BOX_ROWS)
                    : "memory");
            }
        }
    }
    wait_parity(bar, 0);
    // Distributed: every part has landed before any block reads a peer's.
    if (!MULTICAST) cluster.sync();

    const int l = threadIdx.x & (SLAB_LANES - 1);
    const int lane = g * SLAB_LANES + l;
    // A pass takes per_pass output rows (row slots), each thread SLAB_ILP of
    // them: no more slots than the block's rows fill, so that no thread
    // walks dead chains while others idle (a block of few rows runs fewer,
    // fuller threads).
    const int r0 = bi * rows_per_block;
    const int r1 = min(n, r0 + rows_per_block);
    const int per_pass = min((int)blockDim.x / SLAB_LANES,
                             (max(0, r1 - r0) + SLAB_ILP - 1) / SLAB_ILP);
    const int slot = (int)(threadIdx.x / SLAB_LANES);
    auto fetch = [&](int q) -> int {
        if (MULTICAST) return slab[q * SLAB_LANES + l];
        const int owner = q >> slab_shift;
        const int local = q & (slab_rows - 1);
        const int32_t* part = owner == rank ? slab : cluster.map_shared_rank(slab, owner);
        return part[local * SLAB_LANES + l];
    };
    const int mask = rows - 1;
    for (int base = r0 + slot; slot < per_pass && base < r1; base += per_pass * SLAB_ILP) {
        int acc[SLAB_ILP];
#pragma unroll
        for (int u = 0; u < SLAB_ILP; ++u) {
            const int r = base + u * per_pass;
            acc[u] = r < r1 ? idx[(int64_t)r * lanes + lane] : 0;
            // A start value is a row of the table (the sweep's update masks it).
            assert(update == 2 || (acc[u] >= 0 && acc[u] < rows));
        }
        if (update == 0) {
#pragma unroll
            for (int u = 0; u < SLAB_ILP; ++u) acc[u] = fetch(acc[u]);
        } else if (update == 1) {
            for (int step = 0; step < k; ++step) {
#pragma unroll
                for (int u = 0; u < SLAB_ILP; ++u) acc[u] = abs(fetch(acc[u]) + step) % rows;
            }
        } else {
            for (int step = 0; step < k; ++step) {
#pragma unroll
                for (int u = 0; u < SLAB_ILP; ++u) {
                    acc[u] = abs(fetch(acc[u] & mask) + acc[u] + step) % 255;
                }
            }
        }
#pragma unroll
        for (int u = 0; u < SLAB_ILP; ++u) {
            const int r = base + u * per_pass;
            if (r < r1) out[(int64_t)r * lanes + lane] = acc[u];
        }
    }
    // No block leaves while a peer may still read its shared memory.
    cluster.sync();
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

__global__ void empty_kernel() {}

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

// The plan the launcher would make for a (rows, lanes) table and n output
// rows; false where no form serves the shape. tools/gather_probe.py
// `gather_slab_plan` is the same function.
bool expected_plan(int rows, int n, int lanes, DptGatherPlan& p) {
    p = DptGatherPlan{};
    if (lanes % SLAB_LANES != 0) return false;
    const int64_t whole = (int64_t)rows * lanes * 4;
    if (whole <= DPT_PROBE_SMEM_BYTES) {
        const int n_el = n * lanes;
        p.form = DPT_GATHER_BLOCK;
        p.cluster = 1;
        p.threads = n_el < 1024 ? ((n_el + 31) / 32) * 32 : 1024;
        p.grid = (n_el + p.threads - 1) / p.threads;
        p.rows_per_block = (p.threads + lanes - 1) / lanes;
        p.slab_rows = rows;
        p.smem_bytes = (int)whole;
        return true;
    }
    const int groups = lanes / SLAB_LANES;
    const int boxes = (rows + SLAB_BOX_ROWS - 1) / SLAB_BOX_ROWS;
    const int64_t multicast = (int64_t)boxes * SLAB_BOX_ROWS * 32 + SLAB_ALIGN + SLAB_BARRIER;
    if (multicast <= DPT_PROBE_SMEM_BYTES) {
        p.form = DPT_GATHER_MULTICAST;
        p.cluster = SLAB_MULTICAST_CLUSTER;
        p.slab_rows = boxes * SLAB_BOX_ROWS;
        p.smem_bytes = (int)multicast;
    } else {
        int slab_rows = SLAB_BOX_ROWS;
        while ((int64_t)slab_rows * DPT_MAX_CLUSTER < rows) slab_rows *= 2;
        const int64_t part = (int64_t)slab_rows * 32 + SLAB_ALIGN + SLAB_BARRIER;
        if (part > DPT_PROBE_SMEM_BYTES) return false;
        p.form = DPT_GATHER_DISTRIBUTED;
        p.cluster = DPT_MAX_CLUSTER;
        p.slab_rows = slab_rows;
        p.smem_bytes = (int)part;
    }
    p.threads = SLAB_THREADS;
    p.rows_per_block = (n + SLAB_BLOCKS - 1) / SLAB_BLOCKS;
    p.grid = groups * SLAB_BLOCKS;
    return true;
}

// cuTensorMapEncodeTiled, looked up through the runtime
// (cudaGetDriverEntryPoint) so that nothing links libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t slab_tensor_map(const int32_t* table, int rows, int lanes, CUtensorMap* map) {
    static EncodeTiled encode = nullptr;
    if (encode == nullptr) {
        cudaDriverEntryPointQueryResult found;
        const cudaError_t rc = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault,
            &found);
        if (rc != cudaSuccess) return rc;
        if (found != cudaDriverEntryPointSuccess || encode == nullptr) {
            encode = nullptr;
            return cudaErrorSymbolNotFound;
        }
    }
    const cuuint64_t dims[2] = {(cuuint64_t)lanes, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)lanes * 4};
    const cuuint32_t box[2] = {SLAB_LANES, SLAB_BOX_ROWS};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2,
                              const_cast<int32_t*>(table), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool MULTICAST>
int launch_slab(const int32_t* table, const int32_t* idx, int32_t* out, int rows, int n,
                int lanes, int k, int update, const DptGatherPlan& p, cudaStream_t s) {
    CUtensorMap map;
    cudaError_t rc = slab_tensor_map(table, rows, lanes, &map);
    if (rc != cudaSuccess) return (int)rc;
    auto kernel = gather_slab_kernel<MULTICAST>;
    rc = allow_smem(kernel, p.smem_bytes);
    if (rc != cudaSuccess) return (int)rc;
    int shift = 0;
    while ((1 << shift) < p.slab_rows) ++shift;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.grid, 1, 1);
    cfg.blockDim = dim3(p.threads, 1, 1);
    cfg.dynamicSmemBytes = p.smem_bytes;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = cudaLaunchKernelEx(&cfg, kernel, map, idx, out, rows, n, lanes, k, update,
                            p.slab_rows, shift, p.rows_per_block, p.cluster);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
}

}  // namespace

int dpt_gather_chain(const int32_t* table, const int32_t* idx, int32_t* out,
                     int rows, int n, int lanes, int k, int update,
                     const DptGatherPlan& plan, void* stream) {
    if (bad_shape(rows, n, lanes, k) || update < 0 || update > 2 ||
        (update == 0 && k != 1) || (update == 2 && (rows & (rows - 1)))) {
        return (int)cudaErrorInvalidValue;
    }
    DptGatherPlan want;
    if (!expected_plan(rows, n, lanes, want) || plan.form != want.form ||
        plan.cluster != want.cluster || plan.rows_per_block != want.rows_per_block ||
        plan.slab_rows != want.slab_rows || plan.threads != want.threads ||
        plan.grid != want.grid || plan.smem_bytes != want.smem_bytes) {
        return (int)cudaErrorInvalidConfiguration;
    }
    cudaStream_t s = (cudaStream_t)stream;
    if (plan.form == DPT_GATHER_BLOCK) {
        const cudaError_t rc = allow_smem(gather_block_kernel<true>, plan.smem_bytes);
        if (rc != cudaSuccess) return (int)rc;
        gather_block_kernel<true><<<plan.grid, plan.threads, plan.smem_bytes, s>>>(
            table, idx, out, rows, n * lanes, lanes, k, update);
        return (int)cudaGetLastError();
    }
    // A tensor map's base lies on a 16-byte boundary.
    if (reinterpret_cast<uintptr_t>(table) % 16) return (int)cudaErrorMisalignedAddress;
    if (plan.form == DPT_GATHER_MULTICAST) {
        return launch_slab<true>(table, idx, out, rows, n, lanes, k, update, plan, s);
    }
    return launch_slab<false>(table, idx, out, rows, n, lanes, k, update, plan, s);
}

int dpt_gather_chain_l2(const int32_t* table, const int32_t* idx, int32_t* out,
                        int rows, int n, int lanes, int k, int update, void* stream) {
    if (bad_shape(rows, n, lanes, k) || update < 0 || update > 2 ||
        (update == 0 && k != 1) || (update == 2 && (rows & (rows - 1)))) {
        return (int)cudaErrorInvalidValue;
    }
    const int n_el = n * lanes;
    const int threads = n_el < 1024 ? ((n_el + 31) / 32) * 32 : 1024;
    gather_block_kernel<false><<<(n_el + threads - 1) / threads, threads, 0,
                                 (cudaStream_t)stream>>>(table, idx, out, rows, n_el, lanes, k,
                                                         update);
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

int dpt_empty_kernel(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
