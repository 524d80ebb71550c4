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
// The gather has four forms, as the plan (tools/gather_probe.py
// `gather_slab_plan`) picks them by the chain's length and the table's
// height:
//
// * device (every single gather, k = 1, at every height, and every chain
//   shorter than the staged form's break-even): one thread an element,
//   blocks of up to 1024 threads, the table read where it lies in device
//   memory (an H100's 50 MB L2 holds every table of the probe). Staging
//   cannot pay for one read: at 4096 rows a block would stage 128 KB to
//   produce 16 KB of output. A staged form costs a fixed time (its fill)
//   and saves a time a step, so below a chain length (STAGE_BANDS: the
//   break-even of the whole launch measured on an H100 by table height,
//   PERF.md) the device form is the faster launch.
// * block (chains; the table fits one block's 227 KB whole: rows <= 454 at
//   128 lanes): the same walk with each block staging its own copy, so the
//   sweep's (8, 128) tile is one block on one SM, the scan's situation (one
//   block a frame). A warp's 32 lanes read 32 consecutive words of some row
//   each: lane l always reads bank l mod 32, so no two lanes of a warp
//   conflict.
// * multicast (chains; the lane slab fits one block: to 7168 rows):
//   out[r, l] needs only lane l's column, so a block serves one group of 8
//   lanes, 32 bytes of every row, and holds the slab table[:, 8g:8g+8]
//   (rows x 32 B, 128 KB at 4096 rows). A thread-block cluster of C blocks
//   shares one load of the slab: the Tensor Memory Accelerator copies its
//   2D boxes (8 lanes x 256 rows, from a tensor map of the table) with
//   .multicast::cluster, each block issuing every C-th box to all C blocks,
//   so each table sector leaves L2 once a cluster instead of once a reading
//   thread. A lane group's 8 blocks split its output rows and form 4
//   clusters of C = 2, each loading the slab once: on an H100 the 64
//   clusters of 2 of a 128-lane table run in one wave, where clusters of 4
//   and 8 ran in two, at twice the time (PERF.md). Each thread loads the
//   start values of its first rows before it waits for the slab.
// * column (chains; 7169 to 32768 rows): a block serves one lane and holds
//   that lane's column (64 KB at 16384 rows, 128 KB at 32768), so every
//   fetch is a read of the block's own shared memory. The slab of 8 lanes
//   no longer fits a block there, and splitting it over a cluster made
//   every fetch a read of distributed shared memory, about 30 times a
//   local read on an H100 (PERF.md). The column fills by ordinary loads of
//   the row-major table: a warp reads 32 rows' words of one lane, 32
//   sectors for 128 useful bytes, and each of the 8 blocks of a lane group
//   reads the same sectors. (A TMA tensor box cannot take one lane: its
//   inner extent is 16 bytes at least. One bulk copy of a lane-major copy
//   of the table ran its gathers 7 % faster on an H100, but its launch,
//   with the transpose, 10 us slower at 16384 rows: it paid only past
//   about 125 steps, PERF.md.) A thread walks 4 output rows at once, rows
//   of one lane: idx and out are read and written a word a sector, most of
//   a short chain's time at 16384 rows.
//
// The device form at any k is also the probe's L2 line (gather_chain_l2):
// what a dependent gather costs where the table is not staged at all, the
// launch a staged form must beat. The launcher takes it at any k, and
// every other plan only where the plan function gives it.
//
// In the multicast form a warp serves 4 output rows of 8 lanes: idx is
// loaded and out stored as whole 32-byte sectors, and a thread walks 4
// output rows at once (4 independent chains in flight). The slab lies
// dense in shared memory (row q's 8 words at 8q), so lane l of row q reads
// bank 8 (q mod 4) + l: the 8 lanes never share a bank, and the 4 rows of a
// warp conflict only where two of them agree mod 4. In the column form row
// q lies in bank q mod 32, and a warp's 32 random rows conflict as 32
// random draws of 32 banks (a numpy model of both walks in
// tests/test_torch_gather_slabs.py counts it). One barrier a block
// (expect-tx bytes, then the copies' completion) guards a slab; cluster
// barriers order the multicast barriers' set-up before any copy lands and
// keep every block's shared memory alive until its peers are done with it.
//
// The sweep reads the table through a volatile pointer: every one of its P
// loads and selects is executed, none is predicated away or folded into one
// indexed load. It stages the table in shared memory where it fits and
// reads device memory above (its 1024-row table, the tool's largest).
//
// What bounds it: latency. One element's chain is k dependent loads (about
// 30 cycles each from shared memory, a few hundred from L2) with an integer
// remainder between them; the bytes (table, tile and output once) are
// microseconds of work. The single gather alone is bound by its bytes.

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
constexpr int COLUMN_MAX_ROWS = 32768;  // 128 KB a column
// The shortest chain a staged form is taken for, by table height: bands of
// (form, the band's last table row, its shortest chain), where the staged
// form's launch beat the L2 line's on an H100 (tools/gather_probe.py
// STAGE_BANDS says how each was measured; PERF.md); below it the device
// form's launch is the faster.
constexpr int ANY_ROWS = 1 << 30;
struct StageBand {
    int form, last_row, min_k;
};
constexpr StageBand STAGE_BANDS[] = {{DPT_GATHER_BLOCK, 256, 85},
                                     {DPT_GATHER_BLOCK, ANY_ROWS, 138},
                                     {DPT_GATHER_MULTICAST, 1023, 18},
                                     {DPT_GATHER_MULTICAST, 4095, 4},
                                     {DPT_GATHER_MULTICAST, ANY_ROWS, 2},
                                     {DPT_GATHER_COLUMN, ANY_ROWS, 4}};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ const int32_t* stage_table(
    const int32_t* __restrict__ table, int32_t* stab, int n_words) {
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) stab[i] = table[i];
    __syncthreads();
    return stab;
}

// The device and block forms: one thread an element, the table read where
// it lies (device, the L2 line) or staged whole (SMEM).
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

// The start values of rows base, base + per_pass, ... (0 past r1).
__device__ __forceinline__ void load_starts(const int32_t* __restrict__ idx, int rows,
                                            int lanes, int lane, int update, int base, int r1,
                                            int per_pass, int (&acc)[SLAB_ILP]) {
#pragma unroll
    for (int u = 0; u < SLAB_ILP; ++u) {
        const int r = base + u * per_pass;
        acc[u] = r < r1 ? idx[(int64_t)r * lanes + lane] : 0;
        // A start value is a row of the table (the sweep's update masks it).
        assert(update == 2 || (acc[u] >= 0 && acc[u] < rows));
    }
}

// A thread's walk over its output rows in the staged forms (chains, update
// 1 or 2; a single gather takes the device form): rows base,
// base + per_pass, ..., 4 at once (4 independent chains), then base +
// 4 per_pass, ...; start values of row r from idx[r * lanes + lane], the
// fetch of table row q from `fetch(q)`. On entry `acc` holds the start
// values of the thread's first 4 rows, loaded before the table was staged.
template <typename Fetch>
__device__ __forceinline__ void walk_rows(const int32_t* __restrict__ idx,
                                          int32_t* __restrict__ out, int rows, int lanes,
                                          int lane, int k, int update, int base, int r1,
                                          int per_pass, int (&acc)[SLAB_ILP], Fetch fetch) {
    const int mask = rows - 1;
    for (;;) {
        if (update == 1) {
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
        base += per_pass * SLAB_ILP;
        if (base >= r1) return;
        load_starts(idx, rows, lanes, lane, update, base, r1, per_pass, acc);
    }
}

// The multicast form, on clusters of SLAB_MULTICAST_CLUSTER blocks: the
// whole slab (slab_rows rows, the table's rows rounded up to whole boxes)
// in every block of the cluster.
__global__ void __launch_bounds__(SLAB_THREADS, 1)
gather_multicast_kernel(const __grid_constant__ CUtensorMap tmap,
                        const int32_t* __restrict__ idx, int32_t* __restrict__ out, int rows,
                        int n, int lanes, int k, int update, int slab_rows, int rows_per_block) {
    constexpr int C = SLAB_MULTICAST_CLUSTER;
    extern __shared__ __align__(SLAB_ALIGN) uint8_t smem_raw[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int clusters_a_group = SLAB_BLOCKS / C;
    const int cid = blockIdx.x / C;
    const int g = cid / clusters_a_group;                         // lane group
    const int bi = (cid - g * clusters_a_group) * C + rank;       // block of the group
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t pad = (SLAB_ALIGN - (raw & (SLAB_ALIGN - 1))) & (SLAB_ALIGN - 1);
    const int32_t* slab = reinterpret_cast<const int32_t*>(smem_raw + pad);
    const uint32_t slab_s = raw + pad;
    const uint32_t bar = slab_s + (uint32_t)slab_rows * 32u;

    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // Every block's barrier is set up before any copy can land on it.
    cluster.sync();
    if (threadIdx.x == 0) {
        // Every box lands in every block; this block issues boxes rank,
        // rank + C, ... to all of them.
        const uint64_t map = reinterpret_cast<uint64_t>(&tmap);
        const int col = g * SLAB_LANES;
        const uint32_t box_bytes = SLAB_BOX_ROWS * SLAB_LANES * 4;
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
    }

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
    const bool mine = slot < per_pass && r0 + slot < r1;
    int acc[SLAB_ILP];
    // The first start values load while the slab lands.
    if (mine) load_starts(idx, rows, lanes, lane, update, r0 + slot, r1, per_pass, acc);
    wait_parity(bar, 0);
    if (mine) {
        walk_rows(idx, out, rows, lanes, lane, k, update, r0 + slot, r1, per_pass, acc,
                  [&](int q) { return slab[q * SLAB_LANES + l]; });
    }
    // No block leaves while a peer's copies may still land in it.
    cluster.sync();
}

// The column form: block b serves lane b, its column (rows words) in
// shared memory, filled by loads of the row-major table.
__global__ void __launch_bounds__(SLAB_THREADS, 1)
gather_column_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ idx,
                     int32_t* __restrict__ out, int rows, int n, int lanes, int k,
                     int update) {
    extern __shared__ int32_t column[];
    const int lane = blockIdx.x;
#pragma unroll 8
    for (int q = threadIdx.x; q < rows; q += blockDim.x) {
        column[q] = table[(int64_t)q * lanes + lane];
    }
    const int per_pass = min((int)blockDim.x, (n + SLAB_ILP - 1) / SLAB_ILP);
    const int slot = (int)threadIdx.x;
    const bool mine = slot < per_pass;
    int acc[SLAB_ILP];
    // The first start values load while the column fills.
    if (mine) load_starts(idx, rows, lanes, lane, update, slot, n, per_pass, acc);
    __syncthreads();
    if (mine) {
        walk_rows(idx, out, rows, lanes, lane, k, update, slot, n, per_pass, acc,
                  [&](int q) { return column[q]; });
    }
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

bool bad_chain(int rows, int n, int lanes, int k, int update) {
    return bad_shape(rows, n, lanes, k) || update < 0 || update > 2 ||
           (update == 0 && k != 1) || (update == 2 && (rows & (rows - 1)));
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// One thread an element, blocks of up to 1024 threads (the device and
// block forms).
void element_grid(int n, int lanes, DptGatherPlan& p) {
    const int n_el = n * lanes;
    p.threads = n_el < 1024 ? ((n_el + 31) / 32) * 32 : 1024;
    p.grid = (n_el + p.threads - 1) / p.threads;
    p.rows_per_block = (p.threads + lanes - 1) / lanes;
}

// The device form's plan: the L2 line at any k.
DptGatherPlan device_plan(int n, int lanes) {
    DptGatherPlan p{};
    p.form = DPT_GATHER_DEVICE;
    p.cluster = 1;
    element_grid(n, lanes, p);
    return p;
}

int stage_min_k(int form, int rows) {
    for (const StageBand& b : STAGE_BANDS) {
        if (b.form == form && rows <= b.last_row) return b.min_k;
    }
    return ANY_ROWS;
}

// The plan the launcher would make for a (rows, lanes) table, n output
// rows and a chain of k: a single gather in the device form; a chain in
// the staged form of the table's height from that form's shortest chain
// on, in the device form below it; false where no form serves a chain.
// tools/gather_probe.py `gather_slab_plan` is the same function.
bool expected_plan(int rows, int n, int lanes, int k, DptGatherPlan& p) {
    p = device_plan(n, lanes);
    if (k == 1) return true;
    const int64_t whole = (int64_t)rows * lanes * 4;
    const int boxes = (rows + SLAB_BOX_ROWS - 1) / SLAB_BOX_ROWS;
    const int64_t multicast = (int64_t)boxes * SLAB_BOX_ROWS * 32 + SLAB_ALIGN + SLAB_BARRIER;
    if (whole <= DPT_PROBE_SMEM_BYTES) {
        if (k < stage_min_k(DPT_GATHER_BLOCK, rows)) return true;
        p.form = DPT_GATHER_BLOCK;
        p.slab_rows = rows;
        p.smem_bytes = (int)whole;
    } else if (multicast <= DPT_PROBE_SMEM_BYTES) {
        if (lanes % SLAB_LANES != 0) return false;
        if (k < stage_min_k(DPT_GATHER_MULTICAST, rows)) return true;
        p.form = DPT_GATHER_MULTICAST;
        p.cluster = SLAB_MULTICAST_CLUSTER;
        p.threads = SLAB_THREADS;
        p.slab_rows = boxes * SLAB_BOX_ROWS;
        p.smem_bytes = (int)multicast;
        p.rows_per_block = (n + SLAB_BLOCKS - 1) / SLAB_BLOCKS;
        p.grid = lanes / SLAB_LANES * SLAB_BLOCKS;
    } else {
        if (rows > COLUMN_MAX_ROWS) return false;
        if (k < stage_min_k(DPT_GATHER_COLUMN, rows)) return true;
        p.form = DPT_GATHER_COLUMN;
        p.threads = SLAB_THREADS;
        p.slab_rows = rows;
        p.smem_bytes = rows * 4;
        p.rows_per_block = n;
        p.grid = lanes;
    }
    return true;
}

bool same_plan(const DptGatherPlan& a, const DptGatherPlan& b) {
    return a.form == b.form && a.cluster == b.cluster && a.rows_per_block == b.rows_per_block &&
           a.slab_rows == b.slab_rows && a.threads == b.threads && a.grid == b.grid &&
           a.smem_bytes == b.smem_bytes;
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

int launch_multicast(const int32_t* table, const int32_t* idx, int32_t* out, int rows, int n,
                     int lanes, int k, int update, const DptGatherPlan& p, cudaStream_t s) {
    // A tensor map's base lies on a 16-byte boundary.
    if (reinterpret_cast<uintptr_t>(table) % 16) return (int)cudaErrorMisalignedAddress;
    CUtensorMap map;
    cudaError_t rc = slab_tensor_map(table, rows, lanes, &map);
    if (rc != cudaSuccess) return (int)rc;
    rc = allow_smem(gather_multicast_kernel, p.smem_bytes);
    if (rc != cudaSuccess) return (int)rc;
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
    rc = cudaLaunchKernelEx(&cfg, gather_multicast_kernel, map, idx, out, rows, n, lanes, k,
                            update, p.slab_rows, p.rows_per_block);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
}

}  // namespace

int dpt_gather_chain(const int32_t* table, const int32_t* idx, int32_t* out, int rows,
                     int n, int lanes, int k, int update, const DptGatherPlan& plan,
                     void* stream) {
    if (bad_chain(rows, n, lanes, k, update)) return (int)cudaErrorInvalidValue;
    DptGatherPlan want;
    if (!same_plan(plan, device_plan(n, lanes)) &&
        (!expected_plan(rows, n, lanes, k, want) || !same_plan(plan, want))) {
        return (int)cudaErrorInvalidConfiguration;
    }
    cudaStream_t s = (cudaStream_t)stream;
    switch (plan.form) {
        case DPT_GATHER_DEVICE:
            gather_block_kernel<false><<<plan.grid, plan.threads, 0, s>>>(
                table, idx, out, rows, n * lanes, lanes, k, update);
            return (int)cudaGetLastError();
        case DPT_GATHER_BLOCK: {
            const cudaError_t rc = allow_smem(gather_block_kernel<true>, plan.smem_bytes);
            if (rc != cudaSuccess) return (int)rc;
            gather_block_kernel<true><<<plan.grid, plan.threads, plan.smem_bytes, s>>>(
                table, idx, out, rows, n * lanes, lanes, k, update);
            return (int)cudaGetLastError();
        }
        case DPT_GATHER_MULTICAST:
            return launch_multicast(table, idx, out, rows, n, lanes, k, update, plan, s);
        default: {
            const cudaError_t rc = allow_smem(gather_column_kernel, plan.smem_bytes);
            if (rc != cudaSuccess) return (int)rc;
            gather_column_kernel<<<plan.grid, plan.threads, plan.smem_bytes, s>>>(
                table, idx, out, rows, n, lanes, k, update);
            return (int)cudaGetLastError();
        }
    }
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
