// Launch functions of the port's kernels: the wavefront error-diffusion
// kernels K1-K3 and K5-K9, the ordered-dither kernel K4 and the probes T1
// (gather), T2 (search) and T3 (identity copy).
//
// The .cu files that define them include no PyTorch header, so nvcc
// compiles them in seconds; bindings.cpp (the only file with
// torch/extension.h) checks tensors and calls these. Every launcher
// enqueues on `stream` (a cudaStream_t passed as void*), does not
// synchronise, allocates nothing, and returns the cudaError_t of the launch
// as an int (0 = success).
#pragma once

#include <cstdint>

// Largest palette of the packed-colour scan K2 (12 KB of shared memory);
// larger ones run the index scan K8.
constexpr int DPT_MAX_PALETTE = 1024;
// Largest palette of the index scan K8: 192 KB of dynamic shared memory,
// which with Ostromoukhov's 3 KB weight table fits the 227 KB a block may
// have. The golden engine stops at 4096 colours.
constexpr int DPT_IDX_MAX_PALETTE = 16384;
// Largest palette of the ordered kernel (the golden engine's MAX_PAL): 16
// bytes of shared memory a colour, 64 KB at 4096.
constexpr int DPT_ORDERED_MAX_PALETTE = 4096;
// Most diffusion entries of any fixed kernel (jjn and stucki have 12).
constexpr int DPT_MAX_ENTRIES = 12;
// The scan's modes, as dither_pie_tpu_torch.ops.wavefront.MODES orders them:
// 0 fixed, 1 ostromoukhov, 2 hybrid, 3 perceptual, 4 adaptive.
constexpr int DPT_SCAN_MODES = 5;

// A mode's entries in consume order (source row dy descending, then dx
// descending): the order the golden row-major scan adds them into a pixel.
// Weights are the pre-divided float32 values; col is the entry's column of
// Ostromoukhov's weight table (its weights are per pixel, w is unused).
struct DptScanEntries {
    int n;
    int dx[DPT_MAX_ENTRIES];
    int dy[DPT_MAX_ENTRIES];
    float w[DPT_MAX_ENTRIES];
    int col[DPT_MAX_ENTRIES];
};

// Largest cluster of the scan: a frame over at most 8 blocks (the portable
// cluster size), its palette split into as many contiguous slices.
constexpr int DPT_MAX_CLUSTER = 8;
// Dynamic shared memory a block may have (232,448 bytes).
constexpr int DPT_SMEM_BYTES = 227 * 1024;

// The palette slices of a cluster: rank r searches colours
// [lo[r], lo[r+1]), lo[0] = 0, lo[n] = P.
struct DptSlices {
    int lo[DPT_MAX_CLUSTER + 1];
};

// One launch of the scan (K2, or K8 with emit_idx).
struct DptScanArgs {
    const void* img;   // (D, 3B, H) skewed stream, uint8 or float32
    int img_is_f32;
    const float* pal;  // (P, 3)
    const float* pal_aug;  // (P, 4) rows [r, g, b, -0.5*((r*r + g*g) + b*b)]:
                           // the score search (P <= DPT_MAX_PALETTE); null:
                           // the exact search
    int P;
    DptScanEntries e;
    int mode;
    const float* aux;  // (B, H, W) sensitivity or gate (perceptual, adaptive)
    const float* lut;  // (256, 3) weight table (ostromoukhov)
    float lum_factor;  // hybrid
    float col_factor;
    int s, ring, B, H, W, D;
    float* hist;   // (B*n, ring, C, H) scratch, one history a block, C = 4
                   // for perceptual and ostromoukhov, else 3; ring a power
                   // of two >= n_slots; unused (null) with hist_smem
    int hist_smem; // 1: the history lives in shared memory
    int n;         // blocks a frame: the cluster, 1, 2, 4 or 8 (<= P)
    DptSlices slices;
    int max_slice; // colours of the longest slice
    int smem_bytes;  // the wrapper's dynamic shared-memory budget; must equal
                     // the kernel's layout
    int32_t* out;  // (D, B, H)
    int emit_idx;  // 0: packed colours (K2, P <= DPT_MAX_PALETTE); 1: indices
                   // (K8, P <= DPT_IDX_MAX_PALETTE)
    int* capacity; // non-null: launch nothing, store how many clusters of n
                   // blocks the card holds at once
};

// One launch of the tile transposes K1, K3, K5, K6 and K9, as the wrapper
// planned it (ops.wavefront.skew_tile_plan / unskew_tile_plan): tiles of td
// steps by ty rows, `lead` rows above each tile (K1, K6: the sector phase of
// its output rows) or steps before it (K3, K5, K9: where its store windows
// start) that a block also loads, blocks of `threads`, grid (row tiles,
// step tiles, frames a pass) and the block's static shared memory. The
// launcher computes its own and refuses a plan that differs
// (cudaErrorInvalidConfiguration).
struct DptTilePlan {
    int td, ty, lead, threads;
    int grid[3];
    int smem_bytes;
};

// K1, K6 and K7, one tile transpose: B frames of C channels, (B, H, W, C)
// -> (D, C*B, H) skewed stream, out[d, c*B + b, y] = in[b, y, d - s*y, c],
// 0 outside the image. C = 3: NHWC frames (K1); C = 1: compact planes
// (R, H, W) as R frames of one channel (K6), and R = 3B planes in the
// order c*B + b give K1's stream. Other C are refused. u8 -> u8, f32 ->
// f32, and u8 -> f32 (K7's cast; planned by the output type).
int dpt_skew_u8(const uint8_t* in, uint8_t* out, int B, int C, int H, int W,
                int D, int s, const DptTilePlan& plan, void* stream);
int dpt_skew_f32(const float* in, float* out, int B, int C, int H, int W,
                 int D, int s, const DptTilePlan& plan, void* stream);
int dpt_skew_u8_f32(const uint8_t* in, float* out, int B, int C, int H, int W,
                    int D, int s, const DptTilePlan& plan, void* stream);

// K2 and K8: the wavefront scan over the skewed stream, every mode; out
// (D, B, H) int32, 0 outside the image: packed colours
// (r << 16 | g << 8 | b) for K2, palette indices for K8. One frame a
// cluster of a.n blocks. With a.capacity set it launches nothing and
// answers cudaOccupancyMaxActiveClusters for the launch it would make.
int dpt_ed_scan(const DptScanArgs& a, void* stream);

// K3, K5 and K9, one tile transpose of the (D, B, H) int32 stream, by
// output kind: 0, 1: K3, packed colours -> uint8 colours v = (col[x + s*y,
// b, y] >> (16 - 8c)) & 255, NHWC out[b, y, x, c] (0) or the planes
// out[c, b, y, x] (1); 2, 3: K5, palette indices -> the (B, H, W) index
// stream out[b, y, x] = col[x + s*y, b, y], narrowed to uint8 (2; palettes
// of up to 256 colours) or uint16 (3; out 2-byte aligned); 4: K9, palette
// indices in 0..P-1 + the (P, 3) float32 palette `pal` -> (B, H, W, 3)
// uint8 out[b, y, x, c] = (u8)(int)pal[col[x + s*y, b, y], c], through the
// packed palette `table` (P uint32, scratch the launcher fills first). pal
// and table are null for kinds 0-3.
int dpt_unskew(const int32_t* col, void* out, int B, int H, int W, int s, int kind,
               const DptTilePlan& plan, const float* pal, int P, uint32_t* table,
               void* stream);

// T2: the palette search alone, over a (3*nb, lf) float32 working tile (row
// c*nb + b is channel c of frame b), repeated iters times; out (nb, lf)
// int32. score == 0: the exact sweep over a (pp, 3) palette, first strict
// minimum of (dr*dr + dg*dg) + db*db; score != 0: the score form over a
// (pp, 4) augmented palette, first strict maximum of
// ((r*x_r + g*x_g) + b*x_b) + n. One frame a cluster of n blocks (1, 2, 4
// or 8, n <= pp), rank r searching colours [sl.lo[r], sl.lo[r+1]), as the
// scan splits its palette.
constexpr int DPT_PROBE_MAX_PALETTE = 1024;
int dpt_search_probe(const float* cur, const float* pal, int pp, int nb,
                     int lf, int iters, int score, int n, const DptSlices& sl,
                     int32_t* out, void* stream);

// One launch of the ordered kernel K4, as the wrapper planned it
// (ops.ordered_fused.ordered_plan): blocks of `threads` threads, `pixels`
// pixels a thread, `frames` frames a block at most, grid (pixel groups of a
// row / threads, H, ceil(B / frames)) and the dynamic shared memory of the
// staged palette. The launcher computes its own and refuses a plan that
// differs (cudaErrorInvalidConfiguration).
struct DptOrderedPlan {
    int threads, pixels, frames;
    int grid[3];
    int smem_bytes;
};

// K4: ordered dither of a (B, H, W, 3) NHWC batch, u8 or float32 (taken as
// they are, not truncated), against a (H, W) float32 screen; out is
// (B, H, W, 3) u8 palette colours, or (B, H, W) u8 indices when
// emit_idx != 0 (P <= 256). pal: (P, 3) float32, P <= DPT_ORDERED_MAX_PALETTE.
int dpt_ordered_fused_u8(const uint8_t* img, const float* pal, int P,
                         const float* screen, int B, int H, int W, uint8_t* out,
                         int emit_idx, const DptOrderedPlan& plan, void* stream);
int dpt_ordered_fused_f32(const float* img, const float* pal, int P,
                          const float* screen, int B, int H, int W, uint8_t* out,
                          int emit_idx, const DptOrderedPlan& plan, void* stream);

// T1: the gather probe, over a (rows, lanes) int32 table and an (n, lanes)
// int32 tile of start values; element (r, l) runs its own chain:
//   gather  update 0: out = table[idx, l] (k must be 1);
//           update 1: k times acc = |table[acc, l] + step| mod rows;
//           update 2: k times acc = |table[acc & (rows-1), l] + acc + step|
//                     mod 255 (the sweep's update, fetched by one load;
//                     rows a power of two);
//   sweep   k times best = 0; for p in 0..rows-1: best = (acc & (rows-1))
//           == p ? table[p, l] : best; acc = |best + acc + step| mod 255
//           (rows a power of two).
// The gather runs as its plan (tools/gather_probe.py `gather_slab_plan`)
// says, in one of four forms: device (one thread an element, the table
// read where it lies in device memory: every single gather, k = 1, and
// every chain shorter than its height's staged form's break-even); block
// (the same with the table staged whole in each block's shared memory);
// multicast (a block a lane group of 8 lanes, the slab table[:, 8g:8g+8]
// in every block of a cluster of 2, loaded once a cluster by TMA
// multicast; lanes % 8 == 0 and a table on a 16-byte boundary); column (a
// block a lane, the lane's column in its shared memory, filled by ordinary
// loads from the table). The launcher computes its own plan and refuses
// one that differs (cudaErrorInvalidConfiguration), except the device
// form, which it takes at any k: the probe's L2 line. The sweep stages the
// table in dynamic shared memory with use_smem != 0 (it must fit
// DPT_PROBE_SMEM_BYTES) and reads device memory otherwise.
constexpr int DPT_PROBE_SMEM_BYTES = 227 * 1024;
constexpr int DPT_GATHER_BLOCK = 0;
constexpr int DPT_GATHER_MULTICAST = 1;
constexpr int DPT_GATHER_COLUMN = 2;
constexpr int DPT_GATHER_DEVICE = 3;
struct DptGatherPlan {
    int form, cluster;
    int rows_per_block;  // output rows a block takes (device, block: rows its threads start in)
    int slab_rows;       // table rows a block holds (multicast: rounded up to whole boxes)
    int threads, grid, smem_bytes;
};
int dpt_gather_chain(const int32_t* table, const int32_t* idx, int32_t* out, int rows,
                     int n, int lanes, int k, int update, const DptGatherPlan& plan,
                     void* stream);
int dpt_sweep_chain(const int32_t* table, const int32_t* idx, int32_t* out,
                    int rows, int n, int lanes, int k, int use_smem,
                    void* stream);
// An empty kernel of one warp: the floor under the probe's launches.
int dpt_empty_kernel(void* stream);

// T3: identity copy of n bytes, as the wrapper planned it
// (tools.layout_repro.identity_plan): `head` bytes one by one until out is
// 16-byte aligned, a body of `body` bytes in whole 16-byte words, and the
// tail after it one by one, on `blocks` blocks of `threads` (256). The
// body's form: stride (a grid-stride loop of 16-byte words; span 0, at
// most one block a 256 words, a block for each by default) where in and
// out agree mod 16; shifted (aligned stores of funnel-shifted input words,
// the body cut into spans of `span` bytes that the blocks, at most one a
// span, take in turn: block b spans b, b + blocks, ...) where they do not.
// The launcher computes the form, head and body from the pointers and
// refuses a plan that differs (cudaErrorInvalidConfiguration).
constexpr int DPT_IDENTITY_STRIDE = 0;
constexpr int DPT_IDENTITY_SHIFTED = 1;
struct DptIdentityPlan {
    int form;
    int64_t head, body, span, blocks;
    int threads;
};
int dpt_identity_u8(const uint8_t* in, uint8_t* out, int64_t n, const DptIdentityPlan& plan,
                    void* stream);

// R1: Riemersma error diffusion along the Hilbert curve, a block of two
// warps a frame (B blocks of 64 threads: the chain warp and the producer
// warp). `frames` is (B, hw, 3) uint8, or float32 with frames_is_f32;
// `order` (N,) the curve's linear pixel indices, `mask` (N,) its receiver
// masks (ops/riemersma_scan.py); `out` (B, hw, 3) uint8. Dynamic shared
// memory: dpt_riemersma_smem_bytes(P), the staging ring and 12 bytes a
// colour; above 48 KB the launcher raises the kernel's limit.
constexpr int DPT_RIEMERSMA_MAX_PALETTE = 16384;
int dpt_riemersma_smem_bytes(int P);
int dpt_riemersma_scan(const void* frames, int frames_is_f32, const float* pal, int P,
                       const int32_t* order, const uint8_t* mask, int N, int B, int64_t hw,
                       uint8_t* out, void* stream);
// R1's latency probe: one warp; `out` 10 int64 (riemersma_scan.cu).
int dpt_riemersma_latency(int iters, long long* out, void* stream);
