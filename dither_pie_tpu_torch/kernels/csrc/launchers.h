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
// Largest palette of the ordered kernel: three float32 planes of 4096
// entries fill the 48 KB of dynamic shared memory a block gets by default.
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
    float* hist;   // (B, ring, C, H) scratch, C = 4 for perceptual and
                   // ostromoukhov, else 3; ring a power of two >= n_slots
    int32_t* out;  // (D, B, H)
    int emit_idx;  // 0: packed colours (K2, P <= DPT_MAX_PALETTE); 1: indices
                   // (K8, P <= DPT_IDX_MAX_PALETTE)
};

// K1: (B, H, W, 3) frames -> (D, 3B, H) skewed stream,
// out[d, c*B + b, y] = in[b, y, d - s*y, c], 0 outside the image.
int dpt_skew_u8(const uint8_t* in, uint8_t* out, int B, int H, int W, int D,
                int s, void* stream);
int dpt_skew_f32(const float* in, float* out, int B, int H, int W, int D,
                 int s, void* stream);

// K2 and K8: the wavefront scan over the skewed stream, every mode; out
// (D, B, H) int32, 0 outside the image: packed colours
// (r << 16 | g << 8 | b) for K2, palette indices for K8.
int dpt_ed_scan(const DptScanArgs& a, void* stream);

// K3: (D, B, H) packed colours -> uint8 colours v = (col[x + s*y, b, y] >>
// (16 - 8c)) & 255: NHWC out[b, y, x, c], or with planar != 0 the planes
// out[c, b, y, x].
int dpt_unskew_unpack(const int32_t* col, uint8_t* out, int B, int H, int W,
                      int s, int planar, void* stream);

// K5: (D, B, H) palette indices -> the (B, H, W) index stream,
// out[b, y, x] = idx[x + s*y, b, y], narrowed to uint8 (palettes of up to
// 256 colours) or uint16.
int dpt_unskew_idx_u8(const int32_t* idx, uint8_t* out, int B, int H, int W,
                      int s, void* stream);
int dpt_unskew_idx_u16(const int32_t* idx, uint16_t* out, int B, int H, int W,
                       int s, void* stream);

// K6: compact planes (R, H, W) -> (D, R, H) skewed stream,
// out[d, r, y] = in[r, y, d - s*y], 0 outside the image; R = 3B rows in the
// order c*B + b give K1's stream.
int dpt_skew_planar_u8(const uint8_t* in, uint8_t* out, int R, int H, int W,
                       int D, int s, void* stream);
int dpt_skew_planar_f32(const float* in, float* out, int R, int H, int W,
                        int D, int s, void* stream);

// K7: tile transpose of a strided view into the skewed stream,
// out[d, r, y] = cast(in[r, y, d]) where d - s*y lies in [0, W), else 0; out
// is (D, R, H) contiguous. Row r = c*rows_inner + b of the view starts at
// in + c*stride_outer + b*stride_inner, and element (y, d) of it lies
// y*stride_y + d*stride_d further (strides in elements). The stride-lemma
// view of compact planes (stride_y = W - s, stride_d = 1) or of NHWC frames
// (stride_y = 3*(W - s), stride_d = 3) makes in[r, y, d] the pixel
// (y, d - s*y), so the result is K1's and K6's stream.
int dpt_skew_transpose_u8(const uint8_t* in, uint8_t* out, int R,
                          int rows_inner, int64_t stride_outer,
                          int64_t stride_inner, int64_t stride_y,
                          int64_t stride_d, int H, int W, int D, int s,
                          void* stream);
int dpt_skew_transpose_f32(const float* in, float* out, int R, int rows_inner,
                           int64_t stride_outer, int64_t stride_inner,
                           int64_t stride_y, int64_t stride_d, int H, int W,
                           int D, int s, void* stream);
int dpt_skew_transpose_u8_f32(const uint8_t* in, float* out, int R,
                              int rows_inner, int64_t stride_outer,
                              int64_t stride_inner, int64_t stride_y,
                              int64_t stride_d, int H, int W, int D, int s,
                              void* stream);

// T2: the palette search alone, over a (3*nb, lf) float32 working tile (row
// c*nb + b is channel c of frame b), repeated iters times; out (nb, lf)
// int32. score == 0: the exact sweep over a (pp, 3) palette, first strict
// minimum of (dr*dr + dg*dg) + db*db; score != 0: the score form over a
// (pp, 4) augmented palette, first strict maximum of
// ((r*x_r + g*x_g) + b*x_b) + n.
constexpr int DPT_PROBE_MAX_PALETTE = 1024;
int dpt_search_probe(const float* cur, const float* pal, int pp, int nb,
                     int lf, int iters, int score, int32_t* out, void* stream);

// K9: (D, B, H) palette indices in 0..P-1 + (P, 3) float32 palette ->
// (B, H, W, 3) uint8, out[b, y, x, c] = (int)pal[idx[x + s*y, b, y], c].
int dpt_unskew_select(const int32_t* idx, const float* pal, uint8_t* out,
                      int B, int H, int W, int s, void* stream);

// K4: ordered dither of n = B*H*W NHWC pixels, u8 or float32 (taken as they
// are, not truncated), against a (H, W) float32 screen (hw = H*W, read at
// i mod hw); out is n*3 u8 palette colours, or n u8 indices when
// emit_idx != 0 (P <= 256). pal: (P, 3) float32.
int dpt_ordered_fused_u8(const uint8_t* img, const float* pal, int P,
                         const float* screen, int64_t n, int64_t hw,
                         uint8_t* out, int emit_idx, void* stream);
int dpt_ordered_fused_f32(const float* img, const float* pal, int P,
                          const float* screen, int64_t n, int64_t hw,
                          uint8_t* out, int emit_idx, void* stream);

// T1: the gather probe, over a (rows, lanes) int32 table and an (n, lanes)
// int32 tile of start values; element (r, l) runs its own chain on one
// thread, blocks of up to 1024 threads (an (8, 128) tile is one block):
//   gather  update 0: out = table[idx, l] (k must be 1);
//           update 1: k times acc = |table[acc, l] + step| mod rows;
//           update 2: k times acc = |table[acc & (rows-1), l] + acc + step|
//                     mod 255 (the sweep's update, fetched by one load;
//                     rows a power of two);
//   sweep   k times best = 0; for p in 0..rows-1: best = (acc & (rows-1))
//           == p ? table[p, l] : best; acc = |best + acc + step| mod 255
//           (rows a power of two).
// use_smem != 0 stages the table in dynamic shared memory (it must fit
// DPT_PROBE_SMEM_BYTES); else every load goes to device memory.
constexpr int DPT_PROBE_SMEM_BYTES = 227 * 1024;
int dpt_gather_chain(const int32_t* table, const int32_t* idx, int32_t* out,
                     int rows, int n, int lanes, int k, int update,
                     int use_smem, void* stream);
int dpt_sweep_chain(const int32_t* table, const int32_t* idx, int32_t* out,
                    int rows, int n, int lanes, int k, int use_smem,
                    void* stream);

// T3: identity copy of n bytes, 16 bytes a thread where both pointers are
// 16-byte aligned (a scalar tail for the rest), byte by byte otherwise.
int dpt_identity_u8(const uint8_t* in, uint8_t* out, int64_t n, void* stream);

// Blocks for a grid-stride loop over n elements: enough to fill the card's
// 132 SMs many times over, never 0.
inline int dpt_grid_blocks(int64_t n, int threads) {
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks < 1) blocks = 1;
    if (blocks > 132 * 64) blocks = 132 * 64;
    return (int)blocks;
}
