// Launch functions of the port's kernels: the wavefront error-diffusion
// kernels K1-K3 and the ordered-dither kernel K4.
//
// The .cu files that define them include no PyTorch header, so nvcc
// compiles them in seconds; bindings.cpp (the only file with
// torch/extension.h) checks tensors and calls these. Every launcher
// enqueues on `stream` (a cudaStream_t passed as void*), does not
// synchronise, allocates nothing, and returns the cudaError_t of the launch
// as an int (0 = success).
#pragma once

#include <cstdint>

// Largest palette the scan kernel's running-min search serves (the slice's
// bound: palettes of <= 64 colours; larger ones belong to the dense search).
constexpr int DPT_MAX_PALETTE = 64;
// Largest palette of the ordered kernel: three float32 planes of 4096
// entries fill the 48 KB of dynamic shared memory a block gets by default.
constexpr int DPT_ORDERED_MAX_PALETTE = 4096;
// Most diffusion entries of any fixed kernel (jjn and stucki have 12).
constexpr int DPT_MAX_ENTRIES = 12;

// The fixed kernel's entries in consume order (source row dy descending,
// then dx descending): the order the golden row-major scan adds them into
// a pixel. Weights are the pre-divided float32 values.
struct DptScanEntries {
    int n;
    int dx[DPT_MAX_ENTRIES];
    int dy[DPT_MAX_ENTRIES];
    float w[DPT_MAX_ENTRIES];
};

// K1: (B, H, W, 3) frames -> (D, 3B, H) skewed stream,
// out[d, c*B + b, y] = in[b, y, d - s*y, c], 0 outside the image.
int dpt_skew_u8(const uint8_t* in, uint8_t* out, int B, int H, int W, int D,
                int s, void* stream);
int dpt_skew_f32(const float* in, float* out, int B, int H, int W, int D,
                 int s, void* stream);

// K2: fixed-weight wavefront scan over the skewed stream; out (D, B, H)
// int32 packed colours (r << 16 | g << 8 | b), 0 outside the image.
// hist: (B, ring, 3, H) float32 scratch, ring a power of two >= n_slots.
int dpt_ed_scan_fixed_u8(const uint8_t* img, const float* pal, int P,
                         DptScanEntries e, int s, int ring, int B, int H,
                         int W, int D, float* hist, int32_t* out,
                         void* stream);
int dpt_ed_scan_fixed_f32(const float* img, const float* pal, int P,
                          DptScanEntries e, int s, int ring, int B, int H,
                          int W, int D, float* hist, int32_t* out,
                          void* stream);

// K3: (D, B, H) packed colours -> (B, H, W, 3) uint8,
// out[b, y, x, c] = (col[x + s*y, b, y] >> (16 - 8c)) & 255.
int dpt_unskew_unpack(const int32_t* col, uint8_t* out, int B, int H, int W,
                      int s, void* stream);

// K4: ordered dither of n = B*H*W NHWC u8 pixels against a (H, W) float32
// screen (hw = H*W, read at i mod hw); out is n*3 u8 palette colours, or n
// u8 indices when emit_idx != 0 (P <= 256). pal: (P, 3) float32.
int dpt_ordered_fused(const uint8_t* img, const float* pal, int P,
                      const float* screen, int64_t n, int64_t hw, uint8_t* out,
                      int emit_idx, void* stream);

// Blocks for a grid-stride loop over n elements: enough to fill the card's
// 132 SMs many times over, never 0.
inline int dpt_grid_blocks(int64_t n, int threads) {
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks < 1) blocks = 1;
    if (blocks > 132 * 64) blocks = 132 * 64;
    return (int)blocks;
}
