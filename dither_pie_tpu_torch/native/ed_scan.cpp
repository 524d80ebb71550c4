// Native sequential error-diffusion engine.
//
// Role in the TPU framework: error diffusion is an inherently sequential
// recurrence. The default (non-serpentine) scans run on TPU as a Pallas
// anti-diagonal wavefront kernel; this C++ engine provides
//   (a) the serpentine scans, whose row-reversal dependency chain admits no
//       wavefront parallelism at all (each row depends on the *last* pixel
//       of the previous row),
//   (b) the Riemersma/Hilbert-curve scan (a 1-D chain),
//   (c) the bit-faithful golden reference the TPU kernels are tested against,
//   (d) the CPU fallback when no accelerator is present.
//
// Arithmetic parity notes (vs the original dithering_lib.py):
//  * Palette lookups order candidates by float64 squared distance computed
//    from float32 operands — exactly what scipy's KDTree does after
//    upcasting. First strict minimum wins.
//  * Storage and error arithmetic are float32 with NumPy-2 "weak scalar"
//    semantics: python-float weights are demoted to f32 before multiplying
//    (NEP 50), so we precompute f32 weights and multiply in f32.
//  * `clamp_before_lookup` toggles between the reference's Numba fast-path
//    semantics (clamps; dithering_lib.py:240-252) and its pure-Python hybrid
//    path (does not; dithering_lib.py:1130-1135).
//
// Build: see build.py (g++ -O2 -fPIC -shared, no -ffast-math — float
// determinism matters more than a few percent of speed here).

#include <cstdint>
#include <cmath>
#include <cstring>

extern "C" {

static inline float clampf(float v, float lo, float hi) {
    if (v < lo) return lo;
    if (v > hi) return hi;
    return v;
}

// Nearest palette index by float64 squared distance (first strict min wins).
static inline int nearest_idx(const float* pal, int p, float r, float g, float b) {
    double best = 1e300;
    int best_i = 0;
    for (int i = 0; i < p; ++i) {
        double dr = (double)r - (double)pal[3 * i];
        double dg = (double)g - (double)pal[3 * i + 1];
        double db = (double)b - (double)pal[3 * i + 2];
        double d = dr * dr + dg * dg + db * db;
        if (d < best) { best = d; best_i = i; }
    }
    return best_i;
}

static void final_clamp(float* work, int n) {
    for (int i = 0; i < n; ++i) work[i] = clampf(work[i], 0.0f, 255.0f);
}

// ---------------------------------------------------------------------------
// SIMD-friendly f32 palette scan (the video fast path). Semantics match the
// reference's NUMBA path (dithering_lib.py:240-252: float32 distances), not
// the f64 KDTree ordering of the exact functions above — the reference's
// own two paths diverge the same way at f32 near-ties. Palette is prepared
// once per image as padded SoA; the distance loop is branch-free so the
// compiler vectorizes it (-O3 -march=native), and the argmin stays scalar
// over a tiny stack array.
// ---------------------------------------------------------------------------
// Covers the packed kernel's PACKED_PALETTE_MAX (1024) AND the v1
// fallback path beyond it, so every device palette size has a tie-robust
// f32 golden (the >1024 seam was unswept before round 5). Stack cost:
// 3*4096 f32 SoA + 4096 f32 d2 = 64 KB — fine on any host thread stack.
#define MAX_PAL 4096

struct PalSoA {
    float r[MAX_PAL], g[MAX_PAL], b[MAX_PAL];
    int pp;
};

static void pal_soa(const float* pal, int p, PalSoA* s) {
    int pp = (p + 15) & ~15;  // pad to a SIMD-friendly multiple of 16
    if (pp > MAX_PAL) pp = MAX_PAL;
    for (int i = 0; i < p && i < MAX_PAL; ++i) {
        s->r[i] = pal[3 * i];
        s->g[i] = pal[3 * i + 1];
        s->b[i] = pal[3 * i + 2];
    }
    for (int i = p; i < pp; ++i) {  // sentinels never win
        s->r[i] = 1.0e18f; s->g[i] = 1.0e18f; s->b[i] = 1.0e18f;
    }
    s->pp = pp;
}

static inline int nearest_idx_f32(const PalSoA* s, float r, float g, float b) {
    float d2[MAX_PAL];
    const int pp = s->pp;
    for (int i = 0; i < pp; ++i) {  // branch-free: auto-vectorizes
        float dr = r - s->r[i], dg = g - s->g[i], db = b - s->b[i];
        d2[i] = dr * dr + dg * dg + db * db;
    }
    int best = 0;  // first strict minimum wins, like the exact path
    for (int i = 1; i < pp; ++i) {
        if (d2[i] < d2[best]) best = i;
    }
    return best;
}

// ---------------------------------------------------------------------------
// Fixed-weight error diffusion (floyd_steinberg / jjn / stucki / burkes /
// atkinson / sierra / sierra_two_row / sierra_lite), optional serpentine.
// offs: (n,2) int32 (dx, dy); wts: (n) float32 pre-divided weights.
// ---------------------------------------------------------------------------
void ed_fixed(float* work, int h, int w,
              const float* pal, int p,
              const int32_t* offs, const float* wts, int n_off,
              int serpentine) {
    for (int y = 0; y < h; ++y) {
        int x_start, x_end, x_step, dir;
        if (serpentine && (y & 1)) { x_start = w - 1; x_end = -1; x_step = -1; dir = -1; }
        else { x_start = 0; x_end = w; x_step = 1; dir = 1; }
        for (int x = x_start; x != x_end; x += x_step) {
            float* px = work + 3 * (y * w + x);
            float r = clampf(px[0], 0.0f, 255.0f);
            float g = clampf(px[1], 0.0f, 255.0f);
            float b = clampf(px[2], 0.0f, 255.0f);
            int bi = nearest_idx(pal, p, r, g, b);
            float cr = pal[3 * bi], cg = pal[3 * bi + 1], cb = pal[3 * bi + 2];
            px[0] = cr; px[1] = cg; px[2] = cb;
            float e0 = r - cr, e1 = g - cg, e2 = b - cb;
            for (int k = 0; k < n_off; ++k) {
                int nx = x + offs[2 * k] * dir;
                int ny = y + offs[2 * k + 1];
                if (nx >= 0 && nx < w && ny >= 0 && ny < h) {
                    float wq = wts[k];
                    float* q = work + 3 * (ny * w + nx);
                    q[0] += e0 * wq;
                    q[1] += e1 * wq;
                    q[2] += e2 * wq;
                }
            }
        }
    }
    final_clamp(work, h * w * 3);
}

// f32 fast-path twin of ed_fixed (video serpentine throughput; palettes
// beyond MAX_PAL colors must use the exact path).
void ed_fixed_f32(float* work, int h, int w,
                  const float* pal, int p,
                  const int32_t* offs, const float* wts, int n_off,
                  int serpentine) {
    PalSoA s;
    pal_soa(pal, p, &s);
    for (int y = 0; y < h; ++y) {
        int x_start, x_end, x_step, dir;
        if (serpentine && (y & 1)) { x_start = w - 1; x_end = -1; x_step = -1; dir = -1; }
        else { x_start = 0; x_end = w; x_step = 1; dir = 1; }
        for (int x = x_start; x != x_end; x += x_step) {
            float* px = work + 3 * (y * w + x);
            float r = clampf(px[0], 0.0f, 255.0f);
            float g = clampf(px[1], 0.0f, 255.0f);
            float b = clampf(px[2], 0.0f, 255.0f);
            int bi = nearest_idx_f32(&s, r, g, b);
            float cr = s.r[bi], cg = s.g[bi], cb = s.b[bi];
            px[0] = cr; px[1] = cg; px[2] = cb;
            float e0 = r - cr, e1 = g - cg, e2 = b - cb;
            for (int k = 0; k < n_off; ++k) {
                int nx = x + offs[2 * k] * dir;
                int ny = y + offs[2 * k + 1];
                if (nx >= 0 && nx < w && ny >= 0 && ny < h) {
                    float wq = wts[k];
                    float* q = work + 3 * (ny * w + nx);
                    q[0] += e0 * wq;
                    q[1] += e1 * wq;
                    q[2] += e2 * wq;
                }
            }
        }
    }
    final_clamp(work, h * w * 3);
}

// ---------------------------------------------------------------------------
// Ostromoukhov variable-coefficient diffusion. table: (256,3) int32.
// ---------------------------------------------------------------------------
void ed_ostromoukhov(float* work, int h, int w,
                     const float* pal, int p,
                     const int32_t* table, int serpentine) {
    for (int y = 0; y < h; ++y) {
        int x_start, x_end, x_step, dir;
        if (serpentine && (y & 1)) { x_start = w - 1; x_end = -1; x_step = -1; dir = -1; }
        else { x_start = 0; x_end = w; x_step = 1; dir = 1; }
        for (int x = x_start; x != x_end; x += x_step) {
            float* px = work + 3 * (y * w + x);
            float r = clampf(px[0], 0.0f, 255.0f);
            float g = clampf(px[1], 0.0f, 255.0f);
            float b = clampf(px[2], 0.0f, 255.0f);
            int bi = nearest_idx(pal, p, r, g, b);
            float cr = pal[3 * bi], cg = pal[3 * bi + 1], cb = pal[3 * bi + 2];
            px[0] = cr; px[1] = cg; px[2] = cb;
            float e0 = r - cr, e1 = g - cg, e2 = b - cb;
            // f32 luminance of the clamped old value, truncated to int index.
            float lum = 0.299f * r + 0.587f * g + 0.114f * b;
            lum = clampf(lum, 0.0f, 255.0f);
            int ii = (int)lum;
            int32_t c0 = table[3 * ii], c1 = table[3 * ii + 1], c2 = table[3 * ii + 2];
            int32_t div = c0 + c1 + c2;
            if (div == 0) continue;
            // python-float division then f32 demotion (NEP 50 weak scalar).
            float w0 = (float)((double)c0 / (double)div);
            float w1 = (float)((double)c1 / (double)div);
            float w2 = (float)((double)c2 / (double)div);
            int nx = x + dir;
            if (nx >= 0 && nx < w) {
                float* q = work + 3 * (y * w + nx);
                q[0] += e0 * w0; q[1] += e1 * w0; q[2] += e2 * w0;
            }
            if (y + 1 < h) {
                int mx = x - dir;
                if (mx >= 0 && mx < w) {
                    float* q = work + 3 * ((y + 1) * w + mx);
                    q[0] += e0 * w1; q[1] += e1 * w1; q[2] += e2 * w1;
                }
                float* q = work + 3 * ((y + 1) * w + x);
                q[0] += e0 * w2; q[1] += e1 * w2; q[2] += e2 * w2;
            }
        }
    }
    final_clamp(work, h * w * 3);
}

// f32 fast-path twin of ed_ostromoukhov (weights still f64-divided then
// f32-demoted, matching the exact path).
void ed_ostromoukhov_f32(float* work, int h, int w,
                         const float* pal, int p,
                         const int32_t* table, int serpentine) {
    PalSoA s;
    pal_soa(pal, p, &s);
    for (int y = 0; y < h; ++y) {
        int x_start, x_end, x_step, dir;
        if (serpentine && (y & 1)) { x_start = w - 1; x_end = -1; x_step = -1; dir = -1; }
        else { x_start = 0; x_end = w; x_step = 1; dir = 1; }
        for (int x = x_start; x != x_end; x += x_step) {
            float* px = work + 3 * (y * w + x);
            float r = clampf(px[0], 0.0f, 255.0f);
            float g = clampf(px[1], 0.0f, 255.0f);
            float b = clampf(px[2], 0.0f, 255.0f);
            int bi = nearest_idx_f32(&s, r, g, b);
            float cr = s.r[bi], cg = s.g[bi], cb = s.b[bi];
            px[0] = cr; px[1] = cg; px[2] = cb;
            float e0 = r - cr, e1 = g - cg, e2 = b - cb;
            float lum = 0.299f * r + 0.587f * g + 0.114f * b;
            lum = clampf(lum, 0.0f, 255.0f);
            int ii = (int)lum;
            int32_t c0 = table[3 * ii], c1 = table[3 * ii + 1], c2 = table[3 * ii + 2];
            int32_t div = c0 + c1 + c2;
            if (div == 0) continue;
            float w0 = (float)((double)c0 / (double)div);
            float w1 = (float)((double)c1 / (double)div);
            float w2 = (float)((double)c2 / (double)div);
            int nx = x + dir;
            if (nx >= 0 && nx < w) {
                float* q = work + 3 * (y * w + nx);
                q[0] += e0 * w0; q[1] += e1 * w0; q[2] += e2 * w0;
            }
            if (y + 1 < h) {
                int mx = x - dir;
                if (mx >= 0 && mx < w) {
                    float* q = work + 3 * ((y + 1) * w + mx);
                    q[0] += e0 * w1; q[1] += e1 * w1; q[2] += e2 * w1;
                }
                float* q = work + 3 * ((y + 1) * w + x);
                q[0] += e0 * w2; q[1] += e1 * w2; q[2] += e2 * w2;
            }
        }
    }
    final_clamp(work, h * w * 3);
}

// ---------------------------------------------------------------------------
// Hybrid luminance/chroma-split diffusion (Floyd-Steinberg weights, row-major).
// ---------------------------------------------------------------------------
void ed_hybrid(float* work, int h, int w,
               const float* pal, int p,
               float lum_factor, float col_factor,
               int clamp_before_lookup) {
    const float fs[4] = {7.0f / 16.0f, 3.0f / 16.0f, 5.0f / 16.0f, 1.0f / 16.0f};
    const int fdx[4] = {1, -1, 0, 1};
    const int fdy[4] = {0, 1, 1, 1};
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            float* px = work + 3 * (y * w + x);
            float r = px[0], g = px[1], b = px[2];
            if (clamp_before_lookup) {
                r = clampf(r, 0.0f, 255.0f);
                g = clampf(g, 0.0f, 255.0f);
                b = clampf(b, 0.0f, 255.0f);
            }
            int bi = nearest_idx(pal, p, r, g, b);
            float cr = pal[3 * bi], cg = pal[3 * bi + 1], cb = pal[3 * bi + 2];
            px[0] = cr; px[1] = cg; px[2] = cb;
            float e0 = r - cr, e1 = g - cg, e2 = b - cb;
            float lum_err = 0.299f * e0 + 0.587f * e1 + 0.114f * e2;
            float l0 = 0.299f * lum_err, l1 = 0.587f * lum_err, l2 = 0.114f * lum_err;
            float f0 = lum_factor * l0 + col_factor * (e0 - l0);
            float f1 = lum_factor * l1 + col_factor * (e1 - l1);
            float f2 = lum_factor * l2 + col_factor * (e2 - l2);
            for (int k = 0; k < 4; ++k) {
                int nx = x + fdx[k], ny = y + fdy[k];
                if (nx >= 0 && nx < w && ny >= 0 && ny < h) {
                    float* q = work + 3 * (ny * w + nx);
                    q[0] += f0 * fs[k];
                    q[1] += f1 * fs[k];
                    q[2] += f2 * fs[k];
                }
            }
        }
    }
    final_clamp(work, h * w * 3);
}

// f32 fast-path twin of ed_hybrid (nearest_idx_f32 lookup — the Numba-path
// semantics the TPU wavefront kernel implements; error arithmetic is
// identical to the exact engine, so the two agree except on exact half-way
// palette ties, where f64-vs-f32 candidate ordering legitimately differs).
void ed_hybrid_f32(float* work, int h, int w,
                   const float* pal, int p,
                   float lum_factor, float col_factor,
                   int clamp_before_lookup) {
    PalSoA s;
    pal_soa(pal, p, &s);
    const float fs[4] = {7.0f / 16.0f, 3.0f / 16.0f, 5.0f / 16.0f, 1.0f / 16.0f};
    const int fdx[4] = {1, -1, 0, 1};
    const int fdy[4] = {0, 1, 1, 1};
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            float* px = work + 3 * (y * w + x);
            float r = px[0], g = px[1], b = px[2];
            if (clamp_before_lookup) {
                r = clampf(r, 0.0f, 255.0f);
                g = clampf(g, 0.0f, 255.0f);
                b = clampf(b, 0.0f, 255.0f);
            }
            int bi = nearest_idx_f32(&s, r, g, b);
            float cr = s.r[bi], cg = s.g[bi], cb = s.b[bi];
            px[0] = cr; px[1] = cg; px[2] = cb;
            float e0 = r - cr, e1 = g - cg, e2 = b - cb;
            float lum_err = 0.299f * e0 + 0.587f * e1 + 0.114f * e2;
            float l0 = 0.299f * lum_err, l1 = 0.587f * lum_err, l2 = 0.114f * lum_err;
            float f0 = lum_factor * l0 + col_factor * (e0 - l0);
            float f1 = lum_factor * l1 + col_factor * (e1 - l1);
            float f2 = lum_factor * l2 + col_factor * (e2 - l2);
            for (int k = 0; k < 4; ++k) {
                int nx = x + fdx[k], ny = y + fdy[k];
                if (nx >= 0 && nx < w && ny >= 0 && ny < h) {
                    float* q = work + 3 * (ny * w + nx);
                    q[0] += f0 * fs[k];
                    q[1] += f1 * fs[k];
                    q[2] += f2 * fs[k];
                }
            }
        }
    }
    final_clamp(work, h * w * 3);
}

// ---------------------------------------------------------------------------
// Perceptual diffusion: FS weights scaled by a precomputed per-pixel
// sensitivity map (0.5 + 0.5 * lum/255 of the ORIGINAL image). No pre-clamp
// (matches the pure-Python reference path, dithering_lib.py:1049-1063).
// ---------------------------------------------------------------------------
void ed_perceptual(float* work, int h, int w,
                   const float* pal, int p,
                   const float* sens) {
    const float fs[4] = {7.0f / 16.0f, 3.0f / 16.0f, 5.0f / 16.0f, 1.0f / 16.0f};
    const int fdx[4] = {1, -1, 0, 1};
    const int fdy[4] = {0, 1, 1, 1};
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            float* px = work + 3 * (y * w + x);
            float r = px[0], g = px[1], b = px[2];
            int bi = nearest_idx(pal, p, r, g, b);
            float cr = pal[3 * bi], cg = pal[3 * bi + 1], cb = pal[3 * bi + 2];
            px[0] = cr; px[1] = cg; px[2] = cb;
            float e0 = r - cr, e1 = g - cg, e2 = b - cb;
            float s = sens[y * w + x];
            for (int k = 0; k < 4; ++k) {
                int nx = x + fdx[k], ny = y + fdy[k];
                if (nx >= 0 && nx < w && ny >= 0 && ny < h) {
                    float wq = fs[k] * s;  // f32 multiply (weak-scalar demotion)
                    float* q = work + 3 * (ny * w + nx);
                    q[0] += e0 * wq;
                    q[1] += e1 * wq;
                    q[2] += e2 * wq;
                }
            }
        }
    }
    final_clamp(work, h * w * 3);
}

// f32 fast-path twin of ed_perceptual (see ed_hybrid_f32).
void ed_perceptual_f32(float* work, int h, int w,
                       const float* pal, int p,
                       const float* sens) {
    PalSoA s;
    pal_soa(pal, p, &s);
    const float fs[4] = {7.0f / 16.0f, 3.0f / 16.0f, 5.0f / 16.0f, 1.0f / 16.0f};
    const int fdx[4] = {1, -1, 0, 1};
    const int fdy[4] = {0, 1, 1, 1};
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            float* px = work + 3 * (y * w + x);
            float r = px[0], g = px[1], b = px[2];
            int bi = nearest_idx_f32(&s, r, g, b);
            float cr = s.r[bi], cg = s.g[bi], cb = s.b[bi];
            px[0] = cr; px[1] = cg; px[2] = cb;
            float e0 = r - cr, e1 = g - cg, e2 = b - cb;
            float sv = sens[y * w + x];
            for (int k = 0; k < 4; ++k) {
                int nx = x + fdx[k], ny = y + fdy[k];
                if (nx >= 0 && nx < w && ny >= 0 && ny < h) {
                    float wq = fs[k] * sv;  // f32 multiply (weak-scalar demotion)
                    float* q = work + 3 * (ny * w + nx);
                    q[0] += e0 * wq;
                    q[1] += e1 * wq;
                    q[2] += e2 * wq;
                }
            }
        }
    }
    final_clamp(work, h * w * 3);
}

// ---------------------------------------------------------------------------
// Adaptive-variance diffusion: FS distribution only where gate[y*w+x] != 0.
// No pre-clamp (pure-Python reference path, dithering_lib.py:998-1015).
// ---------------------------------------------------------------------------
void ed_adaptive(float* work, int h, int w,
                 const float* pal, int p,
                 const uint8_t* gate) {
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            float* px = work + 3 * (y * w + x);
            float r = px[0], g = px[1], b = px[2];
            int bi = nearest_idx(pal, p, r, g, b);
            float cr = pal[3 * bi], cg = pal[3 * bi + 1], cb = pal[3 * bi + 2];
            px[0] = cr; px[1] = cg; px[2] = cb;
            if (!gate[y * w + x]) continue;
            float e0 = r - cr, e1 = g - cg, e2 = b - cb;
            if (x + 1 < w) {
                float* q = work + 3 * (y * w + x + 1);
                q[0] += e0 * (7.0f / 16.0f); q[1] += e1 * (7.0f / 16.0f); q[2] += e2 * (7.0f / 16.0f);
            }
            if (y + 1 < h && x > 0) {
                float* q = work + 3 * ((y + 1) * w + x - 1);
                q[0] += e0 * (3.0f / 16.0f); q[1] += e1 * (3.0f / 16.0f); q[2] += e2 * (3.0f / 16.0f);
            }
            if (y + 1 < h) {
                float* q = work + 3 * ((y + 1) * w + x);
                q[0] += e0 * (5.0f / 16.0f); q[1] += e1 * (5.0f / 16.0f); q[2] += e2 * (5.0f / 16.0f);
            }
            if (y + 1 < h && x + 1 < w) {
                float* q = work + 3 * ((y + 1) * w + x + 1);
                q[0] += e0 * (1.0f / 16.0f); q[1] += e1 * (1.0f / 16.0f); q[2] += e2 * (1.0f / 16.0f);
            }
        }
    }
    final_clamp(work, h * w * 3);
}

// f32 fast-path twin of ed_adaptive (see ed_hybrid_f32).
void ed_adaptive_f32(float* work, int h, int w,
                     const float* pal, int p,
                     const uint8_t* gate) {
    PalSoA s;
    pal_soa(pal, p, &s);
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            float* px = work + 3 * (y * w + x);
            float r = px[0], g = px[1], b = px[2];
            int bi = nearest_idx_f32(&s, r, g, b);
            float cr = s.r[bi], cg = s.g[bi], cb = s.b[bi];
            px[0] = cr; px[1] = cg; px[2] = cb;
            if (!gate[y * w + x]) continue;
            float e0 = r - cr, e1 = g - cg, e2 = b - cb;
            if (x + 1 < w) {
                float* q = work + 3 * (y * w + x + 1);
                q[0] += e0 * (7.0f / 16.0f); q[1] += e1 * (7.0f / 16.0f); q[2] += e2 * (7.0f / 16.0f);
            }
            if (y + 1 < h && x > 0) {
                float* q = work + 3 * ((y + 1) * w + x - 1);
                q[0] += e0 * (3.0f / 16.0f); q[1] += e1 * (3.0f / 16.0f); q[2] += e2 * (3.0f / 16.0f);
            }
            if (y + 1 < h) {
                float* q = work + 3 * ((y + 1) * w + x);
                q[0] += e0 * (5.0f / 16.0f); q[1] += e1 * (5.0f / 16.0f); q[2] += e2 * (5.0f / 16.0f);
            }
            if (y + 1 < h && x + 1 < w) {
                float* q = work + 3 * ((y + 1) * w + x + 1);
                q[0] += e0 * (1.0f / 16.0f); q[1] += e1 * (1.0f / 16.0f); q[2] += e2 * (1.0f / 16.0f);
            }
        }
    }
    final_clamp(work, h * w * 3);
}

// ---------------------------------------------------------------------------
// Riemersma: error diffusion along a precomputed Hilbert path.
// path: (n_path, 2) int32 of (row, col), possibly covering a padded
// power-of-two grid larger than (h, w); out-of-image entries are skipped.
// Error goes to the next 4 path positions with FS weights; each recipient is
// clamped immediately (dithering_lib.py:834-840). No final clamp pass needed
// (every pixel ends as an in-range palette color).
// ---------------------------------------------------------------------------
void ed_riemersma(float* work, int h, int w,
                  const float* pal, int p,
                  const int32_t* path, int64_t n_path) {
    const float fs[4] = {7.0f / 16.0f, 1.0f / 16.0f, 5.0f / 16.0f, 3.0f / 16.0f};
    for (int64_t i = 0; i < n_path; ++i) {
        int rr = path[2 * i], cc = path[2 * i + 1];
        if (rr >= h || cc >= w) continue;
        float* px = work + 3 * (rr * w + cc);
        float r = px[0], g = px[1], b = px[2];
        int bi = nearest_idx(pal, p, r, g, b);
        float cr = pal[3 * bi], cg = pal[3 * bi + 1], cb = pal[3 * bi + 2];
        px[0] = cr; px[1] = cg; px[2] = cb;
        float e0 = r - cr, e1 = g - cg, e2 = b - cb;
        for (int k = 0; k < 4; ++k) {
            int64_t j = i + 1 + k;
            if (j >= n_path) break;
            int r2 = path[2 * j], c2 = path[2 * j + 1];
            if (r2 < h && c2 < w) {
                float* q = work + 3 * (r2 * w + c2);
                q[0] = clampf(q[0] + e0 * fs[k], 0.0f, 255.0f);
                q[1] = clampf(q[1] + e1 * fs[k], 0.0f, 255.0f);
                q[2] = clampf(q[2] + e2 * fs[k], 0.0f, 255.0f);
            }
        }
    }
}

// f32 fast-path twin of ed_riemersma.
void ed_riemersma_f32(float* work, int h, int w,
                      const float* pal, int p,
                      const int32_t* path, int64_t n_path) {
    PalSoA s;
    pal_soa(pal, p, &s);
    const float fs[4] = {7.0f / 16.0f, 1.0f / 16.0f, 5.0f / 16.0f, 3.0f / 16.0f};
    for (int64_t i = 0; i < n_path; ++i) {
        int rr = path[2 * i], cc = path[2 * i + 1];
        if (rr >= h || cc >= w) continue;
        float* px = work + 3 * (rr * w + cc);
        float r = px[0], g = px[1], b = px[2];
        int bi = nearest_idx_f32(&s, r, g, b);
        float cr = s.r[bi], cg = s.g[bi], cb = s.b[bi];
        px[0] = cr; px[1] = cg; px[2] = cb;
        float e0 = r - cr, e1 = g - cg, e2 = b - cb;
        for (int k = 0; k < 4; ++k) {
            int64_t j = i + 1 + k;
            if (j >= n_path) break;
            int r2 = path[2 * j], c2 = path[2 * j + 1];
            if (r2 < h && c2 < w) {
                float* q = work + 3 * (r2 * w + c2);
                q[0] = clampf(q[0] + e0 * fs[k], 0.0f, 255.0f);
                q[1] = clampf(q[1] + e1 * fs[k], 0.0f, 255.0f);
                q[2] = clampf(q[2] + e2 * fs[k], 0.0f, 255.0f);
            }
        }
    }
}

}  // extern "C"
