// K1, K6 and K7: skew frames or planes into the wavefront stream, one
// shared-memory tile transpose with the channel count C and the input and
// output element types TI, TO as template parameters (C = 3: NHWC frames,
// K1; C = 1: compact planes, K6; TI = u8, TO = f32: K7's cast).
//
// Replaces three TPU kernels of dither_pie_tpu/ops/wavefront.py:
// * K1, `_skew_fullrow_call` (reached through `_skew_packed_fused`):
//   out[d, c*B + b, y] = x[b, y, d - s*y, c], the batch folded into rows
//   c*B + b;
// * K6, `_skew_transpose_fused_call`: planes (R, H, W) in, out[d, r, y] =
//   planes[r, y, d - s*y]. R = 3B planes in the order c*B + b, which a
//   (3, B, H, W) channel-major batch (ffmpeg's gbrp) is as a free view,
//   give K1's stream for the same frames bit for bit; any R is served;
// * K7, `_skew_transpose_call`: out[d, r, y] = cast(in[r, y, d]) over the
//   frames' stride-lemma form (a plane read with rows s elements short, so
//   in[r, y, d] is the pixel (y, d - s*y)), u8 or f32 in, f32 out. That is
//   K1's stream for NHWC frames and K6's for planes, cast: the (u8, f32)
//   instantiation, with the same-type ones, serves it.
// Both are one function: stream row R = d*C*B + c*B + b of B frames of C
// channels, with K6's R planes as B frames of one channel. The frame's row
// index y is the fastest axis, so the scan reads one contiguous run of H
// values per (step, row). Positions outside the image parallelogram are 0,
// so the output is fully defined and equals the plain PyTorch version
// (`skew_plain`, `skew_planar_plain`, `skew_transpose_plain`) element for
// element. Instantiated (TI, TO) = (u8, u8), (f32, f32) and (u8, f32); the
// cast of u8 to f32 is exact.
//
// What bounds it: bytes. It reads the frames once and writes D*C*B*H
// elements (D = W + s*(H-1), so ~2x the input at 1080p with s = 2, ~8x for
// u8 -> f32); there is no arithmetic. The TPU needed bit-selected lane rolls because it
// cannot gather. Here one block moves one tile of TD steps d by TY rows y of
// one frame's (D, H) plane through shared memory (the plan is
// `ops.wavefront.skew_tile_plan`; the launcher refuses any other):
//
// * Store along y, in whole sectors. Stream row R is a run of H elements;
//   of it the block writes the window y in [y0 - ph, y0 - ph + TY), ph =
//   the phase of R's start in a 32-byte sector (in elements), so every
//   window starts on a sector boundary and the row tiles' windows tile the
//   row. At 1080p u8 a row starts 8-byte aligned; runs cut at y0 instead
//   left two half-written sectors a run, shared by two blocks, and on an
//   H100 that version ran markedly slower at 1080 rows than at 1088, where
//   every run is sector-aligned.
//   The block walks the 16-byte words that cover its window, stores whole
//   words with one 16-byte store and head and tail words in 4-byte or
//   single-byte pieces (tile_copy.cuh); five aligned 32-bit shared reads
//   and __funnelshift_r realign a word's 16 bytes.
// * Load along the frame rows. The block loads the rows y in
//   [y0 - lead, y0 + TY), lead = the largest ph of any row (24 u8 rows at
//   1080p, 0 for float32). Row y needs the pixels x in [d0 - s*y,
//   d0 + TD - s*y): one run of C*TD elements, read as the 16-byte words
//   that cover it (a word that overlaps the tensor lies in its allocation),
//   four words a thread in flight before any is used, and de-interleaved
//   into shared memory: element el = C*x + c goes to stream row
//   r = C*dd + c = el + C*(s*y - d0), so the channel split needs no
//   division, in slot r + r/32. Shared memory holds TO: the (u8, f32)
//   form reads the u8 run's 16-byte words as the u8 form does and widens
//   each element as it de-interleaves it, so its store phase is the f32
//   form's and its plan (tile sizes, lead, shared memory) the f32 plan:
//   every size below but the load's word count is the output type's.
// * Tiles wholly outside the parallelogram store zeros without loading
//   (53 % of the stream at 1080p); tiles that cut its edge are zeroed in
//   shared memory first; tiles wholly inside need neither.
//
// Shared rows are (TY + 32/E)*E + 4 bytes, E = sizeof(TO) (an odd count
// of 32-bit words)
// and row r sits in slot r + r/32: a warp's byte stores, whose stream rows
// lie 16/3 (C = 3) or 16 (C = 1) apart from lane to lane, then spread over
// the banks, and the store phase's word reads meet no conflict. The numpy
// models of this walk in tests/test_torch_skew_tiles.py (C = 3) and
// tests/test_torch_planar_tiles.py (C = 1) hold it bit for bit to the
// plain versions. Four blocks of 256 threads fit an SM (__launch_bounds__).
// Indexing inside a tile is 32-bit; each block computes its tile origin and
// its rows' base addresses, with no per-element 64-bit division.
// chip_smoke.py and tools/time_ed_path.py time every form on an H100 at
// 16 x 1080p (PERF.md).
//
// Who calls which form: `ops.wavefront.skew` sends frames of either type
// to the C = 3 form (`skew_gather`) and `ops.wavefront.skew_planar` planes
// to the C = 1 form (`skew_planar_gather`); `skew_transpose` (K7's
// wrapper) launches any of the three type pairs, NHWC or planes, on the
// frames as they lie. The (u8, f32) form is on no path of the package:
// the scan reads u8 streams itself.

#include <cuda_runtime.h>

#include "launchers.h"
#include "tile_copy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SECTOR = 32;  // bytes of a device-memory sector
constexpr int BATCH = 4;    // load items a thread has in flight at once

template <typename TI, typename TO, int C, int TD, int TY>
struct SkewTile {
    static constexpr int EI = sizeof(TI);               // input element bytes
    static constexpr int E = sizeof(TO);                // output and shared element bytes
    static constexpr int LEAD = SECTOR / E;             // rows above the tile, at most
    static constexpr int ROWS = C * TD;                 // stream rows r = C*dd + c
    static constexpr int SLOTS = ROWS + ROWS / 32;      // row r in slot r + r/32
    static constexpr int PITCH = (TY + LEAD) * E + 4;   // bytes a shared row
    static constexpr int WPR = C * TD * EI / 16 + 1;    // covering words a frame-row run
    static constexpr int NWR = TY * E / 16 + 1;         // covering words a stream run
    static constexpr int LOAD_BATCHES =
        ((TY + LEAD - 1) * WPR + BATCH * THREADS - 1) / (BATCH * THREADS);
    static constexpr int STORE_ITEMS = (ROWS * NWR + THREADS - 1) / THREADS;
    static constexpr int SMEM = 16 + SLOTS * PITCH + 32;
    static_assert(PITCH % 8 == 4, "a shared row must be an odd count of words");
    static_assert((TY * E) % SECTOR == 0 && (C * TD * EI) % 16 == 0, "tile sizes");
    static_assert(SMEM <= 48 * 1024, "static shared memory");
};

template <typename TI, typename TO, int C, int TD, int TY>
__global__ void __launch_bounds__(THREADS, 4)
skew_tile_kernel(const TI* __restrict__ in, TO* __restrict__ out, int B, int H,
                 int W, int D, int s, int lead) {
    using L = SkewTile<TI, TO, C, TD, TY>;
    constexpr int EI = L::EI;
    constexpr int E = L::E;
    __shared__ __align__(16) uint8_t smem[L::SMEM];
    uint8_t* const tile = smem + 16;

    // Tile rows: y in [y0 - lead, y0 + TY), row j at y = y0 - lead + j.
    const int y0 = blockIdx.x * TY;
    const int d0 = blockIdx.y * TD;
    const int ya = max(0, y0 - lead);
    const int yb = min(H, y0 + TY) - 1;
    const bool empty = d0 + TD - 1 < s * ya || d0 >= s * yb + W;
    const bool full = d0 >= s * yb && d0 + TD - 1 < s * ya + W;
    const int64_t row_bytes = (int64_t)W * C * EI;

    for (int b = blockIdx.z; b < B; b += gridDim.z) {
        if (!empty) {
            if (!full) {
                uint32_t* t32 = reinterpret_cast<uint32_t*>(tile);
                for (int i = threadIdx.x; i < L::SLOTS * L::PITCH / 4; i += THREADS)
                    t32[i] = 0;
                __syncthreads();
            }
            // Load: item f is word k of the run of tile row j.
            const uint8_t* frame = reinterpret_cast<const uint8_t*>(in) +
                                   (int64_t)b * H * row_bytes;
#pragma unroll 1
            for (int batch = 0; batch < L::LOAD_BATCHES; ++batch) {
                uint4 v[BATCH];
#pragma unroll
                for (int it = 0; it < BATCH; ++it) {
                    const int f = threadIdx.x + (batch * BATCH + it) * THREADS;
                    const int j = f / L::WPR;
                    const int k = f - j * L::WPR;
                    const int y = y0 - lead + j;
                    v[it] = make_uint4(0, 0, 0, 0);
                    if (y < ya || y > yb) continue;
                    const int xlo = max(0, d0 - s * y);
                    const int xhi = min(W, d0 + TD - s * y);
                    const uint8_t* row = frame + (int64_t)y * row_bytes;
                    const uintptr_t lo = reinterpret_cast<uintptr_t>(row) + xlo * C * EI;
                    const uintptr_t hi = reinterpret_cast<uintptr_t>(row) + xhi * C * EI;
                    const uintptr_t a = (lo & ~uintptr_t(15)) + 16 * k;
                    if (xlo < xhi && a < hi) v[it] = __ldg(reinterpret_cast<const uint4*>(a));
                }
#pragma unroll
                for (int it = 0; it < BATCH; ++it) {
                    const int f = threadIdx.x + (batch * BATCH + it) * THREADS;
                    const int j = f / L::WPR;
                    const int k = f - j * L::WPR;
                    const int y = y0 - lead + j;
                    if (y < ya || y > yb) continue;
                    const int xlo = max(0, d0 - s * y);
                    const int xhi = min(W, d0 + TD - s * y);
                    const uint8_t* row = frame + (int64_t)y * row_bytes;
                    const uintptr_t lo = reinterpret_cast<uintptr_t>(row) + xlo * C * EI;
                    const uintptr_t hi = reinterpret_cast<uintptr_t>(row) + xhi * C * EI;
                    const uintptr_t a = (lo & ~uintptr_t(15)) + 16 * k;
                    if (xlo >= xhi || a >= hi) continue;
                    // Element of the row at the word's start (may be < 0);
                    // its stream row r0 = e0 + C*(s*y - d0), element i's
                    // r0 + i, in slot r0 + i + (r0 + i)/32: the word's
                    // elements from i = t = 32 - r0 % 32 on sit one slot
                    // further.
                    const int e0 = (int)((intptr_t)(a - reinterpret_cast<uintptr_t>(row))) / EI;
                    const int r0 = e0 + C * (s * y - d0);
                    const int t = 32 - (r0 & 31);
                    uint8_t* const base = tile + (r0 + (r0 >> 5)) * L::PITCH + j * E;
                    const int ilo = C * xlo - e0;  // the word's elements [ilo, ihi)
                    const int ihi = C * xhi - e0;  // lie in the row's run
                    const TI* vals = reinterpret_cast<const TI*>(&v[it]);
                    if (ilo <= 0 && ihi >= 16 / EI) {
#pragma unroll
                        for (int i = 0; i < 16 / EI; ++i) {
                            *reinterpret_cast<TO*>(base + (i + (i >= t)) * L::PITCH) = (TO)vals[i];
                        }
                    } else {
#pragma unroll
                        for (int i = 0; i < 16 / EI; ++i) {
                            if (i >= ilo && i < ihi) {
                                *reinterpret_cast<TO*>(base + (i + (i >= t)) * L::PITCH) =
                                    (TO)vals[i];
                            }
                        }
                    }
                }
            }
            __syncthreads();
        }
        // Store: item f is word k of stream row R = d*C*B + c*B + b, r =
        // C*dd + c of the tile. Its window y in [y0 - ph, y0 - ph + TY),
        // ph = the phase of the row's start in a 32-byte sector (in
        // elements), starts on a sector boundary: the windows of the row
        // tile it without overlap, and every sector but the row's first
        // and last is written whole by one block.
#pragma unroll 1
        for (int it = 0; it < L::STORE_ITEMS; ++it) {
            const int f = threadIdx.x + it * THREADS;
            const int r = f / L::NWR;
            const int k = f - r * L::NWR;
            const int dd = r / C;
            const int c = r - C * dd;
            const int d = d0 + dd;
            if (r >= L::ROWS || d >= D) continue;
            const uintptr_t rs = reinterpret_cast<uintptr_t>(out) +
                                 ((int64_t)d * C * B + c * B + b) * H * E;
            const int ph = (int)(rs & (SECTOR - 1)) / E;
            const int ys = max(0, y0 - ph);
            const int ye = min(H, y0 - ph + TY);
            const uintptr_t gs = rs + ys * E;
            const uintptr_t ge = rs + ye * E;
            const uintptr_t a = (gs & ~uintptr_t(15)) + 16 * k;
            if (ys >= ye || a >= ge) continue;
            uint32_t q[4] = {0, 0, 0, 0};
            if (!empty) {
                // Byte of the shared row at a: row j = y - (y0 - lead).
                const int o = (ys - y0 + lead) * E + (int)((intptr_t)(a - gs));
                const uint32_t* src = reinterpret_cast<const uint32_t*>(
                                          tile + (r + (r >> 5)) * L::PITCH) + (o >> 2);
                dpt_funnel_read16(src, (o & 3) * 8, q);
            }
            dpt_store_word(reinterpret_cast<uint8_t*>(a), q, gs, ge);
        }
        __syncthreads();
    }
}

// Rows above a tile that K1 loads for an output at `out`: the largest
// sector phase, in elements, of a stream row's start, (out + R*H*E) mod 32
// over all R.
int lead_rows(const void* out, int H, int E) {
    int step = SECTOR;  // gcd(H*E, 32)
    while ((int64_t)H * E % step) step >>= 1;
    return ((int)(reinterpret_cast<uintptr_t>(out) % step) + SECTOR - step) / E;
}

template <typename TI, typename TO, int C, int TD, int TY>
int launch(const TI* in, TO* out, int B, int H, int W, int D, int s,
           const DptTilePlan& plan, void* stream) {
    using L = SkewTile<TI, TO, C, TD, TY>;
    if (B < 1 || H < 1 || W < 1 || s < 1 || D != W + s * (H - 1)) {
        return (int)cudaErrorInvalidValue;
    }
    const int lead = lead_rows(out, H, L::E);
    const dim3 grid((H + lead + TY - 1) / TY, (D + TD - 1) / TD, B < 65535 ? B : 65535);
    if (plan.td != TD || plan.ty != TY || plan.threads != THREADS ||
        plan.lead != lead || plan.smem_bytes != L::SMEM ||
        plan.grid[0] != (int)grid.x || plan.grid[1] != (int)grid.y ||
        plan.grid[2] != (int)grid.z || grid.y > 65535) {
        return (int)cudaErrorInvalidConfiguration;
    }
    skew_tile_kernel<TI, TO, C, TD, TY><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        in, out, B, H, W, D, s, lead);
    return (int)cudaGetLastError();
}

}  // namespace

// Tile sizes (ops.wavefront.SKEW_TILES, by the output type), set by timing
// variants on an H100 (PERF.md): a planar tile holds as many stream rows as
// an NHWC one or more, its C*TD element load runs as long or longer.
int dpt_skew_u8(const uint8_t* in, uint8_t* out, int B, int C, int H, int W,
                int D, int s, const DptTilePlan& plan, void* stream) {
    if (C == 3) return launch<uint8_t, uint8_t, 3, 64, 128>(in, out, B, H, W, D, s, plan, stream);
    if (C == 1) return launch<uint8_t, uint8_t, 1, 256, 128>(in, out, B, H, W, D, s, plan, stream);
    return (int)cudaErrorInvalidValue;
}

int dpt_skew_f32(const float* in, float* out, int B, int C, int H, int W,
                 int D, int s, const DptTilePlan& plan, void* stream) {
    if (C == 3) return launch<float, float, 3, 64, 32>(in, out, B, H, W, D, s, plan, stream);
    if (C == 1) return launch<float, float, 1, 192, 32>(in, out, B, H, W, D, s, plan, stream);
    return (int)cudaErrorInvalidValue;
}

int dpt_skew_u8_f32(const uint8_t* in, float* out, int B, int C, int H, int W,
                    int D, int s, const DptTilePlan& plan, void* stream) {
    if (C == 3) return launch<uint8_t, float, 3, 64, 32>(in, out, B, H, W, D, s, plan, stream);
    if (C == 1) return launch<uint8_t, float, 1, 192, 32>(in, out, B, H, W, D, s, plan, stream);
    return (int)cudaErrorInvalidValue;
}
