// K3, K5 and K9: unskew the scan's (D, B, H) int32 stream into its output
// rows, a shared-memory tile transpose: K3 unpacks packed colours to uint8,
// NHWC or planar; K5 narrows palette indices to the uint8 or uint16 index
// stream; K9 looks palette indices up in the packed palette and writes
// their colours, NHWC.
//
// Replaces the TPU kernels dither_pie_tpu/ops/wavefront.py
// `_unskew_unpack_call` (K3, reached through `_unskew_unpack_colors`),
// `_unskew_transpose_call` (K5, reached through `_unskew_idx_packed`) and
// `_unskew_select_call` (K9, reached through `_unskew_select_colors`):
// K3 out[b, y, x, c] = (col[x + s*y, b, y] >> (16 - 8c)) & 255, NHWC, or the
// planes out[c, b, y, x] of the planar video flow (the TPU kernel emits the
// three planes, which XLA restacks into NHWC); K5 out[b, y, x] =
// idx[x + s*y, b, y], which the TPU kernel emits as int32 and XLA narrows
// afterwards, written here in the stream's own type, uint8 for palettes of
// up to 256 colours and uint16 above (K5 is the index scan's epilogue, whose
// indices lie in 0..P-1; it does not check them); K9 out[b, y, x, c] =
// (u8)(int)palette[idx[x + s*y, b, y], c], the float32 -> int32 cast
// truncating, for palettes of 1025 to 16384 colours (the TPU kernel served
// at most 256 through a chain of selects and emitted three planes). K9 is
// K3's NHWC kind with one table lookup at the load: a small kernel first
// packs the palette as K2 packs its colours, table[p] = (u8)(int)r << 16 |
// (u8)(int)g << 8 | (u8)(int)b, one thread a colour, and the tile kernel
// puts table[v] in the tile where K3 puts v, so its store phase is K3's
// NHWC one, unchanged. The lookup goes through the read-only path (__ldg):
// 8 KB at 2048 colours, 64 KB at 16384, held in L1. It is made once a
// pixel, at the load, never in the store phase, which reads each pixel
// about twice. On an H100 a form that staged the table in each block's
// shared memory ran 3 % faster at 2048 colours and 23 % slower at 16384
// (PERF.md); this one keeps no table in shared memory. The output kind is a template parameter: U bytes a pixel of
// an output row, 3 NHWC and select, 1 planar (a row in each of the three
// planes), 1 u8, 2 u16.
//
// What bounds it: bytes, 4 read and U (planar 3) written per pixel, no
// arithmetic beyond byte moves (K9: and the table, read once). It is K1's
// transpose reversed: one block takes one tile of TD steps d by TY rows y
// of the (D, H) plane (the plan is `ops.wavefront.unskew_tile_plan`; the
// launcher refuses any other):
//
// * Store along x, in whole sectors. Of each output row (b, y) (of each
//   plane, planar) the block writes the window of U*TD bytes that starts at
//   the 32-byte sector boundary at or before its first pixel
//   x0 = d0 - s*y: consecutive step tiles' windows tile the row, and only a
//   row's first and last sectors are shared between blocks. The block walks
//   the 16-byte words that cover its window, builds each from the tile's row
//   j with __byte_perm (NHWC and select: the six pixels that hold a word,
//   four selectors fixed by its first byte's channel; planar: channel c's
//   byte of 16 pixels; u8: the low byte of 16 indices, planar's selector for
//   c = 2; u16: the low halves of 8 indices, selector 0x5410 over two) and
//   stores whole words with one 16-byte store, head and tail words in
//   4-byte or single-byte pieces (tile_copy.cuh).
// * Load along y. A window starts up to LEAD = ceil(31 / U) steps before
//   d0, so a tile row holds the steps d0 - LEAD .. d0 + TD - 1 (column
//   i = d - d0 + LEAD). Step d's run col[(d*B + b)*H + y0 ...] holds the
//   tile's column; the block reads the 16-byte words that cover the rows j
//   whose pixel x = d - s*(y0 + j) lies in the image (a table of those
//   rows, one int a column, is made once a block: no division in the
//   loop), and puts each int32 (select: its packed colour) at
//   tile[j][i + i/32]. Aligned at 1080p; any alignment is served.
// * The grid holds only the band of step tiles that own bytes of each row
//   tile's rows; a block walks two frames and loads the second's words
//   into registers while it stores the first's tile.
//
// The tile's rows are LEAD + TD steps, a spare word after every 32 and the
// pitch made odd, so the loads' stores along j and the reads along x, whose
// pixels lie 16/3 apart from lane to lane in NHWC, spread over the banks.
// Four blocks of 256 threads fit an SM. On an H100 both the instructions a
// word and the shared sectors set its time: a first version of this walk
// (a division per run and item, eight clamped pixel reads and a selector
// computed per 4-byte word) was markedly slower at 16 x 1080p, and runs
// cut at x0 cost more than the LEAD extra steps' loads. K5's and K9's
// earlier forms, one thread an output element, read one 32-byte sector a
// 4-byte index (neighbouring x lie B*H int32 apart in the stream); this walk
// reads them along y. Indexing inside a tile is 32-bit, with no per-element
// 64-bit division. The numpy model of this walk in
// tests/test_torch_skew_tiles.py holds it bit for bit to the plain versions
// (K5's kinds in tests/test_torch_unskew_idx_tiles.py, K9's in both).

#include <cuda_runtime.h>

#include "launchers.h"
#include "tile_copy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int FRAMES_PER_BLOCK = 2;  // frames a block walks, loads of the next under stores

constexpr int SECTOR = 32;  // bytes of a device-memory sector

// The output kinds, as ops.wavefront.UNSKEW_KINDS orders them.
constexpr int KIND_NHWC = 0;    // K3: (B, H, W, 3) uint8 colours
constexpr int KIND_PLANAR = 1;  // K3: (3, B, H, W) uint8 planes
constexpr int KIND_U8 = 2;      // K5: (B, H, W) uint8 indices
constexpr int KIND_U16 = 3;     // K5: (B, H, W) uint16 indices
constexpr int KIND_SELECT = 4;  // K9: (B, H, W, 3) uint8 colours of palette indices

template <int KIND, int TD, int TY>
struct UnskewTile {
    static constexpr bool NHWC = KIND == KIND_NHWC || KIND == KIND_SELECT;  // NHWC's store
    static constexpr int U = NHWC ? 3 : KIND == KIND_U16 ? 2 : 1;  // bytes a pixel
    static constexpr int PLANES = KIND == KIND_PLANAR ? 3 : 1;  // output rows a tile row
    static constexpr int LEAD = (SECTOR - 1 + U - 1) / U;  // steps before the tile
    static constexpr int COLS = LEAD + TD;              // steps a tile row holds
    static constexpr int PITCH = (COLS + COLS / 32) | 1;  // int32 a tile row j: odd
    static constexpr int NWR = TY * 4 / 16 + 1;         // covering words a step's run
    static constexpr int RUNS = PLANES * TY;            // output runs: rows (c, j)
    static constexpr int PER_RUN = U * TD / 16 + 1;
    static constexpr int LOAD_ITEMS = (COLS * NWR + THREADS - 1) / THREADS;
    static constexpr int STORE_ITEMS = (RUNS * PER_RUN + THREADS - 1) / THREADS;
    static constexpr int SMEM = 4 * TY * PITCH + 4 * COLS;  // the tile, rows_of
    static_assert((U * TD) % SECTOR == 0 && TD % 16 == 0 && TY % 4 == 0, "tile sizes");
    static_assert(SMEM <= 48 * 1024, "static shared memory");
};

__device__ __forceinline__ int floor_div(int a, int s) {
    return a >= 0 ? a / s : -((-a + s - 1) / s);
}

// 16 NHWC bytes from the six pixels v[0..5] that hold them, the first byte
// being channel PH0 of v[0]: 4-byte word m starts at channel (PH0 + 4m) % 3
// of pixel (PH0 + 4m) / 3, and takes its bytes from that pixel and the next
// (a pixel's r, g, b are its bytes 2, 1, 0; bytes 4-7 are the next's).
template <int PH0>
__device__ __forceinline__ void nhwc_word(const uint32_t v[6], uint32_t q[4]) {
    constexpr uint32_t SEL[3] = {0x6012u, 0x5601u, 0x4560u};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        q[m] = __byte_perm(v[(PH0 + 4 * m) / 3], v[(PH0 + 4 * m) / 3 + 1],
                           SEL[(PH0 + 4 * m) % 3]);
    }
}

template <int KIND, int TD, int TY>
__global__ void __launch_bounds__(THREADS, 4)
unskew_tile_kernel(const int32_t* __restrict__ col, uint8_t* __restrict__ out,
                   int B, int H, int W, int s, const uint32_t* __restrict__ table) {
    using L = UnskewTile<KIND, TD, TY>;
    __shared__ int32_t tile[TY * L::PITCH];
    __shared__ int rows_of[L::COLS];  // column i's rows [jlo, jhi] as jlo | jhi << 16

    // Block (x, y) takes row tile x and the y-th step tile of that row
    // tile's band. Its tile rows hold the steps d0 - LEAD .. d0 + TD - 1
    // (column i = d - d0 + LEAD): the stores' windows start up to LEAD
    // steps before d0.
    const int y0 = blockIdx.x * TY;
    const int ny = min(TY, H - y0);
    const int y_last = y0 + ny - 1;
    const int d0 = ((s * y0) / TD + blockIdx.y) * TD;
    if (d0 - L::LEAD >= s * y_last + W) return;  // past the band: no pixel here
    // The rows j of column i whose pixel x = d - s*(y0 + j) lies in [0, W).
    for (int i = threadIdx.x; i < L::COLS; i += THREADS) {
        const int t = d0 - L::LEAD + i - s * y0;
        const int jlo = max(0, floor_div(t - W, s) + 1);
        const int jhi = min(ny - 1, floor_div(t, s));
        rows_of[i] = jlo <= jhi ? jlo | (jhi << 16) : 1;  // 1: jlo 1 > jhi 0
    }
    __syncthreads();

    // Load item f: word k of the 16-byte words that cover column i's rows
    // [jlo, jhi] of frame b; its address, or 0 where there is none.
    auto word_of = [&](int f, int b, uintptr_t& gs, int& jlo, int& jhi) -> uintptr_t {
        const int i = f / L::NWR;
        const int k = f - i * L::NWR;
        if (i >= L::COLS) return 0;
        jlo = rows_of[i] & 0xFFFF;
        jhi = rows_of[i] >> 16;
        if (jlo > jhi) return 0;
        gs = reinterpret_cast<uintptr_t>(
            col + ((int64_t)(d0 - L::LEAD + i) * B + b) * H + y0);
        const uintptr_t a = ((gs + 4 * jlo) & ~uintptr_t(15)) + 16 * k;
        return a < gs + 4 * (jhi + 1) ? a : 0;
    };
    // Frames z, z + gridDim.z, ...: the next frame's words are loaded into
    // registers while this frame's tile is stored.
    uint4 v[L::LOAD_ITEMS];
    auto load = [&](int b) {
#pragma unroll
        for (int it = 0; it < L::LOAD_ITEMS; ++it) {
            uintptr_t gs;
            int jlo, jhi;
            const uintptr_t a = word_of(threadIdx.x + it * THREADS, b, gs, jlo, jhi);
            v[it] = a ? __ldg(reinterpret_cast<const uint4*>(a)) : make_uint4(0, 0, 0, 0);
        }
    };
    int b = blockIdx.z;
    if (b < B) load(b);
    for (; b < B; b += gridDim.z) {
        // Put each loaded int32 at tile[j][i + i/32]; select: its packed
        // colour, looked up here once a pixel.
#pragma unroll
        for (int it = 0; it < L::LOAD_ITEMS; ++it) {
            const int f = threadIdx.x + it * THREADS;
            uintptr_t gs;
            int jlo, jhi;
            const uintptr_t a = word_of(f, b, gs, jlo, jhi);
            if (!a) continue;
            const int i = f / L::NWR;
            const int j0 = (int)((intptr_t)(a - gs)) / 4;  // may be < 0
            const int32_t* vals = reinterpret_cast<const int32_t*>(&v[it]);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const int j = j0 + m;
                if (j >= jlo && j <= jhi) {
                    int32_t v = vals[m];
                    if constexpr (KIND == KIND_SELECT) v = (int32_t)__ldg(table + v);
                    tile[j * L::PITCH + i + (i >> 5)] = v;
                }
            }
        }
        __syncthreads();
        if (b + (int)gridDim.z < B) load(b + gridDim.z);
        // Store: item f is word k of run rr, row j of plane c (c = 0 but
        // for planar). Of the output row (b, y) of plane c, the block
        // writes the window of U*TD bytes that starts at the sector
        // boundary at or before pixel x0 = d0 - s*y: consecutive step
        // tiles' windows tile the row, and every sector but the row's
        // first and last is written whole by one block.
#pragma unroll 1
        for (int it = 0; it < L::STORE_ITEMS; ++it) {
            const int f = threadIdx.x + it * THREADS;
            const int rr = f / L::PER_RUN;
            const int k = f - rr * L::PER_RUN;
            const int c = L::PLANES > 1 ? rr / TY : 0;
            const int j = rr - c * TY;
            if (rr >= L::RUNS || j >= ny) continue;
            const int y = y0 + j;
            const int64_t row = (L::PLANES > 1 ? ((int64_t)c * B + b) * H : (int64_t)b * H) + y;
            const intptr_t rs = reinterpret_cast<intptr_t>(out + row * W * L::U);
            const intptr_t win = (rs + (intptr_t)L::U * (d0 - s * y)) & ~intptr_t(SECTOR - 1);
            const intptr_t end = rs + (intptr_t)L::U * W;
            const uintptr_t gs = (uintptr_t)(win > rs ? win : rs);
            const uintptr_t ge = (uintptr_t)(win + L::U * TD < end ? win + L::U * TD : end);
            const uintptr_t a = (gs & ~uintptr_t(15)) + 16 * k;
            if (gs >= ge || a >= ge) continue;
            const int e0 = (int)((intptr_t)a - rs);  // byte of the row: >= -15
            const int off = s * y - d0 + L::LEAD;     // column of pixel x = 0
            const int32_t* trow = tile + j * L::PITCH;
            // Pixel p of the row (clamped into the tile: head and tail
            // words read pixels they do not store).
            auto pixel = [&](int p) {
                const int i = min(max(p + off, 0), L::COLS - 1);
                return (uint32_t)trow[i + (i >> 5)];
            };
            uint32_t q[4];
            if constexpr (L::NHWC) {
                const int px0 = (e0 + 15) / 3 - 5;  // floor(e0 / 3): the word's first pixel
                uint32_t px[6];
#pragma unroll
                for (int i = 0; i < 6; ++i) px[i] = pixel(px0 + i);
                switch (e0 - 3 * px0) {  // the first byte's channel
                    case 0: nhwc_word<0>(px, q); break;
                    case 1: nhwc_word<1>(px, q); break;
                    default: nhwc_word<2>(px, q); break;
                }
            } else if constexpr (KIND == KIND_U16) {
                const int p0 = e0 >> 1;  // e0 is even: the row starts on a 2-byte boundary
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    q[m] = __byte_perm(pixel(p0 + 2 * m), pixel(p0 + 2 * m + 1), 0x5410);
                }
            } else {
                // One byte a pixel: byte 2 - c of a packed colour (planar),
                // an index's low byte (u8, the selector of c = 2).
                const int cb = KIND == KIND_PLANAR ? 2 - c : 0;
                const uint32_t pair = (uint32_t)(cb | ((cb + 4) << 4));
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    const int p = e0 + 4 * m;
                    const uint32_t lo2 = __byte_perm(pixel(p), pixel(p + 1), pair);
                    const uint32_t hi2 = __byte_perm(pixel(p + 2), pixel(p + 3), pair);
                    q[m] = __byte_perm(lo2, hi2, 0x5410);
                }
            }
            dpt_store_word(reinterpret_cast<uint8_t*>(a), q, gs, ge);
        }
        __syncthreads();
    }
}

// Step tiles of the widest band: row tile x's band runs from step tile
// s*y0 / TD to the one that holds step s*y_last + W - 1 (the launcher
// passes W + LEAD: a tile owns bytes up to LEAD steps before its own).
int band_tiles(int H, int W, int s, int TD, int TY) {
    int widest = 1;
    for (int y0 = 0; y0 < H; y0 += TY) {
        const int y_last = min(H, y0 + TY) - 1;
        widest = max(widest, (s * y_last + W - 1) / TD - (s * y0) / TD + 1);
    }
    return widest;
}

// The packed palette of K9: table[p] = (u8)(int)r << 16 | (u8)(int)g << 8 |
// (u8)(int)b, one thread a colour (the float32 -> int32 cast truncates).
__global__ void pack_palette_kernel(const float* __restrict__ pal, int P,
                                    uint32_t* __restrict__ table) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const uint32_t r = (uint8_t)(int32_t)pal[3 * p];
    const uint32_t g = (uint8_t)(int32_t)pal[3 * p + 1];
    const uint32_t b = (uint8_t)(int32_t)pal[3 * p + 2];
    table[p] = r << 16 | g << 8 | b;
}

template <int KIND>
int launch(const int32_t* col, uint8_t* out, int B, int H, int W, int s,
           const DptTilePlan& plan, const uint32_t* table, void* stream) {
    constexpr int TD = 128, TY = 32;
    using L = UnskewTile<KIND, TD, TY>;
    if (B < 1 || H < 1 || W < 1 || s < 1) return (int)cudaErrorInvalidValue;
    const int z = (B + FRAMES_PER_BLOCK - 1) / FRAMES_PER_BLOCK;
    const dim3 grid((H + TY - 1) / TY, band_tiles(H, W + L::LEAD, s, TD, TY),
                    z < 65535 ? z : 65535);
    if (plan.td != TD || plan.ty != TY || plan.lead != L::LEAD || plan.threads != THREADS ||
        plan.smem_bytes != L::SMEM || plan.grid[0] != (int)grid.x ||
        plan.grid[1] != (int)grid.y || plan.grid[2] != (int)grid.z ||
        grid.y > 65535) {
        return (int)cudaErrorInvalidConfiguration;
    }
    unskew_tile_kernel<KIND, TD, TY><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        col, out, B, H, W, s, table);
    return (int)cudaGetLastError();
}

}  // namespace

int dpt_unskew(const int32_t* col, void* out, int B, int H, int W, int s, int kind,
               const DptTilePlan& plan, const float* pal, int P, uint32_t* table,
               void* stream) {
    uint8_t* o = static_cast<uint8_t*>(out);
    const bool select = kind == KIND_SELECT;
    if (select != (pal != nullptr && table != nullptr)) return (int)cudaErrorInvalidValue;
    if (select) {
        if (P < 1 || P > DPT_IDX_MAX_PALETTE) return (int)cudaErrorInvalidValue;
        pack_palette_kernel<<<(P + 255) / 256, 256, 0, (cudaStream_t)stream>>>(pal, P, table);
        const cudaError_t rc = cudaGetLastError();
        if (rc != cudaSuccess) return (int)rc;
    }
    switch (kind) {
        case KIND_NHWC: return launch<KIND_NHWC>(col, o, B, H, W, s, plan, nullptr, stream);
        case KIND_PLANAR: return launch<KIND_PLANAR>(col, o, B, H, W, s, plan, nullptr, stream);
        case KIND_U8: return launch<KIND_U8>(col, o, B, H, W, s, plan, nullptr, stream);
        case KIND_U16:
            if (reinterpret_cast<uintptr_t>(out) % 2) return (int)cudaErrorMisalignedAddress;
            return launch<KIND_U16>(col, o, B, H, W, s, plan, nullptr, stream);
        case KIND_SELECT: return launch<KIND_SELECT>(col, o, B, H, W, s, plan, table, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
