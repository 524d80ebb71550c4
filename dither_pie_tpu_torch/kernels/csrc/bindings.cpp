// PyTorch binding of the port's kernels (the only source that includes
// PyTorch's headers). Each function checks device, dtype, shape and
// contiguity, launches on PyTorch's current stream of the tensor's device,
// and raises if the launch is refused. Outputs and scratch are allocated
// by the Python wrappers in dither_pie_tpu_torch/ops/wavefront.py (K1-K3,
// K5-K9), dither_pie_tpu_torch/ops/ordered_fused.py (K4),
// dither_pie_tpu_torch/ops/riemersma_scan.py (R1) and the probes in
// dither_pie_tpu_torch/tools/ (proto_mxu_search.py, gather_probe.py,
// layout_repro.py).

#include <torch/extension.h>

#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>

#include <algorithm>
#include <optional>
#include <vector>

#include "launchers.h"

namespace {

void check_tensor(const torch::Tensor& t, const char* name,
                  const torch::Tensor& like) {
    TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
    TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
    TORCH_CHECK(t.device() == like.device(), name, " is on ", t.device(),
                ", expected ", like.device());
}

void check_launch(int rc, const char* what) {
    TORCH_CHECK(rc == 0, what, " kernel launch failed: ",
                cudaGetErrorString(static_cast<cudaError_t>(rc)));
}

void* current_stream(const torch::Tensor& t) {
    return (void*)c10::cuda::getCurrentCUDAStream(t.get_device()).stream();
}

int as_int(int64_t v, const char* name) {
    TORCH_CHECK(v >= 0 && v < (int64_t(1) << 31), name, " out of int range");
    return (int)v;
}

// The tile plan of a K1, K3, K5 or K6 launch, as the wrapper computed it.
DptTilePlan tile_plan(int64_t td, int64_t ty, int64_t lead, int64_t threads,
                      const std::vector<int64_t>& grid, int64_t smem_bytes) {
    TORCH_CHECK(grid.size() == 3, "grid must be 3 ints");
    DptTilePlan plan;
    plan.td = as_int(td, "td");
    plan.ty = as_int(ty, "ty");
    plan.lead = as_int(lead, "lead");
    plan.threads = as_int(threads, "threads");
    for (int i = 0; i < 3; ++i) plan.grid[i] = as_int(grid[i], "grid");
    plan.smem_bytes = as_int(smem_bytes, "smem_bytes");
    return plan;
}

}  // namespace

// K1 on (B, H, W, 3) frames, K6 on (R, H, W) planes (one channel); K7's
// forms are its type pairs: u8 -> u8, f32 -> f32 and u8 -> f32.
void skew(torch::Tensor images, torch::Tensor out, int64_t s, int64_t td,
          int64_t ty, int64_t lead, int64_t threads, std::vector<int64_t> grid,
          int64_t smem_bytes) {
    check_tensor(images, "images", images);
    check_tensor(out, "out", images);
    const bool planes = images.dim() == 3;
    TORCH_CHECK(planes || (images.dim() == 4 && images.size(3) == 3),
                "images must be (B, H, W, 3) frames or (R, H, W) planes");
    const bool widen = images.scalar_type() == torch::kUInt8 &&
                       out.scalar_type() == torch::kFloat32;
    TORCH_CHECK(out.scalar_type() == images.scalar_type() || widen,
                "out must have the images' dtype, or float32 from uint8");
    TORCH_CHECK(s >= 1, "skew s must be >= 1");
    const int C = planes ? 1 : 3;
    const int B = as_int(images.size(0), "B");
    const int H = as_int(images.size(1), "H");
    const int W = as_int(images.size(2), "W");
    const int D = as_int(W + s * (H - 1), "D");
    TORCH_CHECK(out.dim() == 3 && out.size(0) == D && out.size(1) == C * B &&
                    out.size(2) == H,
                "out must be (W + s*(H-1), C*B, H)");
    const DptTilePlan plan = tile_plan(td, ty, lead, threads, grid, smem_bytes);
    const c10::cuda::CUDAGuard guard(images.device());
    int rc;
    if (widen) {
        rc = dpt_skew_u8_f32(images.data_ptr<uint8_t>(), out.data_ptr<float>(),
                             B, C, H, W, D, (int)s, plan, current_stream(images));
    } else if (images.scalar_type() == torch::kUInt8) {
        rc = dpt_skew_u8(images.data_ptr<uint8_t>(), out.data_ptr<uint8_t>(),
                         B, C, H, W, D, (int)s, plan, current_stream(images));
    } else {
        TORCH_CHECK(images.scalar_type() == torch::kFloat32,
                    "images must be uint8 or float32");
        rc = dpt_skew_f32(images.data_ptr<float>(), out.data_ptr<float>(), B,
                          C, H, W, D, (int)s, plan, current_stream(images));
    }
    check_launch(rc, "skew");
}

// The cluster fields of a scan launch: n blocks a frame, the palette's
// slice bounds (n + 1 ints, 0 .. P), the history's place and the wrapper's
// shared-memory budget.
void set_cluster(DptScanArgs& a, int64_t n, const std::vector<int64_t>& bounds,
                 int64_t ring, bool hist_smem, int64_t smem_bytes) {
    TORCH_CHECK(n >= 1 && n <= DPT_MAX_CLUSTER && (n & (n - 1)) == 0,
                "cluster size ", n, " must be 1, 2, 4 or 8");
    TORCH_CHECK((int64_t)bounds.size() == n + 1 && bounds.front() == 0 &&
                    bounds.back() == a.P,
                "slice bounds must be n + 1 ints from 0 to P");
    TORCH_CHECK(ring >= 1 && (ring & (ring - 1)) == 0,
                "ring must be a power of two");
    a.n = (int)n;
    a.max_slice = 0;
    for (int64_t r = 0; r <= n; ++r) {
        a.slices.lo[r] = (int)bounds[r];
        if (r > 0) {
            TORCH_CHECK(bounds[r] > bounds[r - 1], "slice ", r - 1, " is empty");
            a.max_slice = std::max(a.max_slice, (int)(bounds[r] - bounds[r - 1]));
        }
    }
    a.ring = (int)ring;
    a.hist_smem = hist_smem ? 1 : 0;
    a.smem_bytes = as_int(smem_bytes, "smem_bytes");
}

void ed_scan(torch::Tensor img, torch::Tensor palette,
             torch::Tensor palette_aug, torch::Tensor aux, torch::Tensor lut,
             torch::Tensor hist, torch::Tensor out, torch::Tensor offsets, torch::Tensor weights,
             torch::Tensor columns, int64_t mode, int64_t s, int64_t width,
             double lum_factor, double col_factor, bool emit_idx, int64_t n,
             std::vector<int64_t> bounds, int64_t ring, bool hist_smem,
             int64_t smem_bytes) {
    check_tensor(img, "img", img);
    check_tensor(palette, "palette", img);
    check_tensor(out, "out", img);
    TORCH_CHECK(mode >= 0 && mode < DPT_SCAN_MODES, "mode ", mode,
                " outside 0..", DPT_SCAN_MODES - 1);
    const bool ostromoukhov = mode == 1;
    const bool has_aux = mode == 3 || mode == 4;
    TORCH_CHECK(img.dim() == 3 && img.size(1) % 3 == 0,
                "img must be the (D, 3B, H) skewed stream");
    const int D = as_int(img.size(0), "D");
    const int B = as_int(img.size(1) / 3, "B");
    const int H = as_int(img.size(2), "H");
    const int W = as_int(width, "W");
    TORCH_CHECK(s >= 1 && D == W + s * (H - 1),
                "stream length must be W + s*(H-1)");
    TORCH_CHECK(palette.scalar_type() == torch::kFloat32 &&
                    palette.dim() == 2 && palette.size(1) == 3,
                "palette must be (P, 3) float32");
    const int P = as_int(palette.size(0), "P");
    TORCH_CHECK(P >= 1, "palette is empty");
    TORCH_CHECK(emit_idx || P <= DPT_MAX_PALETTE, "palette size ", P,
                " above ", DPT_MAX_PALETTE, ": the packed-colour scan does "
                "not serve it, the index scan does");
    TORCH_CHECK(P <= DPT_IDX_MAX_PALETTE, "palette size ", P, " above ",
                DPT_IDX_MAX_PALETTE, ": the index scan keeps its palette in "
                "shared memory");
    // An empty palette_aug asks for the exact search, a (P, 4) one for the
    // score search.
    const bool score = palette_aug.numel() != 0;
    if (score) {
        check_tensor(palette_aug, "palette_aug", img);
        TORCH_CHECK(palette_aug.scalar_type() == torch::kFloat32 &&
                        palette_aug.dim() == 2 && palette_aug.size(0) == P &&
                        palette_aug.size(1) == 4,
                    "palette_aug must be (P, 4) float32");
        TORCH_CHECK(P <= DPT_MAX_PALETTE, "palette size ", P, " above ",
                    DPT_MAX_PALETTE, ": the score search does not serve it");
    }
    const int C = (ostromoukhov || mode == 3) ? 4 : 3;
    DptScanArgs a{};
    a.P = P;
    set_cluster(a, n, bounds, ring, hist_smem, smem_bytes);
    if (hist_smem) {
        TORCH_CHECK(hist.numel() == 0, "hist must be empty when the history "
                                       "lives in shared memory");
    } else {
        check_tensor(hist, "hist", img);
        TORCH_CHECK(hist.scalar_type() == torch::kFloat32 && hist.dim() == 4 &&
                        hist.size(0) == (int64_t)B * n && hist.size(1) == ring &&
                        hist.size(2) == C && hist.size(3) == H,
                    "hist must be (B*n, ring, ", C, ", H) float32");
    }
    TORCH_CHECK(out.scalar_type() == torch::kInt32 && out.dim() == 3 &&
                    out.size(0) == D && out.size(1) == B && out.size(2) == H,
                "out must be (D, B, H) int32");
    if (has_aux) {
        check_tensor(aux, "aux", img);
        TORCH_CHECK(aux.scalar_type() == torch::kFloat32 && aux.dim() == 3 &&
                        aux.size(0) == B && aux.size(1) == H &&
                        aux.size(2) == W,
                    "aux must be (B, H, W) float32");
    } else {
        TORCH_CHECK(aux.numel() == 0, "this mode takes no aux map");
    }
    if (ostromoukhov) {
        check_tensor(lut, "lut", img);
        TORCH_CHECK(lut.scalar_type() == torch::kFloat32 && lut.dim() == 2 &&
                        lut.size(0) == 256 && lut.size(1) == 3,
                    "lut must be (256, 3) float32");
    } else {
        TORCH_CHECK(lut.numel() == 0, "this mode takes no weight table");
    }
    // The weight table stays on the host: it travels to the kernel by
    // value, in its launch parameters.
    TORCH_CHECK(offsets.device().is_cpu() && weights.device().is_cpu() &&
                    columns.device().is_cpu(),
                "offsets, weights and columns must be CPU tensors");
    TORCH_CHECK(offsets.scalar_type() == torch::kInt32 && offsets.dim() == 2 &&
                    offsets.size(1) == 2 && offsets.is_contiguous(),
                "offsets must be a contiguous (n, 2) int32 tensor");
    TORCH_CHECK(weights.scalar_type() == torch::kFloat32 &&
                    weights.dim() == 1 && weights.is_contiguous(),
                "weights must be a contiguous (n,) float32 tensor");
    TORCH_CHECK(columns.scalar_type() == torch::kInt32 &&
                    columns.dim() == 1 && columns.is_contiguous(),
                "columns must be a contiguous (n,) int32 tensor");
    const int64_t n_e = offsets.size(0);
    TORCH_CHECK(n_e >= 1 && n_e <= DPT_MAX_ENTRIES && weights.size(0) == n_e &&
                    columns.size(0) == n_e,
                "entries must be 1..", DPT_MAX_ENTRIES, " (dx, dy, w, column)");
    TORCH_CHECK(!ostromoukhov || n_e == 3, "ostromoukhov has 3 entries");
    const int32_t* off = offsets.data_ptr<int32_t>();
    const float* wts = weights.data_ptr<float>();
    const int32_t* cols = columns.data_ptr<int32_t>();
    a.e.n = (int)n_e;
    for (int64_t k = 0; k < n_e; ++k) {
        const int64_t dx = off[2 * k], dy = off[2 * k + 1];
        TORCH_CHECK(dy >= 0 && dx + s * dy >= 1 && dx + s * dy < ring,
                    "entry ", k, " violates the skew or ring bound");
        TORCH_CHECK(cols[k] >= 0 && cols[k] < n_e, "entry ", k,
                    " has column ", cols[k], " outside 0..", n_e - 1);
        a.e.dx[k] = (int)dx;
        a.e.dy[k] = (int)dy;
        a.e.w[k] = wts[k];
        a.e.col[k] = cols[k];
    }
    TORCH_CHECK(img.scalar_type() == torch::kUInt8 ||
                    img.scalar_type() == torch::kFloat32,
                "img must be uint8 or float32");
    a.img = img.data_ptr();
    a.img_is_f32 = img.scalar_type() == torch::kFloat32;
    a.pal = palette.data_ptr<float>();
    a.pal_aug = score ? palette_aug.data_ptr<float>() : nullptr;
    a.mode = (int)mode;
    a.aux = has_aux ? aux.data_ptr<float>() : nullptr;
    a.lut = ostromoukhov ? lut.data_ptr<float>() : nullptr;
    a.lum_factor = (float)lum_factor;
    a.col_factor = (float)col_factor;
    a.s = (int)s;
    a.B = B;
    a.H = H;
    a.W = W;
    a.D = D;
    a.hist = hist_smem ? nullptr : hist.data_ptr<float>();
    a.out = out.data_ptr<int32_t>();
    a.emit_idx = emit_idx ? 1 : 0;
    a.capacity = nullptr;
    const c10::cuda::CUDAGuard guard(img.device());
    check_launch(dpt_ed_scan(a, current_stream(img)),
                 emit_idx ? "ed_scan_idx" : "ed_scan");
}

// How many clusters of n blocks of the scan the current device holds at
// once (cudaOccupancyMaxActiveClusters) for the launch that ed_scan would
// make with these arguments; launches nothing.
int64_t ed_scan_capacity(bool img_f32, int64_t mode, bool emit_idx,
                         bool score, int64_t P, int64_t H, int64_t n,
                         std::vector<int64_t> bounds, int64_t ring,
                         bool hist_smem, int64_t smem_bytes) {
    TORCH_CHECK(mode >= 0 && mode < DPT_SCAN_MODES, "mode ", mode,
                " outside 0..", DPT_SCAN_MODES - 1);
    DptScanArgs a{};
    a.img_is_f32 = img_f32 ? 1 : 0;
    a.mode = (int)mode;
    a.emit_idx = emit_idx ? 1 : 0;
    static float dummy;
    a.pal_aug = score ? &dummy : nullptr;
    a.P = as_int(P, "P");
    a.H = as_int(H, "H");
    a.B = 1;
    set_cluster(a, n, bounds, ring, hist_smem, smem_bytes);
    int clusters = 0;
    a.capacity = &clusters;
    check_launch(dpt_ed_scan(a, nullptr), "ed_scan_capacity");
    return clusters;
}

// K3 (kind 0 NHWC, 1 planar: uint8 colours), K5 (kind 2, 3: the uint8 or
// uint16 index stream) and K9 (kind 4: the colours of palette indices, with
// the (P, 3) float32 palette and a (P,) int32 scratch for its packed form),
// one tile transpose of the (D, B, H) int32 stream.
void unskew(torch::Tensor col, torch::Tensor out, int64_t s, int64_t kind, int64_t td,
            int64_t ty, int64_t lead, int64_t threads, std::vector<int64_t> grid,
            int64_t smem_bytes, std::optional<torch::Tensor> palette,
            std::optional<torch::Tensor> table) {
    check_tensor(col, "col", col);
    check_tensor(out, "out", col);
    TORCH_CHECK(col.scalar_type() == torch::kInt32 && col.dim() == 3,
                "col must be (D, B, H) int32");
    TORCH_CHECK(kind >= 0 && kind <= 4,
                "kind must be 0 (NHWC), 1 (planar), 2 (u8), 3 (u16) or 4 (select)");
    const bool planar = kind == 1;
    const bool select = kind == 4;
    if (kind <= 1 || select) {
        TORCH_CHECK(out.scalar_type() == torch::kUInt8 && out.dim() == 4 &&
                        out.size(planar ? 0 : 3) == 3,
                    planar ? "out must be (3, B, H, W) uint8"
                           : "out must be (B, H, W, 3) uint8");
    } else {
        TORCH_CHECK(out.dim() == 3 && out.scalar_type() == (kind == 2
                                                                ? torch::kUInt8
                                                                : c10::ScalarType::UInt16),
                    kind == 2 ? "out must be (B, H, W) uint8" : "out must be (B, H, W) uint16");
    }
    TORCH_CHECK(select == (palette.has_value() && table.has_value()),
                select ? "the select kind takes a palette and a table"
                       : "only the select kind takes a palette and a table");
    const float* pal = nullptr;
    uint32_t* tab = nullptr;
    int P = 0;
    if (select) {
        check_tensor(*palette, "palette", col);
        check_tensor(*table, "table", col);
        TORCH_CHECK(palette->scalar_type() == torch::kFloat32 && palette->dim() == 2 &&
                        palette->size(1) == 3 && palette->size(0) >= 1 &&
                        palette->size(0) <= DPT_IDX_MAX_PALETTE,
                    "palette must be (P, 3) float32, P in 1..", DPT_IDX_MAX_PALETTE);
        P = as_int(palette->size(0), "P");
        TORCH_CHECK(table->scalar_type() == torch::kInt32 && table->dim() == 1 &&
                        table->size(0) == P,
                    "table must be (P,) int32");
        pal = palette->data_ptr<float>();
        tab = reinterpret_cast<uint32_t*>(table->data_ptr<int32_t>());
    }
    const int lead_dims = planar ? 1 : 0;
    const int B = as_int(out.size(lead_dims), "B");
    const int H = as_int(out.size(lead_dims + 1), "H");
    const int W = as_int(out.size(lead_dims + 2), "W");
    TORCH_CHECK(s >= 1 && col.size(0) >= W + s * (H - 1) &&
                    col.size(1) == B && col.size(2) == H,
                "col must be (>= W + s*(H-1), B, H)");
    const DptTilePlan plan = tile_plan(td, ty, lead, threads, grid, smem_bytes);
    const c10::cuda::CUDAGuard guard(col.device());
    check_launch(dpt_unskew(col.data_ptr<int32_t>(), out.data_ptr(), B, H, W, (int)s,
                            (int)kind, plan, pal, P, tab, current_stream(col)),
                 select ? "unskew_select" : kind <= 1 ? "unskew_unpack" : "unskew_idx");
}

void search_probe(torch::Tensor cur, torch::Tensor palette, torch::Tensor out,
                  int64_t iters, bool score, int64_t n, std::vector<int64_t> bounds) {
    check_tensor(cur, "cur", cur);
    check_tensor(palette, "palette", cur);
    check_tensor(out, "out", cur);
    TORCH_CHECK(cur.scalar_type() == torch::kFloat32 && cur.dim() == 2 &&
                    cur.size(0) % 3 == 0,
                "cur must be the (3*nb, lf) float32 working tile");
    const int nb = as_int(cur.size(0) / 3, "nb");
    const int lf = as_int(cur.size(1), "lf");
    const int width = score ? 4 : 3;
    TORCH_CHECK(palette.scalar_type() == torch::kFloat32 &&
                    palette.dim() == 2 && palette.size(1) == width &&
                    palette.size(0) >= 1 &&
                    palette.size(0) <= DPT_PROBE_MAX_PALETTE,
                "palette must be (pp, ", width, ") float32, pp in 1..",
                DPT_PROBE_MAX_PALETTE);
    TORCH_CHECK(out.scalar_type() == torch::kInt32 && out.dim() == 2 &&
                    out.size(0) == nb && out.size(1) == lf,
                "out must be (nb, lf) int32");
    TORCH_CHECK(iters >= 1, "iters must be >= 1");
    TORCH_CHECK(n >= 1 && n <= DPT_MAX_CLUSTER && (int64_t)bounds.size() == n + 1,
                "search_probe takes n in 1..", DPT_MAX_CLUSTER, " and n + 1 slice bounds");
    DptSlices sl = {};
    for (int64_t r = 0; r <= n; ++r) sl.lo[r] = as_int(bounds[r], "slice bound");
    const c10::cuda::CUDAGuard guard(cur.device());
    check_launch(dpt_search_probe(cur.data_ptr<float>(),
                                  palette.data_ptr<float>(),
                                  as_int(palette.size(0), "pp"), nb, lf,
                                  as_int(iters, "iters"), score ? 1 : 0, (int)n, sl,
                                  out.data_ptr<int32_t>(),
                                  current_stream(cur)),
                 "search_probe");
}

void ordered_fused(torch::Tensor images, torch::Tensor palette,
                   torch::Tensor screen, torch::Tensor out,
                   bool return_indices, int64_t threads, int64_t pixels,
                   int64_t frames, std::vector<int64_t> grid, int64_t smem_bytes) {
    check_tensor(images, "images", images);
    check_tensor(palette, "palette", images);
    check_tensor(screen, "screen", images);
    check_tensor(out, "out", images);
    const bool f32 = images.scalar_type() == torch::kFloat32;
    TORCH_CHECK((f32 || images.scalar_type() == torch::kUInt8) &&
                    images.dim() == 4 && images.size(3) == 3,
                "images must be (B, H, W, 3) uint8 or float32");
    const int B = as_int(images.size(0), "B");
    const int H = as_int(images.size(1), "H");
    const int W = as_int(images.size(2), "W");
    TORCH_CHECK(palette.scalar_type() == torch::kFloat32 &&
                    palette.dim() == 2 && palette.size(1) == 3,
                "palette must be (P, 3) float32");
    const int max_p = return_indices ? 256 : DPT_ORDERED_MAX_PALETTE;
    const int P = as_int(palette.size(0), "P");
    TORCH_CHECK(P >= 1 && P <= max_p, "palette size ", P, " outside 1..",
                max_p);
    TORCH_CHECK(screen.scalar_type() == torch::kFloat32 && screen.dim() == 2 &&
                    screen.size(0) == H && screen.size(1) == W,
                "screen must be (H, W) float32");
    TORCH_CHECK(out.scalar_type() == torch::kUInt8, "out must be uint8");
    if (return_indices) {
        TORCH_CHECK(out.dim() == 3 && out.size(0) == B && out.size(1) == H &&
                        out.size(2) == W,
                    "out must be (B, H, W) for indices");
    } else {
        TORCH_CHECK(out.sizes() == images.sizes(),
                    "out must be (B, H, W, 3) for colours");
    }
    TORCH_CHECK(grid.size() == 3, "grid must be 3 ints");
    DptOrderedPlan plan;
    plan.threads = as_int(threads, "threads");
    plan.pixels = as_int(pixels, "pixels");
    plan.frames = as_int(frames, "frames");
    for (int i = 0; i < 3; ++i) plan.grid[i] = as_int(grid[i], "grid");
    plan.smem_bytes = as_int(smem_bytes, "smem_bytes");
    const c10::cuda::CUDAGuard guard(images.device());
    const int emit_idx = return_indices ? 1 : 0;
    int rc;
    if (f32) {
        rc = dpt_ordered_fused_f32(images.data_ptr<float>(),
                                   palette.data_ptr<float>(), P,
                                   screen.data_ptr<float>(), B, H, W,
                                   out.data_ptr<uint8_t>(), emit_idx, plan,
                                   current_stream(images));
    } else {
        rc = dpt_ordered_fused_u8(images.data_ptr<uint8_t>(),
                                  palette.data_ptr<float>(), P,
                                  screen.data_ptr<float>(), B, H, W,
                                  out.data_ptr<uint8_t>(), emit_idx, plan,
                                  current_stream(images));
    }
    check_launch(rc, "ordered_fused");
}

void gather_chain(torch::Tensor table, torch::Tensor idx, torch::Tensor out,
                  int64_t k, int64_t update, int64_t form, int64_t cluster,
                  int64_t rows_per_block, int64_t slab_rows, int64_t threads, int64_t grid,
                  int64_t smem_bytes) {
    check_tensor(table, "table", table);
    check_tensor(idx, "idx", table);
    check_tensor(out, "out", table);
    TORCH_CHECK(table.scalar_type() == torch::kInt32 && table.dim() == 2,
                "table must be (rows, lanes) int32");
    TORCH_CHECK(idx.scalar_type() == torch::kInt32 && idx.dim() == 2 &&
                    idx.size(1) == table.size(1),
                "idx must be (n, lanes) int32");
    TORCH_CHECK(out.scalar_type() == torch::kInt32 &&
                    out.sizes() == idx.sizes(),
                "out must be (n, lanes) int32");
    DptGatherPlan plan;
    plan.form = as_int(form, "form");
    plan.cluster = as_int(cluster, "cluster");
    plan.rows_per_block = as_int(rows_per_block, "rows_per_block");
    plan.slab_rows = as_int(slab_rows, "slab_rows");
    plan.threads = as_int(threads, "threads");
    plan.grid = as_int(grid, "grid");
    plan.smem_bytes = as_int(smem_bytes, "smem_bytes");
    const c10::cuda::CUDAGuard guard(table.device());
    check_launch(dpt_gather_chain(table.data_ptr<int32_t>(), idx.data_ptr<int32_t>(),
                                  out.data_ptr<int32_t>(),
                                  as_int(table.size(0), "rows"),
                                  as_int(idx.size(0), "n"),
                                  as_int(table.size(1), "lanes"),
                                  as_int(k, "k"), as_int(update, "update"),
                                  plan, current_stream(table)),
                 "gather_chain");
}

void empty_kernel(torch::Tensor like) {
    TORCH_CHECK(like.is_cuda(), "like must be a CUDA tensor");
    const c10::cuda::CUDAGuard guard(like.device());
    check_launch(dpt_empty_kernel(current_stream(like)), "empty_kernel");
}

void sweep_chain(torch::Tensor table, torch::Tensor idx, torch::Tensor out,
                 int64_t k, bool use_smem) {
    check_tensor(table, "table", table);
    check_tensor(idx, "idx", table);
    check_tensor(out, "out", table);
    TORCH_CHECK(table.scalar_type() == torch::kInt32 && table.dim() == 2,
                "table must be (P, lanes) int32");
    TORCH_CHECK(idx.scalar_type() == torch::kInt32 && idx.dim() == 2 &&
                    idx.size(1) == table.size(1),
                "idx must be (n, lanes) int32");
    TORCH_CHECK(out.scalar_type() == torch::kInt32 &&
                    out.sizes() == idx.sizes(),
                "out must be (n, lanes) int32");
    const c10::cuda::CUDAGuard guard(table.device());
    check_launch(dpt_sweep_chain(table.data_ptr<int32_t>(),
                                 idx.data_ptr<int32_t>(),
                                 out.data_ptr<int32_t>(),
                                 as_int(table.size(0), "P"),
                                 as_int(idx.size(0), "n"),
                                 as_int(table.size(1), "lanes"),
                                 as_int(k, "k"), use_smem ? 1 : 0,
                                 current_stream(table)),
                 "sweep_chain");
}

void identity_u8(torch::Tensor in, torch::Tensor out, int64_t form, int64_t head,
                 int64_t body, int64_t span, int64_t blocks, int64_t threads) {
    check_tensor(in, "in", in);
    check_tensor(out, "out", in);
    TORCH_CHECK(in.scalar_type() == torch::kUInt8 &&
                    out.scalar_type() == torch::kUInt8 &&
                    out.sizes() == in.sizes(),
                "in and out must be uint8 tensors of one shape");
    DptIdentityPlan plan;
    plan.form = as_int(form, "form");
    plan.head = head;
    plan.body = body;
    plan.span = span;
    plan.blocks = blocks;
    plan.threads = as_int(threads, "threads");
    const c10::cuda::CUDAGuard guard(in.device());
    check_launch(dpt_identity_u8(in.data_ptr<uint8_t>(), out.data_ptr<uint8_t>(), in.numel(),
                                 plan, current_stream(in)),
                 "identity_u8");
}

// R1 on (B, H, W, 3) uint8 or float32 frames along the curve's order and
// receiver masks into (B, H, W, 3) uint8 colours.
void riemersma_scan(torch::Tensor frames, torch::Tensor pal, torch::Tensor order,
                    torch::Tensor mask, torch::Tensor out) {
    check_tensor(frames, "frames", frames);
    check_tensor(pal, "pal", frames);
    check_tensor(order, "order", frames);
    check_tensor(mask, "mask", frames);
    check_tensor(out, "out", frames);
    TORCH_CHECK(frames.dim() == 4 && frames.size(3) == 3, "frames must be (B, H, W, 3)");
    const bool f32 = frames.scalar_type() == torch::kFloat32;
    TORCH_CHECK(f32 || frames.scalar_type() == torch::kUInt8,
                "frames must be uint8 or float32");
    TORCH_CHECK(pal.scalar_type() == torch::kFloat32 && pal.dim() == 2 && pal.size(1) == 3 &&
                    pal.size(0) >= 1 && pal.size(0) <= DPT_RIEMERSMA_MAX_PALETTE,
                "pal must be (P, 3) float32 with 1 <= P <= ", DPT_RIEMERSMA_MAX_PALETTE);
    const int64_t hw = frames.size(1) * frames.size(2);
    TORCH_CHECK(order.scalar_type() == torch::kInt32 && order.dim() == 1 &&
                    order.size(0) >= 1 && order.size(0) <= hw,
                "order must be (N,) int32 with 1 <= N <= H*W");
    TORCH_CHECK(mask.scalar_type() == torch::kUInt8 && mask.sizes() == order.sizes(),
                "mask must be (N,) uint8");
    TORCH_CHECK(out.scalar_type() == torch::kUInt8 && out.sizes() == frames.sizes(),
                "out must be uint8 of the frames' shape");
    const c10::cuda::CUDAGuard guard(frames.device());
    check_launch(dpt_riemersma_scan(frames.data_ptr(), f32 ? 1 : 0, pal.data_ptr<float>(),
                                    as_int(pal.size(0), "P"), order.data_ptr<int32_t>(),
                                    mask.data_ptr<uint8_t>(), as_int(order.size(0), "N"),
                                    as_int(frames.size(0), "B"), hw,
                                    out.data_ptr<uint8_t>(), current_stream(frames)),
                 "riemersma_scan");
}

// R1's latency probe into `out`, 10 int64 on the card (riemersma_scan.cu).
void riemersma_latency(torch::Tensor out, int64_t iters) {
    check_tensor(out, "out", out);
    TORCH_CHECK(out.scalar_type() == torch::kInt64 && out.numel() == 10,
                "out must be 10 int64");
    const c10::cuda::CUDAGuard guard(out.device());
    check_launch(dpt_riemersma_latency(as_int(iters, "iters"),
                                       reinterpret_cast<long long*>(out.data_ptr<int64_t>()),
                                       current_stream(out)),
                 "riemersma_latency");
}

int64_t riemersma_smem_bytes(int64_t P) { return dpt_riemersma_smem_bytes(as_int(P, "P")); }

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
    m.def("skew", &skew,
          "K1 / K6 / K7: (B,H,W,3) frames or (R,H,W) planes -> (D,3B,H) or "
          "(D,R,H) skewed stream, the images' dtype or float32 from uint8");
    m.def("ed_scan", &ed_scan,
          "K2 / K8: wavefront scan, every mode -> (D,B,H) packed colours or "
          "palette indices");
    m.def("ed_scan_capacity", &ed_scan_capacity,
          "K2 / K8: clusters of n blocks the device holds at once");
    m.def("unskew", &unskew,
          "K3 / K5 / K9: (D,B,H) int32 -> (B,H,W,3) or planar (3,B,H,W) uint8 colours, the "
          "(B,H,W) uint8 or uint16 index stream, or the (B,H,W,3) colours of palette indices",
          py::arg("col"), py::arg("out"), py::arg("s"), py::arg("kind"), py::arg("td"),
          py::arg("ty"), py::arg("lead"), py::arg("threads"), py::arg("grid"),
          py::arg("smem_bytes"), py::arg("palette") = py::none(),
          py::arg("table") = py::none());
    m.def("search_probe", &search_probe,
          "T2: exact or scored palette search over a (3*nb, lf) tile, "
          "repeated iters times, a frame over a cluster of n blocks -> (nb, lf) "
          "int32");
    m.def("ordered_fused", &ordered_fused,
          "K4: ordered dither (B,H,W,3) uint8 or float32 -> colours or "
          "indices");
    m.def("gather_chain", &gather_chain,
          "T1: k dependent per-lane table gathers an element, (n, lanes) "
          "int32, in the plan's form (device, block, multicast slabs or lane columns; "
          "the device form at any k is the L2 line)",
          py::arg("table"), py::arg("idx"), py::arg("out"), py::arg("k"), py::arg("update"),
          py::arg("form"), py::arg("cluster"), py::arg("rows_per_block"),
          py::arg("slab_rows"), py::arg("threads"), py::arg("grid"), py::arg("smem_bytes"));
    m.def("empty_kernel", &empty_kernel,
          "T1's floor: an empty kernel of one warp on the device of `like`");
    m.def("sweep_chain", &sweep_chain,
          "T1: k select sweeps over the table's P rows an element, "
          "(n, lanes) int32");
    m.def("identity_u8", &identity_u8,
          "T3: identity copy of a uint8 tensor, as its plan cuts it");
    m.def("riemersma_scan", &riemersma_scan,
          "R1: Riemersma along the Hilbert curve, (B,H,W,3) uint8 or float32 frames -> "
          "(B,H,W,3) uint8 colours, a chain warp and a producer warp a frame");
    m.def("riemersma_latency", &riemersma_latency,
          "R1's probe: clock64 latencies of its dependent path's instructions, one warp");
    m.def("riemersma_smem_bytes", &riemersma_smem_bytes,
          "R1's dynamic shared memory at P colours");
}
