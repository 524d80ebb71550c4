// PyTorch binding of the port's kernels (the only source that includes
// PyTorch's headers). Each function checks device, dtype, shape and
// contiguity, launches on PyTorch's current stream of the tensor's device,
// and raises if the launch is refused. Outputs and scratch are allocated
// by the Python wrappers in dither_pie_tpu_torch/ops/wavefront.py (K1-K3,
// K5-K9), dither_pie_tpu_torch/ops/ordered_fused.py (K4) and the probes in
// dither_pie_tpu_torch/tools/ (proto_mxu_search.py, gather_probe.py,
// layout_repro.py).

#include <torch/extension.h>

#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>

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

}  // namespace

void skew(torch::Tensor images, torch::Tensor out, int64_t s) {
    check_tensor(images, "images", images);
    check_tensor(out, "out", images);
    TORCH_CHECK(images.dim() == 4 && images.size(3) == 3,
                "images must be (B, H, W, 3)");
    TORCH_CHECK(out.scalar_type() == images.scalar_type(),
                "out must have the images' dtype");
    TORCH_CHECK(s >= 1, "skew s must be >= 1");
    const int B = as_int(images.size(0), "B");
    const int H = as_int(images.size(1), "H");
    const int W = as_int(images.size(2), "W");
    const int D = as_int(W + s * (H - 1), "D");
    TORCH_CHECK(out.dim() == 3 && out.size(0) == D && out.size(1) == 3 * B &&
                    out.size(2) == H,
                "out must be (W + s*(H-1), 3B, H)");
    const c10::cuda::CUDAGuard guard(images.device());
    int rc;
    if (images.scalar_type() == torch::kUInt8) {
        rc = dpt_skew_u8(images.data_ptr<uint8_t>(), out.data_ptr<uint8_t>(),
                         B, H, W, D, (int)s, current_stream(images));
    } else {
        TORCH_CHECK(images.scalar_type() == torch::kFloat32,
                    "images must be uint8 or float32");
        rc = dpt_skew_f32(images.data_ptr<float>(), out.data_ptr<float>(), B,
                          H, W, D, (int)s, current_stream(images));
    }
    check_launch(rc, "skew");
}

void ed_scan(torch::Tensor img, torch::Tensor palette,
             torch::Tensor palette_aug, torch::Tensor aux, torch::Tensor lut,
             torch::Tensor hist, torch::Tensor out, torch::Tensor offsets, torch::Tensor weights,
             torch::Tensor columns, int64_t mode, int64_t s, int64_t width,
             double lum_factor, double col_factor, bool emit_idx) {
    check_tensor(img, "img", img);
    check_tensor(palette, "palette", img);
    check_tensor(hist, "hist", img);
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
    TORCH_CHECK(hist.scalar_type() == torch::kFloat32 && hist.dim() == 4 &&
                    hist.size(0) == B && hist.size(2) == C &&
                    hist.size(3) == H,
                "hist must be (B, ring, ", C, ", H) float32");
    const int ring = as_int(hist.size(1), "ring");
    TORCH_CHECK(ring >= 1 && (ring & (ring - 1)) == 0,
                "ring must be a power of two");
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
    const int64_t n = offsets.size(0);
    TORCH_CHECK(n >= 1 && n <= DPT_MAX_ENTRIES && weights.size(0) == n &&
                    columns.size(0) == n,
                "entries must be 1..", DPT_MAX_ENTRIES, " (dx, dy, w, column)");
    TORCH_CHECK(!ostromoukhov || n == 3, "ostromoukhov has 3 entries");
    const int32_t* off = offsets.data_ptr<int32_t>();
    const float* wts = weights.data_ptr<float>();
    const int32_t* cols = columns.data_ptr<int32_t>();
    DptScanArgs a{};
    a.e.n = (int)n;
    for (int64_t k = 0; k < n; ++k) {
        const int64_t dx = off[2 * k], dy = off[2 * k + 1];
        TORCH_CHECK(dy >= 0 && dx + s * dy >= 1 && dx + s * dy < ring,
                    "entry ", k, " violates the skew or ring bound");
        TORCH_CHECK(cols[k] >= 0 && cols[k] < n, "entry ", k,
                    " has column ", cols[k], " outside 0..", n - 1);
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
    a.P = P;
    a.mode = (int)mode;
    a.aux = has_aux ? aux.data_ptr<float>() : nullptr;
    a.lut = ostromoukhov ? lut.data_ptr<float>() : nullptr;
    a.lum_factor = (float)lum_factor;
    a.col_factor = (float)col_factor;
    a.s = (int)s;
    a.ring = ring;
    a.B = B;
    a.H = H;
    a.W = W;
    a.D = D;
    a.hist = hist.data_ptr<float>();
    a.out = out.data_ptr<int32_t>();
    a.emit_idx = emit_idx ? 1 : 0;
    const c10::cuda::CUDAGuard guard(img.device());
    check_launch(dpt_ed_scan(a, current_stream(img)),
                 emit_idx ? "ed_scan_idx" : "ed_scan");
}

void unskew_unpack(torch::Tensor col, torch::Tensor out, int64_t s,
                   bool planar) {
    check_tensor(col, "col", col);
    check_tensor(out, "out", col);
    TORCH_CHECK(col.scalar_type() == torch::kInt32 && col.dim() == 3,
                "col must be (D, B, H) int32");
    TORCH_CHECK(out.scalar_type() == torch::kUInt8 && out.dim() == 4 &&
                    out.size(planar ? 0 : 3) == 3,
                planar ? "out must be (3, B, H, W) uint8"
                       : "out must be (B, H, W, 3) uint8");
    const int B = as_int(out.size(planar ? 1 : 0), "B");
    const int H = as_int(out.size(planar ? 2 : 1), "H");
    const int W = as_int(out.size(planar ? 3 : 2), "W");
    TORCH_CHECK(s >= 1 && col.size(0) >= W + s * (H - 1) &&
                    col.size(1) == B && col.size(2) == H,
                "col must be (>= W + s*(H-1), B, H)");
    const c10::cuda::CUDAGuard guard(col.device());
    check_launch(dpt_unskew_unpack(col.data_ptr<int32_t>(),
                                   out.data_ptr<uint8_t>(), B, H, W, (int)s,
                                   planar ? 1 : 0, current_stream(col)),
                 "unskew_unpack");
}

void unskew_idx(torch::Tensor idx, torch::Tensor out, int64_t s) {
    check_tensor(idx, "idx", idx);
    check_tensor(out, "out", idx);
    TORCH_CHECK(idx.scalar_type() == torch::kInt32 && idx.dim() == 3,
                "idx must be (D, B, H) int32");
    TORCH_CHECK(out.dim() == 3, "out must be (B, H, W)");
    const int B = as_int(out.size(0), "B");
    const int H = as_int(out.size(1), "H");
    const int W = as_int(out.size(2), "W");
    TORCH_CHECK(s >= 1 && idx.size(0) >= W + s * (H - 1) &&
                    idx.size(1) == B && idx.size(2) == H,
                "idx must be (>= W + s*(H-1), B, H)");
    const c10::cuda::CUDAGuard guard(idx.device());
    int rc;
    if (out.scalar_type() == torch::kUInt8) {
        rc = dpt_unskew_idx_u8(idx.data_ptr<int32_t>(),
                               out.data_ptr<uint8_t>(), B, H, W, (int)s,
                               current_stream(idx));
    } else {
        TORCH_CHECK(out.scalar_type() == c10::ScalarType::UInt16,
                    "out must be uint8 or uint16");
        rc = dpt_unskew_idx_u16(idx.data_ptr<int32_t>(),
                                static_cast<uint16_t*>(out.data_ptr()), B, H,
                                W, (int)s, current_stream(idx));
    }
    check_launch(rc, "unskew_idx");
}

void skew_planar(torch::Tensor planes, torch::Tensor out, int64_t s) {
    check_tensor(planes, "planes", planes);
    check_tensor(out, "out", planes);
    TORCH_CHECK(planes.dim() == 3, "planes must be (R, H, W)");
    TORCH_CHECK(out.scalar_type() == planes.scalar_type(),
                "out must have the planes' dtype");
    TORCH_CHECK(s >= 1, "skew s must be >= 1");
    const int R = as_int(planes.size(0), "R");
    const int H = as_int(planes.size(1), "H");
    const int W = as_int(planes.size(2), "W");
    const int D = as_int(W + s * (H - 1), "D");
    TORCH_CHECK(out.dim() == 3 && out.size(0) == D && out.size(1) == R &&
                    out.size(2) == H,
                "out must be (W + s*(H-1), R, H)");
    const c10::cuda::CUDAGuard guard(planes.device());
    int rc;
    if (planes.scalar_type() == torch::kUInt8) {
        rc = dpt_skew_planar_u8(planes.data_ptr<uint8_t>(),
                                out.data_ptr<uint8_t>(), R, H, W, D, (int)s,
                                current_stream(planes));
    } else {
        TORCH_CHECK(planes.scalar_type() == torch::kFloat32,
                    "planes must be uint8 or float32");
        rc = dpt_skew_planar_f32(planes.data_ptr<float>(),
                                 out.data_ptr<float>(), R, H, W, D, (int)s,
                                 current_stream(planes));
    }
    check_launch(rc, "skew_planar");
}

void skew_transpose(torch::Tensor in, torch::Tensor out, int64_t s,
                    int64_t width) {
    // `in` is a strided view, (R, H, D) or (C, B, H, D) with rows c*B + b,
    // of any non-negative strides: it is read in place.
    TORCH_CHECK(in.is_cuda(), "in must be a CUDA tensor");
    check_tensor(out, "out", in);
    TORCH_CHECK(in.dim() == 3 || in.dim() == 4,
                "in must be (R, H, D) or (C, B, H, D)");
    const bool split = in.dim() == 4;
    const int rows_inner = as_int(split ? in.size(1) : 1, "B");
    const int R = as_int(split ? in.size(0) * in.size(1) : in.size(0), "R");
    const int H = as_int(in.size(split ? 2 : 1), "H");
    const int D = as_int(in.size(split ? 3 : 2), "D");
    const int W = as_int(width, "W");
    TORCH_CHECK(s >= 1 && W >= 1 && D == W + s * (H - 1),
                "the view's last axis must be W + s*(H-1) long");
    TORCH_CHECK(out.dim() == 3 && out.size(0) == D && out.size(1) == R &&
                    out.size(2) == H,
                "out must be (D, R, H)");
    const int64_t stride_outer = in.stride(0);
    const int64_t stride_inner = split ? in.stride(1) : 0;
    const int64_t stride_y = in.stride(split ? 2 : 1);
    const int64_t stride_d = in.stride(split ? 3 : 2);
    // The view may overlap itself, never leave its storage.
    int64_t last = in.storage_offset();
    for (int64_t i = 0; i < in.dim(); ++i) {
        TORCH_CHECK(in.stride(i) >= 0, "in has a negative stride on axis ", i);
        last += (in.size(i) - 1) * in.stride(i);
    }
    TORCH_CHECK(in.numel() > 0 &&
                    (last + 1) * (int64_t)in.element_size() <=
                        (int64_t)in.storage().nbytes(),
                "the view reads past the end of its storage");
    const c10::cuda::CUDAGuard guard(in.device());
    void* stream = current_stream(in);
    int rc;
    if (in.scalar_type() == torch::kUInt8 &&
        out.scalar_type() == torch::kUInt8) {
        rc = dpt_skew_transpose_u8(in.data_ptr<uint8_t>(),
                                   out.data_ptr<uint8_t>(), R, rows_inner,
                                   stride_outer, stride_inner, stride_y,
                                   stride_d, H, W, D, (int)s, stream);
    } else if (in.scalar_type() == torch::kFloat32 &&
               out.scalar_type() == torch::kFloat32) {
        rc = dpt_skew_transpose_f32(in.data_ptr<float>(),
                                    out.data_ptr<float>(), R, rows_inner,
                                    stride_outer, stride_inner, stride_y,
                                    stride_d, H, W, D, (int)s, stream);
    } else {
        TORCH_CHECK(in.scalar_type() == torch::kUInt8 &&
                        out.scalar_type() == torch::kFloat32,
                    "skew_transpose serves uint8 -> uint8, float32 -> "
                    "float32 and uint8 -> float32");
        rc = dpt_skew_transpose_u8_f32(in.data_ptr<uint8_t>(),
                                       out.data_ptr<float>(), R, rows_inner,
                                       stride_outer, stride_inner, stride_y,
                                       stride_d, H, W, D, (int)s, stream);
    }
    check_launch(rc, "skew_transpose");
}

void search_probe(torch::Tensor cur, torch::Tensor palette, torch::Tensor out,
                  int64_t iters, bool score) {
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
    const c10::cuda::CUDAGuard guard(cur.device());
    check_launch(dpt_search_probe(cur.data_ptr<float>(),
                                  palette.data_ptr<float>(),
                                  as_int(palette.size(0), "pp"), nb, lf,
                                  as_int(iters, "iters"), score ? 1 : 0,
                                  out.data_ptr<int32_t>(),
                                  current_stream(cur)),
                 "search_probe");
}

void unskew_select(torch::Tensor idx, torch::Tensor palette,
                   torch::Tensor out, int64_t s) {
    check_tensor(idx, "idx", idx);
    check_tensor(palette, "palette", idx);
    check_tensor(out, "out", idx);
    TORCH_CHECK(idx.scalar_type() == torch::kInt32 && idx.dim() == 3,
                "idx must be (D, B, H) int32");
    TORCH_CHECK(palette.scalar_type() == torch::kFloat32 &&
                    palette.dim() == 2 && palette.size(1) == 3 &&
                    palette.size(0) >= 1,
                "palette must be (P, 3) float32");
    TORCH_CHECK(out.scalar_type() == torch::kUInt8 && out.dim() == 4 &&
                    out.size(3) == 3,
                "out must be (B, H, W, 3) uint8");
    const int B = as_int(out.size(0), "B");
    const int H = as_int(out.size(1), "H");
    const int W = as_int(out.size(2), "W");
    TORCH_CHECK(s >= 1 && idx.size(0) >= W + s * (H - 1) &&
                    idx.size(1) == B && idx.size(2) == H,
                "idx must be (>= W + s*(H-1), B, H)");
    const c10::cuda::CUDAGuard guard(idx.device());
    check_launch(dpt_unskew_select(idx.data_ptr<int32_t>(),
                                   palette.data_ptr<float>(),
                                   out.data_ptr<uint8_t>(), B, H, W, (int)s,
                                   current_stream(idx)),
                 "unskew_select");
}

void ordered_fused(torch::Tensor images, torch::Tensor palette,
                   torch::Tensor screen, torch::Tensor out,
                   bool return_indices) {
    check_tensor(images, "images", images);
    check_tensor(palette, "palette", images);
    check_tensor(screen, "screen", images);
    check_tensor(out, "out", images);
    const bool f32 = images.scalar_type() == torch::kFloat32;
    TORCH_CHECK((f32 || images.scalar_type() == torch::kUInt8) &&
                    images.dim() == 4 && images.size(3) == 3,
                "images must be (B, H, W, 3) uint8 or float32");
    const int64_t B = images.size(0), H = images.size(1), W = images.size(2);
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
    const c10::cuda::CUDAGuard guard(images.device());
    const int emit_idx = return_indices ? 1 : 0;
    int rc;
    if (f32) {
        rc = dpt_ordered_fused_f32(images.data_ptr<float>(),
                                   palette.data_ptr<float>(), P,
                                   screen.data_ptr<float>(), B * H * W, H * W,
                                   out.data_ptr<uint8_t>(), emit_idx,
                                   current_stream(images));
    } else {
        rc = dpt_ordered_fused_u8(images.data_ptr<uint8_t>(),
                                  palette.data_ptr<float>(), P,
                                  screen.data_ptr<float>(), B * H * W, H * W,
                                  out.data_ptr<uint8_t>(), emit_idx,
                                  current_stream(images));
    }
    check_launch(rc, "ordered_fused");
}

void gather_chain(torch::Tensor table, torch::Tensor idx, torch::Tensor out,
                  int64_t k, int64_t update, bool use_smem) {
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
    const c10::cuda::CUDAGuard guard(table.device());
    check_launch(dpt_gather_chain(table.data_ptr<int32_t>(),
                                  idx.data_ptr<int32_t>(),
                                  out.data_ptr<int32_t>(),
                                  as_int(table.size(0), "rows"),
                                  as_int(idx.size(0), "n"),
                                  as_int(table.size(1), "lanes"),
                                  as_int(k, "k"), as_int(update, "update"),
                                  use_smem ? 1 : 0, current_stream(table)),
                 "gather_chain");
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

void identity_u8(torch::Tensor in, torch::Tensor out) {
    check_tensor(in, "in", in);
    check_tensor(out, "out", in);
    TORCH_CHECK(in.scalar_type() == torch::kUInt8 &&
                    out.scalar_type() == torch::kUInt8 &&
                    out.sizes() == in.sizes(),
                "in and out must be uint8 tensors of one shape");
    const c10::cuda::CUDAGuard guard(in.device());
    check_launch(dpt_identity_u8(in.data_ptr<uint8_t>(),
                                 out.data_ptr<uint8_t>(), in.numel(),
                                 current_stream(in)),
                 "identity_u8");
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
    m.def("skew", &skew, "K1: (B,H,W,3) -> (D,3B,H) skewed stream");
    m.def("ed_scan", &ed_scan,
          "K2 / K8: wavefront scan, every mode -> (D,B,H) packed colours or "
          "palette indices");
    m.def("unskew_unpack", &unskew_unpack,
          "K3: (D,B,H) packed colours -> (B,H,W,3) or planar (3,B,H,W) uint8");
    m.def("unskew_idx", &unskew_idx,
          "K5: (D,B,H) palette indices -> (B,H,W) uint8 or uint16");
    m.def("skew_planar", &skew_planar,
          "K6: compact planes (R,H,W) -> (D,R,H) skewed stream");
    m.def("skew_transpose", &skew_transpose,
          "K7: strided view (R,H,D) or (C,B,H,D) -> (D,R,H) stream, tile "
          "transpose fused with the mask and the cast");
    m.def("search_probe", &search_probe,
          "T2: exact or scored palette search over a (3*nb, lf) tile, "
          "repeated iters times -> (nb, lf) int32");
    m.def("unskew_select", &unskew_select,
          "K9: (D,B,H) palette indices + palette -> (B,H,W,3) uint8");
    m.def("ordered_fused", &ordered_fused,
          "K4: ordered dither (B,H,W,3) uint8 or float32 -> colours or "
          "indices");
    m.def("gather_chain", &gather_chain,
          "T1: k dependent per-lane table gathers an element, (n, lanes) "
          "int32");
    m.def("sweep_chain", &sweep_chain,
          "T1: k select sweeps over the table's P rows an element, "
          "(n, lanes) int32");
    m.def("identity_u8", &identity_u8, "T3: identity copy of a uint8 tensor");
}
