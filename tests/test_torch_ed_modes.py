"""The rest of the port's error-diffusion family (ostromoukhov, hybrid,
perceptual, adaptive; palettes of 65-4096 colours; the index scan K8 and
its epilogue K9) held against the golden engine and the JAX package, on the
CPU, where every wrapper runs its kernel's plain PyTorch version.

Tolerances:
* tables, geometry, the sensitivity map, K9: exact (bit patterns);
* the plain scan of each mode against the golden engine's f32 twin
  (ed_host.ed_*_fast): bitwise, u8 and non-integer f32 frames;
* palettes of 100, 300, 600 and 2048 colours against ed_fixed_fast:
  bitwise; planted duplicate colours: the later index is never emitted;
* each mode against the JAX kernel in interpret mode: perceptual
  (identity >= 0.98, 4x4 block mean <= 8, max <= 48), because XLA:CPU
  contracts multiply-add into FMA and flips near ties.
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu.core.fidelity import assert_perceptually_matched
from dither_pie_tpu.ops import adaptive as jad
from dither_pie_tpu.ops import ed_host
from dither_pie_tpu.ops import ed_kernels as jek
from dither_pie_tpu.ops import wavefront as jwf
from dither_pie_tpu_torch import convert
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.ops import adaptive as tad
from dither_pie_tpu_torch.ops import ed_kernels as tek
from dither_pie_tpu_torch.ops import wavefront as twf
import torch_workers  # noqa: F401

MODES = ["ostromoukhov", "hybrid", "perceptual", "adaptive"]

# (id, mode, keyword arguments of the mode)
MODE_CASES = [
    ("ostromoukhov", "ostromoukhov", {}),
    ("hybrid-1.0-0.2", "hybrid", {"lum_factor": 1.0, "col_factor": 0.2}),
    ("hybrid-0.7-0.45", "hybrid", {"lum_factor": 0.7, "col_factor": 0.45}),
    ("perceptual", "perceptual", {}),
    ("adaptive-r1", "adaptive", {"window_radius": 1}),
    ("adaptive-r2", "adaptive", {"window_radius": 2}),
]


def _frames(b, h, w, seed, dtype):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    # Non-integer values, some outside [0, 255]: the clamp must act.
    return rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32)


def _palette(p, seed):
    return np.random.RandomState(seed).randint(0, 256, (p, 3)).astype(np.float32)


def _unique_palette(p, seed):
    rng = np.random.RandomState(seed)
    pal = np.unique(rng.randint(0, 256, (8 * p, 3)), axis=0)
    return pal[rng.permutation(len(pal))[:p]].astype(np.float32)


def _gates(frames, window_radius=1, threshold=300.0):
    """(B, H, W) bool gates as the JAX strategy computes them on the host."""
    f = frames.astype(np.float32)
    gray = (np.float32(0.299) * f[..., 0] + np.float32(0.587) * f[..., 1]
            + np.float32(0.114) * f[..., 2])
    return np.stack([jad.variance_map_np(g, window_radius) >= threshold for g in gray])


def _port(frames, pal, mode, kw):
    """The port's batch entry on the CPU; returns (B, H, W, 3) uint8."""
    kw = dict(kw)
    if mode == "adaptive":
        gates = _gates(frames, kw.pop("window_radius", 1))
        kw["aux"] = torch.from_numpy(gates.astype(np.float32))
    return twf.ed_batch_wavefront(torch.from_numpy(frames), torch.from_numpy(pal),
                                  mode, **kw).numpy()


def _golden(frame, pal, mode, kw):
    """One frame through the golden engine's f32 twin of ``mode``."""
    work = frame.astype(np.float32).copy()
    if mode == "fixed":
        out = ed_host.ed_fixed_fast(work, pal, kw.get("variant", "floyd_steinberg"))
    elif mode == "ostromoukhov":
        out = ed_host.ed_ostromoukhov_fast(work, pal)
    elif mode == "hybrid":
        out = ed_host.ed_hybrid_fast(work, pal, kw.get("lum_factor", 1.0),
                                     kw.get("col_factor", 0.2))
    elif mode == "perceptual":
        out = ed_host.ed_perceptual_fast(work, pal)
    else:
        out = ed_host.ed_adaptive_fast(
            work, pal, _gates(frame[None], kw.get("window_radius", 1))[0])
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# Tables and geometry
# ---------------------------------------------------------------------------


def test_ostromoukhov_tables_equal_jax_bitwise():
    assert tek.OSTROMOUKHOV_TABLE == jek.OSTROMOUKHOV_TABLE
    assert tek.OSTROMOUKHOV_ARRAY.dtype == jek.OSTROMOUKHOV_ARRAY.dtype
    np.testing.assert_array_equal(tek.OSTROMOUKHOV_ARRAY, jek.OSTROMOUKHOV_ARRAY)
    ours, ref = twf._ostro_weight_table(), jwf._ostro_weight_table()
    assert ours.dtype == np.float32 and ours.shape == (256, 3)
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
    # convert carries the JAX package's table across bit for bit, and it is
    # the tensor the scan reads.
    lut = convert.weight_table_to_torch(ref, "cpu")
    assert lut.dtype == torch.float32 and tuple(lut.shape) == (256, 3)
    assert torch.equal(lut.view(torch.int32), twf.ostro_lut("cpu").view(torch.int32))
    with pytest.raises(ValueError):
        convert.weight_table_to_torch(ref.astype(np.float64), "cpu")


@pytest.mark.parametrize("mode", MODES)
def test_mode_geometry_matches_jax(mode):
    assert twf._scan_params(mode, "") == tuple(jwf._scan_params(mode, ""))
    g = twf.scan_geometry("", mode, 0.7, 0.45)
    assert (g.s, g.n_slots) == tuple(jwf._scan_params(mode, ""))
    assert g.mode == mode and g.ring >= g.n_slots and g.ring & (g.ring - 1) == 0
    assert g.clamp_before == (mode in ("ostromoukhov", "hybrid"))
    assert g.needs_aux == (mode in ("perceptual", "adaptive"))
    assert g.hist_channels == (4 if mode in ("ostromoukhov", "perceptual") else 3)
    assert (g.lum_factor, g.col_factor) == (0.7, 0.45)
    if mode == "ostromoukhov":
        entries = [(1, 0), (-1, 1), (0, 1)]  # jwf._build_kernel's offsets
    else:
        entries = [e[:2] for e in jwf._FS_ENTRIES]
        want_w = [e[2] for e in jwf._FS_ENTRIES]
    order = sorted(range(len(entries)), key=lambda i: (-entries[i][1], -entries[i][0]))
    assert g.offsets.tolist() == [list(entries[i]) for i in order]
    assert g.columns.tolist() == order
    if mode != "ostromoukhov":
        np.testing.assert_array_equal(
            g.weights.numpy().view(np.uint32),
            np.asarray([want_w[i] for i in order], np.float32).view(np.uint32))


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown wavefront mode"):
        twf.scan_geometry("", "riemersma")


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_sensitivity_map_equals_numpy_bitwise(dtype):
    frames = _frames(2, 19, 23, 5, dtype)
    f = frames.astype(np.float32) if dtype == np.float32 else frames
    # The JAX package's map (ops/wavefront.py ed_batch_wavefront).
    gray = (np.float32(0.299) * f[..., 0] + np.float32(0.587) * f[..., 1]
            + np.float32(0.114) * f[..., 2])
    ref = np.float32(0.5) + np.float32(0.5) * (gray / np.float32(255.0))
    out = twf.perceptual_sensitivity(torch.from_numpy(frames)).numpy()
    assert out.dtype == np.float32 and out.shape == frames.shape[:3]
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_variance_map_equals_jax_bitwise(radius):
    gray = np.random.RandomState(radius).uniform(0, 255, (17, 23)).astype(np.float32)
    np.testing.assert_array_equal(tad.variance_map_np(gray, radius),
                                  jad.variance_map_np(gray, radius))


# ---------------------------------------------------------------------------
# The plain scan of each mode: bitwise against the golden twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("h,w,p", [(16, 20, 4), (37, 53, 32)])
@pytest.mark.parametrize("case", MODE_CASES, ids=[c[0] for c in MODE_CASES])
def test_mode_scan_plain_bitwise_golden(case, h, w, p, dtype):
    _, mode, kw = case
    frames = _frames(3, h, w, 10 + p, dtype)
    pal = _palette(p, 20 + p)
    out = _port(frames, pal, mode, kw)
    assert out.shape == frames.shape and out.dtype == np.uint8
    for i in range(frames.shape[0]):
        np.testing.assert_array_equal(out[i], _golden(frames[i], pal, mode, kw),
                                      err_msg=f"frame {i}")
    assert not build.LAUNCHES  # CPU tensors never launch a kernel


@pytest.mark.parametrize("h,w", [(7, 5), (33, 9), (5, 40), (1, 12), (12, 1)])
@pytest.mark.parametrize("mode", MODES)
def test_mode_odd_shapes_bitwise_golden(mode, h, w):
    frames = _frames(2, h, w, h * 100 + w, np.uint8)
    pal = _palette(8, 3)
    out = _port(frames, pal, mode, {})
    for i in range(2):
        np.testing.assert_array_equal(out[i], _golden(frames[i], pal, mode, {}))


@pytest.mark.parametrize("mode", MODES)
def test_mode_batch_equals_single_frames(mode):
    """Frames are independent: a batch of one computes what the batch of
    four does, frame by frame."""
    frames = _frames(4, 9, 14, 7, np.uint8)
    pal = _palette(16, 8)
    batch = _port(frames, pal, mode, {})
    for i in range(4):
        np.testing.assert_array_equal(_port(frames[i:i + 1], pal, mode, {})[0], batch[i])


@pytest.mark.parametrize("mode", MODES)
def test_mode_scan_perceptual_vs_jax_interpret(mode):
    """The second witness: the JAX package's Pallas scan, interpreted."""
    frames = _frames(1, 21, 29, 3, np.uint8)
    pal = _palette(16, 4)
    kw = {"aux": _gates(frames).astype(np.float32)} if mode == "adaptive" else {}
    ref = np.asarray(jwf.ed_batch_wavefront(frames, pal, mode, **kw))
    out = _port(frames, pal, mode, {})
    assert_perceptually_matched(out[0], ref[0], min_identical=0.98, block=4,
                                max_block_mean=8.0, max_block_max=48.0)


def test_perceptual_product_order_matters():
    """Why the port follows the golden engine's err * (w_k * sens) and not
    the TPU kernel's (err * sens) * w_k: in float32 the two differ in the
    last bit for about a third of the products at 7/16, 5/16 and 3/16 (at
    1/16, a power of two, never)."""
    rng = np.random.RandomState(0)
    err = rng.uniform(-255, 255, 200_000).astype(np.float32)
    sens = rng.uniform(0.5, 1.0, 200_000).astype(np.float32)
    for _, _, w in jwf._FS_ENTRIES:
        differ = float(((err * sens) * w != err * (w * sens)).mean())
        if w == np.float32(1 / 16):
            assert differ == 0.0
        else:
            assert 0.30 < differ < 0.45, (w, differ)


def test_adaptive_gate_of_zeros_is_nearest_colour():
    """With every gate closed no error moves: each pixel takes its nearest
    colour (no clamp before the search in this mode)."""
    frames = _frames(1, 8, 11, 2, np.uint8)
    pal = _palette(8, 5)
    out = twf.ed_batch_wavefront(torch.from_numpy(frames), torch.from_numpy(pal),
                                 "adaptive", aux=torch.zeros((1, 8, 11))).numpy()
    d = ((frames[0].astype(np.float32)[:, :, None, :] - pal[None, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(out[0], pal[d.argmin(-1)].astype(np.uint8))


def test_aux_is_checked():
    frames = torch.zeros((2, 4, 5, 3), dtype=torch.uint8)
    pal = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="aux"):
        twf.ed_batch_wavefront(frames, pal, "adaptive")  # missing
    with pytest.raises(ValueError, match="aux"):
        twf.ed_batch_wavefront(frames, pal, "adaptive", aux=torch.zeros((1, 4, 5)))
    with pytest.raises(ValueError, match="aux"):
        twf.ed_batch_wavefront(frames, pal, "hybrid", aux=torch.zeros((2, 4, 5)))


def test_index_scan_refuses_palettes_beyond_its_shared_memory():
    stream = torch.zeros((6, 3, 2), dtype=torch.uint8)
    geom = twf.scan_geometry("floyd_steinberg")
    pal = torch.zeros((twf.INDEX_PALETTE_MAX + 1, 3))
    with pytest.raises(ValueError, match=str(twf.INDEX_PALETTE_MAX)):
        twf.scan_idx(stream, pal, geom, 5)


def test_device_fn_takes_aux_and_factors():
    frames = torch.from_numpy(_frames(2, 9, 14, 9, np.uint8))
    pal = torch.from_numpy(_palette(8, 9))
    gates = torch.from_numpy(_gates(frames.numpy()).astype(np.float32))
    fn = twf.wavefront_device_fn("adaptive", "", 9, 14, 8, 2)
    assert torch.equal(fn(frames, pal, gates),
                       twf.ed_batch_wavefront(frames, pal, "adaptive", aux=gates))
    fn = twf.wavefront_device_fn("hybrid", "", 9, 14, 8, 2, lum_factor=0.5, col_factor=0.9)
    assert torch.equal(fn(frames, pal),
                       twf.ed_batch_wavefront(frames, pal, "hybrid", lum_factor=0.5,
                                              col_factor=0.9))


# ---------------------------------------------------------------------------
# Palettes above 64 colours; K8 and K9
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,p", [("fixed", 100), ("fixed", 300), ("fixed", 600),
                                    ("fixed", 2048), ("ostromoukhov", 2048)])
def test_large_palettes_bitwise_golden(mode, p):
    """100-1024 colours run the packed-colour scan, 2048 the index scan and
    the palette select."""
    frames = _frames(2, 16, 20, 14, np.uint8)
    pal = _unique_palette(p, 21)
    assert pal.shape[0] == p
    out = _port(frames, pal, mode, {})
    for i in range(2):
        np.testing.assert_array_equal(out[i], _golden(frames[i], pal, mode, {}))


def test_route_by_palette_size(monkeypatch):
    """Up to PACKED_PALETTE_MAX colours: K2 -> K3; above: K8 -> K9."""
    assert twf.PACKED_PALETTE_MAX == jwf.PACKED_PALETTE_MAX == 1024
    calls = []
    for name in ("scan", "unskew_unpack", "scan_idx", "unskew_select"):
        fn = getattr(twf, name)
        monkeypatch.setattr(twf, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    frames = torch.zeros((1, 3, 4, 3), dtype=torch.uint8)
    twf.ed_batch_wavefront(frames, torch.zeros((1024, 3)))
    assert calls == ["scan", "unskew_unpack"]
    calls.clear()
    twf.ed_batch_wavefront(frames, torch.zeros((1025, 3)))
    assert calls == ["scan_idx", "unskew_select"]
    stream = twf.skew_plain(frames, 2)
    with pytest.raises(ValueError, match="scan_idx"):
        twf.scan(stream, torch.zeros((1025, 3)), twf.scan_geometry("floyd_steinberg"), 4)


@pytest.mark.parametrize("p,dups", [
    (128, ((0, 97), (5, 64), (17, 127), (40, 80), (3, 4))),
    (600, ((3, 100), (3, 550), (7, 299))),
    (2048, ((3, 100), (3, 1500), (7, 2047), (40, 1025))),
])
def test_planted_duplicates_first_index_wins(p, dups):
    """Duplicates of earlier colours planted at later indices: every hit on
    them is an exact tie, which must go to the earlier copy (the golden
    engine's first strict minimum)."""
    pal = _unique_palette(p, 33)
    for src, dst in dups:
        pal[dst] = pal[src]
    frames = _frames(3, 12, 16, 6, np.uint8)
    frames[0] = pal[dups[0][0]].astype(np.uint8)  # flat: exact d2 = 0 ties
    frames[1, :, :8] = pal[dups[1][0]].astype(np.uint8)
    frames[2, :6] = pal[dups[-1][0]].astype(np.uint8)
    geom = twf.scan_geometry("floyd_steinberg")
    frames_t, pal_t = torch.from_numpy(frames), torch.from_numpy(pal)
    stream = twf.skew(frames_t, geom.s)
    idx = twf.scan_idx(stream, pal_t, geom, 16)
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (stream.shape[0], 3, 12)
    assert not np.isin(idx.numpy(), [dst for _, dst in dups]).any()
    assert set(np.unique(idx[:, 0].numpy())) <= {0, dups[0][0]}
    out = twf.unskew_select(idx, pal_t, geom.s, 12, 16).numpy()
    for i in range(3):
        np.testing.assert_array_equal(out[i], _golden(frames[i], pal, "fixed", {}))
    # The facade route agrees, and below 1025 colours so does the packed scan.
    np.testing.assert_array_equal(_port(frames, pal, "fixed", {}), out)
    if p <= twf.PACKED_PALETTE_MAX:
        col = twf.scan(stream, pal_t, geom, 16)
        np.testing.assert_array_equal(twf.unskew_unpack(col, geom.s, 12, 16).numpy(), out)


def test_argmin_ties_resolve_to_first_index_at_large_p():
    """A flat frame midway between two colours that sit behind 70 far
    colours, with a duplicate pair planted further back: first wins."""
    far = np.full((70, 3), 250, np.float32)
    pal = np.concatenate([far, [[100, 100, 100], [102, 100, 100]], far[:30],
                          [[102, 100, 100], [100, 100, 100]]]).astype(np.float32)
    frames = np.zeros((1, 6, 9, 3), np.uint8)
    frames[...] = (101, 100, 100)
    geom = twf.scan_geometry("floyd_steinberg")
    stream = twf.skew(torch.from_numpy(frames), geom.s)
    idx = twf.scan_idx(stream, torch.from_numpy(pal), geom, 9).numpy()
    assert idx[0, 0, 0] == 70  # the first pixel: an exact tie of 70 and 71
    assert not np.isin(idx, [102, 103]).any()
    out = _port(frames, pal, "fixed", {})
    np.testing.assert_array_equal(out[0], _golden(frames[0], pal, "fixed", {}))


@pytest.mark.parametrize("variant", ["floyd_steinberg", "jjn"])  # s = 2, 3
def test_unskew_select_plain_matches_jax(variant):
    b, h, w, p = 3, 13, 21, 200
    s, n_slots = jwf._scan_params("fixed", variant)
    lf, _, _, d_pad = jwf._plan(h, w, 4, 1, s, jwf._chunk_for(n_slots))
    rng = np.random.RandomState(2)
    idx = rng.randint(0, p, (d_pad, b, lf)).astype(np.int32)
    pal = rng.randint(0, 256, (p, 3)).astype(np.float32)
    ref = np.asarray(jwf._unskew_select_colors(idx, pal, s, lf, h, w, True))

    d_total = twf.stream_length(h, w, s)
    port_idx = torch.from_numpy(np.ascontiguousarray(idx[:d_total, :, :h]))
    out = twf.unskew_select(port_idx, torch.from_numpy(pal), s, h, w).numpy()
    assert out.shape == (b, h, w, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


def test_unskew_select_truncates_the_palette():
    """The palette's float32 -> int32 cast truncates, as the JAX package's
    (ops/wavefront.py _unskew_select_colors)."""
    pal = torch.tensor([[0.9, 12.5, 254.99], [1.0, 2.0, 3.0]])
    idx = torch.zeros((3, 1, 1), dtype=torch.int32)
    out = twf.unskew_select(idx, pal, 2, 1, 3)
    assert out[0, 0].tolist() == [[0, 12, 254]] * 3
