"""The port's wavefront error diffusion (dither_pie_tpu_torch.ops.wavefront)
held against the golden engine and the JAX package, on the CPU.

On the CPU every wrapper runs its kernel's plain PyTorch version, so these
tests pin down the function each CUDA kernel must compute; chip_smoke.py
holds the kernels to the same plain versions on the card.

Tolerances:
* geometry, weights, K1, K3: exact (integer data and bit patterns);
* the scan against the golden engine's f32 twin (ed_host.ed_fixed_fast):
  bitwise, for all 8 variants, u8 and non-integer f32 input (the other
  modes and the larger palettes: tests/test_torch_ed_modes.py);
* the scan against the JAX scan in interpret mode: perceptual (identity
  >= 0.98, 4x4 block mean <= 8, max <= 48 — tests/test_wavefront.py's
  gate), because XLA:CPU contracts multiply-add into FMA and flips near
  ties.
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu.core.fidelity import assert_perceptually_matched
from dither_pie_tpu.ops import ed_host
from dither_pie_tpu.ops import ed_kernels as jek
from dither_pie_tpu.ops import wavefront as jwf
import dither_pie_tpu_torch as tdpt
from dither_pie_tpu_torch import convert
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.ops import ed_kernels as tek
from dither_pie_tpu_torch.ops import wavefront as twf
import torch_workers  # noqa: F401

VARIANTS = ["floyd_steinberg", "jjn", "stucki", "burkes", "atkinson",
            "sierra", "sierra_two_row", "sierra_lite"]


def _frames(b, h, w, seed, dtype):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    # Non-integer values, some outside [0, 255]: the clamp must act.
    return rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32)


def _palette(p, seed):
    return np.random.RandomState(seed).randint(0, 256, (p, 3)).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# Geometry and state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_geometry_matches_jax(variant):
    g = twf.scan_geometry(variant)
    assert (g.s, g.n_slots) == jwf._scan_params("fixed", variant)
    assert g.ring >= g.n_slots and g.ring & (g.ring - 1) == 0
    assert g.mode == "fixed" and g.clamp_before and g.hist_channels == 3

    jent, tent = jwf._fixed_entries(variant), twf._fixed_entries(variant)
    assert [e[:2] for e in jent] == [e[:2] for e in tent]
    np.testing.assert_array_equal(_bits([e[2] for e in jent]),
                                  _bits([e[2] for e in tent]))
    for a, b in zip(jek.kernel_arrays(variant), tek.kernel_arrays(variant)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))

    # The one weight table that the plain scan and the CUDA kernel read:
    # the JAX entries in consume order (dy descending, then dx descending),
    # carried across by convert bit for bit.
    order = sorted(range(len(jent)), key=lambda i: (-jent[i][1], -jent[i][0]))
    offs_j, w_j = convert.entries_to_torch([jent[i] for i in order], "cpu")
    assert g.offsets.dtype == torch.int32 and g.weights.dtype == torch.float32
    assert g.offsets.device.type == "cpu" and g.weights.device.type == "cpu"
    assert g.offsets.tolist() == [list(jent[i][:2]) for i in order]
    assert torch.equal(g.offsets, offs_j)
    assert torch.equal(g.weights.view(torch.int32), w_j.view(torch.int32))
    np.testing.assert_array_equal(_bits(g.weights.numpy()),
                                  _bits([jent[i][2] for i in order]))


def test_palette_convert_keeps_float32_bits():
    pal = np.array([[0.5, 12.25, 254.9], [1, 2, 3]], np.float32)
    t = convert.palette_to_torch(pal, "cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(pal))


# ---------------------------------------------------------------------------
# K1 / K3 plain versions against the JAX formulations (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["floyd_steinberg", "jjn"])  # s = 2, 3
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_skew_plain_matches_jax(variant, dtype):
    b, h, w = 3, 13, 21
    frames = _frames(b, h, w, 1, dtype)
    s, n_slots = jwf._scan_params("fixed", variant)
    lf, _, _, d_pad = jwf._plan(h, w, 4, 1, s, jwf._chunk_for(n_slots))
    ref = np.asarray(jwf._skew_packed(frames, s, lf, d_pad, interpret=True))

    out = twf.skew_plain(torch.from_numpy(frames), s).numpy()
    d_total = twf.stream_length(h, w, s)
    assert out.shape == (d_total, 3 * b, h) and out.dtype == dtype
    d = np.arange(d_total)[:, None]
    y = np.arange(h)[None, :]
    active = (d - s * y >= 0) & (d - s * y < w)  # (D, H)
    got = np.broadcast_to(active[:, None, :], out.shape)
    np.testing.assert_array_equal(out.astype(np.float32)[got],
                                  ref[:d_total, :, :h][got])
    assert not out[~got].any()  # outside the parallelogram: 0


@pytest.mark.parametrize("variant", ["floyd_steinberg", "jjn"])
def test_unskew_unpack_plain_matches_jax(variant):
    b, h, w = 3, 13, 21
    s, n_slots = jwf._scan_params("fixed", variant)
    lf, _, _, d_pad = jwf._plan(h, w, 4, 1, s, jwf._chunk_for(n_slots))
    col = np.random.RandomState(2).randint(0, 1 << 24, (d_pad, b, lf)).astype(np.int32)
    ref = np.asarray(jwf._unskew_unpack_colors(col, s, lf, h, w, True))

    d_total = twf.stream_length(h, w, s)
    port_col = torch.from_numpy(np.ascontiguousarray(col[:d_total, :, :h]))
    out = twf.unskew_unpack_plain(port_col, s, h, w).numpy()
    assert out.shape == (b, h, w, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# The scan: bitwise against the golden engine, perceptual against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("h,w,p", [(16, 20, 4), (37, 53, 32)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_scan_plain_bitwise_golden(variant, h, w, p, dtype):
    frames = _frames(3, h, w, 10 + p, dtype)
    pal = _palette(p, 20 + p)
    out = twf.ed_batch_wavefront(torch.from_numpy(frames), torch.from_numpy(pal),
                                 "fixed", variant).numpy()
    assert out.shape == frames.shape and out.dtype == np.uint8
    for i in range(frames.shape[0]):
        gold = ed_host.ed_fixed_fast(frames[i].astype(np.float32).copy(), pal,
                                     variant).astype(np.uint8)
        np.testing.assert_array_equal(out[i], gold, err_msg=f"frame {i}")
    assert not build.LAUNCHES  # CPU tensors never launch a kernel


@pytest.mark.parametrize("variant", VARIANTS)
def test_scan_plain_exact_ties_first_index_wins(variant):
    """A flat (101, 100, 100) frame between (100, 100, 100) and
    (102, 100, 100): every pixel whose incoming errors cancel is an exact
    tie, which the golden engine gives to the lower palette index."""
    frames = np.zeros((2, 11, 17, 3), np.uint8)
    frames[...] = (101, 100, 100)
    pal = np.array([[100, 100, 100], [102, 100, 100], [0, 0, 0]], np.float32)
    for order in (pal, pal[[1, 0, 2]]):
        out = twf.ed_batch_wavefront(torch.from_numpy(frames),
                                     torch.from_numpy(order), "fixed",
                                     variant).numpy()
        np.testing.assert_array_equal(out[0, 0, 0], order[0])  # first pixel
        gold = ed_host.ed_fixed_fast(frames[0].astype(np.float32).copy(), order,
                                     variant).astype(np.uint8)
        np.testing.assert_array_equal(out[0], gold)


@pytest.mark.parametrize("p", [65, 130])
def test_scan_plain_exact_ties_first_index_wins_large_palette(p):
    """The same flat frame with the two tied colours behind p - 3 far ones
    and a duplicate of each planted at the end: the search must not depend
    on how a reduction over P splits, the first index wins."""
    frames = np.zeros((1, 11, 17, 3), np.uint8)
    frames[...] = (101, 100, 100)
    far = np.full((p - 4, 3), 255, np.float32)
    far[:, 2] = np.arange(p - 4) % 7  # distinct enough, all far away
    pal = np.concatenate([far[:p - 10], [[100, 100, 100], [102, 100, 100]], far[p - 10:],
                          [[102, 100, 100], [100, 100, 100]]]).astype(np.float32)
    assert pal.shape[0] == p
    out = twf.ed_batch_wavefront(torch.from_numpy(frames), torch.from_numpy(pal),
                                 "fixed", "floyd_steinberg").numpy()
    np.testing.assert_array_equal(out[0, 0, 0], (100, 100, 100))
    gold = ed_host.ed_fixed_fast(frames[0].astype(np.float32).copy(), pal,
                                 "floyd_steinberg").astype(np.uint8)
    np.testing.assert_array_equal(out[0], gold)
    geom = twf.scan_geometry("floyd_steinberg")
    idx = twf.scan_idx(twf.skew(torch.from_numpy(frames), geom.s),
                       torch.from_numpy(pal), geom, 17).numpy()
    assert idx[0, 0, 0] == p - 10 and not np.isin(idx, [p - 2, p - 1]).any()


def _summed_buffer_scan(img, pal, variant, hybrid):
    """The row-major scan with ONE summed error buffer, cur = img + (c1 + c2
    + ...): the wrong association, which a scan with a single error
    accumulator computes."""
    offs, wts = jek.kernel_arrays(variant)
    h, w, _ = img.shape
    acc = np.zeros_like(img)
    out = np.empty_like(img)
    coef = np.array([0.299, 0.587, 0.114], np.float32)
    for y in range(h):
        for x in range(w):
            cur = np.clip(img[y, x] + acc[y, x], np.float32(0), np.float32(255))
            sq = (pal - cur) * (pal - cur)
            bi = int(np.argmin((sq[:, 0] + sq[:, 1]) + sq[:, 2]))
            out[y, x] = pal[bi]
            err = cur - pal[bi]
            if hybrid:
                lum = coef * ((coef[0] * err[0] + coef[1] * err[1]) + coef[2] * err[2])
                err = np.float32(1.0) * lum + np.float32(0.2) * (err - lum)
            for (dx, dy), wq in zip(offs, wts):
                if 0 <= x + dx < w and 0 <= y + dy < h:
                    acc[y + dy, x + dx] += err * wq
    return out.astype(np.uint8)


@pytest.mark.parametrize("seed,frame,mode,variant", [
    (99, 2, "fixed", "atkinson"), (170, 7, "fixed", "stucki"),
    (252, 5, "fixed", "stucki"), (278, 7, "hybrid", "floyd_steinberg"),
])
def test_fold_order_is_observable(seed, frame, mode, variant):
    """Continuous float32 64x96 frames on which the fold order shows: the
    golden engine's left fold (((img + c1) + c2) + ...) and a single summed
    error buffer img + (c1 + c2 + ...) choose different colours somewhere,
    and the port's scan equals the golden engine bit for bit. The frames
    were found by a search over seeds (about one frame in a thousand at
    this size discriminates)."""
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, (8, 64, 96, 3)).astype(np.float32)[frame]
    pal = rng.randint(0, 256, (4, 3)).astype(np.float32)
    if mode == "hybrid":
        gold = ed_host.ed_hybrid_fast(img.copy(), pal)
    else:
        gold = ed_host.ed_fixed_fast(img.copy(), pal, variant)
    gold = gold.astype(np.uint8)
    out = twf.ed_batch_wavefront(torch.from_numpy(img[None]), torch.from_numpy(pal),
                                 mode, variant).numpy()[0]
    np.testing.assert_array_equal(out, gold)
    wrong = _summed_buffer_scan(img, pal, variant, mode == "hybrid")
    assert not np.array_equal(wrong, gold)  # the test discriminates


def test_scan_plain_perceptual_vs_jax_interpret():
    frames = _frames(1, 37, 53, 3, np.uint8)
    pal = _palette(32, 4)
    ref = np.asarray(jwf.ed_fixed_wavefront(frames[0], pal, "floyd_steinberg"))
    out = twf.ed_batch_wavefront(torch.from_numpy(frames), torch.from_numpy(pal),
                                 "fixed", "floyd_steinberg").numpy()[0]
    assert_perceptually_matched(out, ref, min_identical=0.98, block=4,
                                max_block_mean=8.0, max_block_max=48.0)


def test_scan_batch_equals_single_frames():
    """Frames are independent: any B, including B = 1 and odd B."""
    frames = torch.from_numpy(_frames(5, 9, 14, 7, np.uint8))
    pal = torch.from_numpy(_palette(16, 8))
    batch = twf.ed_batch_wavefront(frames, pal, variant="stucki")
    for i in range(5):
        single = twf.ed_batch_wavefront(frames[i:i + 1], pal, variant="stucki")
        assert torch.equal(batch[i], single[0])


def test_device_fn_checks_shapes():
    fn = twf.wavefront_device_fn("fixed", "floyd_steinberg", 9, 14, 8, 2)
    frames = torch.from_numpy(_frames(2, 9, 14, 9, np.uint8))
    pal = torch.from_numpy(_palette(8, 9))
    assert torch.equal(fn(frames, pal),
                       twf.ed_batch_wavefront(frames, pal))
    with pytest.raises(ValueError):
        fn(frames[:1], pal)


# ---------------------------------------------------------------------------
# Slice bounds and dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,item", [
    ({"dense_search": "mxu"}, "A5"),
    ({"dense_search": "mxu", "return_indices": True}, "A5"),
    ({"dense_search": "auto"}, "A5"),
])
def test_unported_options_raise(kw, item):
    """The dense search was the last option of ``ed_batch_wavefront`` that
    raised ``NotImplementedError`` (ROADMAP A5): it is served now, for this
    4-colour palette by the exact search (the score search starts at 65
    colours), so the output equals the default's bit for bit; only an
    unknown value raises. tests/test_torch_dense_search.py holds the score
    search itself."""
    frames = torch.from_numpy(_frames(1, 4, 5, 0, np.uint8))
    pal = torch.from_numpy(_palette(4, 0))
    plain = {k: v for k, v in kw.items() if k != "dense_search"}
    assert torch.equal(twf.ed_batch_wavefront(frames, pal, **kw),
                       twf.ed_batch_wavefront(frames, pal, **plain))
    with pytest.raises(ValueError, match="dense_search"):
        twf.ed_batch_wavefront(frames, pal, **{**kw, "dense_search": item})


def test_large_palette_and_auto_mesh_raise(monkeypatch):
    frames = torch.zeros((1, 4, 5, 3), dtype=torch.uint8)
    # Palettes above 64 colours are served: the packed-colour scan to 1024,
    # the index scan above.
    for p in (65, 1025):
        out = twf.wavefront_device_fn("fixed", "jjn", 4, 5, p, 1)(
            frames, torch.zeros((p, 3)))
        assert out.shape == frames.shape and not out.any()
    # DITHER_PIE_TPU_AUTO_MESH=1 is served: the facade builds, and with one
    # local device (a CPU ditherer) its batches run on that device
    # (tests/test_torch_parallel.py holds the mesh itself).
    monkeypatch.setenv("DITHER_PIE_TPU_AUTO_MESH", "1")
    d = tdpt.ImageDitherer(num_colors=4, dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                           palette=[(0, 0, 0), (255, 255, 255), (255, 0, 0), (0, 0, 255)],
                           device="cpu")
    batch = np.random.RandomState(0).randint(0, 256, (2, 4, 5, 3), dtype=np.uint8)
    monkeypatch.setenv("DITHER_PIE_TPU_AUTO_MESH", "0")
    single = d.apply_dithering_batch(batch)
    monkeypatch.setenv("DITHER_PIE_TPU_AUTO_MESH", "1")
    np.testing.assert_array_equal(d.apply_dithering_batch(batch), single)
    # The entry points in ops/ read no environment: the switch is the facade's.
    out = twf.ed_batch_wavefront(frames, torch.zeros((4, 3)))
    assert out.shape == frames.shape


def test_other_devices_raise():
    frames = torch.zeros((1, 4, 5, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        twf.skew(frames, 2)
