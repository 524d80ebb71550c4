"""The port's planar path (K6 ``skew_planar``, K3's planar layout and the
``planar`` route of dither_pie_tpu_torch.ops.wavefront) held against the
JAX package and the port's own NHWC path, on the CPU, where every wrapper
runs its kernel's plain PyTorch version.

Everything here is exact (integer data and bit patterns): K6's plain
version against K1's for the same frames, against the JAX package's planar
skew and its fused skew kernel in interpret mode on the image's
parallelogram (outside it the JAX stream is don't-care, the port's is 0);
K3's planar layout against the JAX package's; the planar entry against the
NHWC entry transposed, which the other test files hold to the golden
engine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dither_pie_tpu.ops import wavefront as jwf
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.ops import wavefront as twf
import torch_workers  # noqa: F401

MODE_CASES = [
    ("fixed", {"variant": "floyd_steinberg"}),
    ("fixed", {"variant": "stucki"}),
    ("ostromoukhov", {}),
    ("hybrid", {"lum_factor": 0.7, "col_factor": 0.45}),
    ("perceptual", {}),
    ("adaptive", {}),
]
MODE_IDS = ["fixed-fs", "fixed-stucki-s3", "ostromoukhov", "hybrid", "perceptual", "adaptive"]


def _frames(b, h, w, seed, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    return rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32)


def _planes(frames):
    """(B, H, W, 3) -> contiguous (3, B, H, W)."""
    return np.ascontiguousarray(np.moveaxis(frames, -1, 0))


def _unique_palette(p, seed):
    rng = np.random.RandomState(seed)
    pal = np.unique(rng.randint(0, 256, (8 * p + 64, 3)), axis=0)
    return pal[rng.permutation(len(pal))[:p]].astype(np.float32)


def _aux(mode, b, h, w, seed):
    if mode != "adaptive":
        return None
    return torch.from_numpy((np.random.RandomState(seed).rand(b, h, w) < 0.5)
                            .astype(np.float32))


def _valid(d_total, h, w, s):
    """(d_total, 1, h) bool: the image's parallelogram in the stream."""
    col = np.arange(d_total)[:, None] - s * np.arange(h)[None, :]
    return ((col >= 0) & (col < w))[:, None, :]


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("b,h,w", [(1, 5, 7), (3, 37, 53), (9, 12, 14)])
def test_skew_planar_plain_equals_skew_plain(b, h, w, s, dtype):
    """For the same frames K6's stream is K1's, bit for bit."""
    frames = _frames(b, h, w, 10 * b + s, dtype)
    planes = torch.from_numpy(_planes(frames)).view(3 * b, h, w)
    got = twf.skew_planar_plain(planes, s)
    want = twf.skew_plain(torch.from_numpy(frames), s)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.shape == (twf.stream_length(h, w, s), 3 * b, h)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(twf.skew_planar(planes, s), got)  # CPU: the plain version
    assert build.LAUNCHES["skew_planar"] == 0


def test_skew_planar_plain_definition():
    """out[d, r, y] = planes[r, y, d - s*y], 0 outside; any number of rows."""
    rng = np.random.RandomState(0)
    planes = rng.randint(1, 256, (5, 6, 9)).astype(np.uint8)  # R = 5, no zeros
    s = 2
    out = twf.skew_planar_plain(torch.from_numpy(planes), s).numpy()
    assert out.shape == (9 + s * 5, 5, 6)
    for d in range(out.shape[0]):
        for y in range(6):
            x = d - s * y
            want = planes[:, y, x] if 0 <= x < 9 else np.zeros(5, np.uint8)
            np.testing.assert_array_equal(out[d, :, y], want)


@pytest.mark.parametrize("shape,variant", [
    ((8, 16, 20), "floyd_steinberg"),   # s = 2
    ((8, 33, 40), "floyd_steinberg"),
    ((8, 128, 257), "floyd_steinberg"),
    ((8, 24, 30), "jjn"),               # s = 3
    ((2, 16, 20), "floyd_steinberg"),   # rows no multiple of 8
])
def test_skew_planar_plain_equals_jax(shape, variant):
    """Against the JAX package's planar skew and its fused skew kernel (the
    TPU kernel K6 replaces), both in interpret mode, on the parallelogram."""
    b, h, w = shape
    frames = np.random.RandomState(b * 1000 + h).randint(0, 256, (b, h, w, 3), dtype=np.uint8)
    planes = _planes(frames)
    s, n_slots = jwf._scan_params("fixed", variant)
    assert s == twf.scan_geometry(variant).s
    lf, _, _, d_pad = jwf._plan(h, w, 8, 1, s, jwf._chunk_for(n_slots))
    d_total = twf.stream_length(h, w, s)
    got = twf.skew_planar_plain(torch.from_numpy(planes).view(3 * b, h, w), s).numpy()
    mask = np.broadcast_to(_valid(d_total, h, w, s), got.shape)
    assert not got[~mask].any()  # the port's stream is 0 outside the image

    planar = np.asarray(jwf._skew_packed_planar(jnp.asarray(planes), s, lf, d_pad,
                                                interpret=True))
    fused = np.asarray(jwf._skew_packed_fused(jnp.asarray(frames), s, lf, d_pad,
                                              interpret=True))
    for ref in (planar, fused):
        assert ref.shape == (d_pad, 3 * b, lf)
        np.testing.assert_array_equal(ref[:d_total, :, :h][mask],
                                      got.astype(np.float32)[mask])


# ---------------------------------------------------------------------------
# K3's planar layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,b,h,w", [(2, 8, 24, 40), (3, 3, 17, 21), (1, 1, 9, 5)])
def test_unskew_unpack_planar_equals_jax(s, b, h, w):
    rng = np.random.RandomState(s * 10 + b)
    logical = rng.randint(0, 1 << 24, (b, h, w)).astype(np.int32)
    d_total = twf.stream_length(h, w, s)
    col = twf.skew_planar_plain(torch.from_numpy(logical), s)
    got = twf.unskew_unpack_plain(col, s, h, w, planar_out=True)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, b, h, w)
    nhwc = twf.unskew_unpack_plain(col, s, h, w)
    assert torch.equal(got, nhwc.permute(3, 0, 1, 2))
    want = np.stack([(logical >> sh) & 255 for sh in (16, 8, 0)]).astype(np.uint8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(twf.unskew_unpack(col, s, h, w, planar_out=True), got)
    assert build.LAUNCHES["unskew_unpack"] == 0

    lf = jwf._round_up(h + 4, 128)
    d_pad = jwf._round_up(d_total, 8)
    jcol = rng.randint(0, 1 << 24, (d_pad, b, lf)).astype(np.int32)  # noise outside
    jcol[:d_total, :, :h] = np.where(_valid(d_total, h, w, s), col.numpy(),
                                     jcol[:d_total, :, :h])
    for planar_out, ours in ((True, got), (False, nhwc)):
        ref = np.asarray(jwf._unskew_unpack_colors(jnp.asarray(jcol), s, lf, h, w, True,
                                                   planar_out=planar_out))
        np.testing.assert_array_equal(ours.numpy(), ref)


# ---------------------------------------------------------------------------
# The planar route of the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("b", [1, 3, 9])
@pytest.mark.parametrize("mode,kw", MODE_CASES, ids=MODE_IDS)
def test_planar_batch_entry_matches_nhwc(mode, kw, b, dtype):
    """ed_batch_wavefront(planar=True), the video pipeline's zero-copy
    entry, is bit-identical to the NHWC entry in every mode; the aux map
    stays (B, H, W)."""
    h, w = 17, 21
    frames = _frames(b, h, w, 33 + b, dtype)
    pal = torch.from_numpy(_unique_palette(12, 34))
    aux = _aux(mode, b, h, w, 35)
    a = twf.ed_batch_wavefront(torch.from_numpy(frames), pal, mode, aux=aux, **kw)
    out = twf.ed_batch_wavefront(torch.from_numpy(_planes(frames)), pal, mode, aux=aux,
                                 planar=True, **kw)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (3, b, h, w)
    assert torch.equal(out.permute(1, 2, 3, 0), a)
    assert not build.LAUNCHES  # CPU tensors: plain versions only


def test_planar_dense_palette_matches_nhwc():
    frames = _frames(2, 12, 18, 40)
    pal = torch.from_numpy(_unique_palette(100, 41))
    a = twf.ed_batch_wavefront(torch.from_numpy(frames), pal)
    out = twf.ed_batch_wavefront(torch.from_numpy(_planes(frames)), pal, planar=True)
    assert torch.equal(out.permute(1, 2, 3, 0), a)


@pytest.mark.parametrize("p,dtype", [(4, torch.uint8), (300, torch.uint16)])
@pytest.mark.parametrize("mode", ["fixed", "perceptual"])
def test_planar_return_indices(mode, p, dtype):
    """Indices are layout-free (B, H, W): the planar entry gives the NHWC
    entry's, and they gather to the colour output."""
    frames = _frames(9, 12, 14, 8)
    pal_np = _unique_palette(p, 9)
    pal = torch.from_numpy(pal_np)
    colours = twf.ed_batch_wavefront(torch.from_numpy(frames), pal, mode)
    idx = twf.ed_batch_wavefront(torch.from_numpy(_planes(frames)), pal, mode, planar=True,
                                 return_indices=True)
    assert idx.dtype == dtype and tuple(idx.shape) == (9, 12, 14)
    np.testing.assert_array_equal(pal_np.astype(np.uint8)[idx.numpy()], colours.numpy())
    nhwc_idx = twf.ed_batch_wavefront(torch.from_numpy(frames), pal, mode,
                                      return_indices=True)
    np.testing.assert_array_equal(idx.numpy(), nhwc_idx.numpy())


def test_planar_vs_jax_planar_entry():
    """The JAX package's planar entry in interpret mode holds the same
    contract: its planar output is its NHWC output transposed."""
    frames = _frames(3, 16, 20, 50)
    pal_np = _unique_palette(16, 51)
    ref = jwf.ed_batch_wavefront(_planes(frames), pal_np, "fixed", "floyd_steinberg",
                                 planar=True)
    out = twf.ed_batch_wavefront(torch.from_numpy(_planes(frames)), torch.from_numpy(pal_np),
                                 planar=True).numpy()
    assert ref.shape == out.shape == (3, 3, 16, 20)
    # XLA:CPU contracts multiply-add into FMA and flips near ties: the JAX
    # package's own tolerance for its CPU scan.
    assert np.all(ref == out, axis=0).mean() >= 0.98


def test_planar_rejects_oversized_palette_and_wrong_layout():
    planes = torch.zeros((3, 2, 8, 8), dtype=torch.uint8)
    pal = torch.from_numpy(_unique_palette(twf.PACKED_PALETTE_MAX + 1, 35))
    with pytest.raises(ValueError, match="planar layout requires a palette <= 1024"):
        twf.ed_batch_wavefront(planes, pal, planar=True)
    with pytest.raises(ValueError, match="planar"):
        twf.wavefront_device_fn("fixed", "floyd_steinberg", 8, 8, 1025, 2, planar=True)
    small = torch.from_numpy(_unique_palette(4, 36))
    with pytest.raises(ValueError, match=r"\(3, B, H, W\)"):
        twf.ed_batch_wavefront(torch.zeros((2, 8, 8, 3), dtype=torch.uint8), small,
                               planar=True)
    with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
        twf.ed_batch_wavefront(torch.zeros((3, 2, 8, 8), dtype=torch.uint8), small)


def test_wavefront_device_fn_planar():
    frames = _frames(8, 16, 20, 60)
    pal = torch.from_numpy(_unique_palette(4, 61))
    fn_n = twf.wavefront_device_fn("fixed", "floyd_steinberg", 16, 20, 4, 8)
    fn_p = twf.wavefront_device_fn("fixed", "floyd_steinberg", 16, 20, 4, 8, planar=True)
    out_p = fn_p(torch.from_numpy(_planes(frames)), pal)
    assert tuple(out_p.shape) == (3, 8, 16, 20)
    assert torch.equal(out_p.permute(1, 2, 3, 0), fn_n(torch.from_numpy(frames), pal))
    with pytest.raises(ValueError):
        fn_p(torch.from_numpy(frames), pal)  # NHWC frames to the planar function


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_perceptual_sensitivity_planar_equals_numpy(dtype):
    """Planes (channel axis 0) give the map of the NHWC frames, and numpy's
    bits."""
    frames = _frames(2, 9, 13, 70, dtype)
    planes = _planes(frames)
    got = twf.perceptual_sensitivity(torch.from_numpy(planes), planar=True).numpy()
    gray = (np.float32(0.299) * planes[0] + np.float32(0.587) * planes[1]
            + np.float32(0.114) * planes[2])
    want = np.float32(0.5) + np.float32(0.5) * (gray / np.float32(255.0))
    assert got.dtype == np.float32 and got.shape == (2, 9, 13)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    nhwc = twf.perceptual_sensitivity(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), nhwc.view(np.uint32))
