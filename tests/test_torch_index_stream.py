"""The port's index stream (K5 ``unskew_idx`` and the ``return_indices``
route of dither_pie_tpu_torch.ops.wavefront) held against the JAX package
and the golden engine, on the CPU, where every wrapper runs its kernel's
plain PyTorch version.

Tolerances:
* K5's plain version against the JAX package's stride-lemma unskew and its
  Pallas unskew kernel in interpret mode: exact (integer data);
* ``palette.astype(uint8)[idx]`` against the colour path, every mode, and
  against the golden engine's f32 twin (ed_host.ed_fixed_fast): bitwise;
* the index stream against the JAX scan in interpret mode: identity
  >= 0.98 of the indices and tests/test_wavefront.py's perceptual gate on
  the colours (4x4 block mean <= 8, max <= 48), because XLA:CPU contracts
  multiply-add into FMA and flips near ties: a second witness, not the
  exact one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dither_pie_tpu.core.fidelity import assert_perceptually_matched
from dither_pie_tpu.ops import ed_host
from dither_pie_tpu.ops import wavefront as jwf
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.ops import wavefront as twf
import torch_workers  # noqa: F401

# (mode, keyword arguments): the five modes, and a fixed variant with s = 3.
MODE_CASES = [
    ("fixed", {"variant": "floyd_steinberg"}),
    ("fixed", {"variant": "jjn"}),
    ("ostromoukhov", {}),
    ("hybrid", {"lum_factor": 0.7, "col_factor": 0.45}),
    ("perceptual", {}),
    ("adaptive", {}),
]
MODE_IDS = ["fixed-fs", "fixed-jjn-s3", "ostromoukhov", "hybrid", "perceptual", "adaptive"]


def _unique_palette(p, seed):
    rng = np.random.RandomState(seed)
    pal = np.unique(rng.randint(0, 256, (8 * p + 64, 3)), axis=0)
    return pal[rng.permutation(len(pal))[:p]].astype(np.float32)


def _frames(b, h, w, seed, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    return rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32)


def _aux(mode, b, h, w, seed):
    if mode != "adaptive":
        return None
    return torch.from_numpy((np.random.RandomState(seed).rand(b, h, w) < 0.5)
                            .astype(np.float32))


# ---------------------------------------------------------------------------
# K5 against the JAX package's unskew
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,b,h,w", [
    (2, 8, 120, 200),    # FS-family skew, no window clamping
    (3, 8, 100, 150),    # the skew of kernels with dx = -2
    (2, 16, 380, 140),   # the TPU kernel's windows clamp at the edge
    (3, 8, 300, 130),    # s = 3 with clamping
])
def test_unskew_idx_plain_equals_jax_unskew(s, b, h, w):
    """One set of logical indices, two streams: the port's (D, B, H) and the
    JAX package's padded (d_pad, B, lf). The positions outside the image
    hold noise: no unskew may read them."""
    rng = np.random.RandomState(s * 100 + b)
    logical = rng.randint(0, 64, (b, h, w)).astype(np.int32)
    d_total = twf.stream_length(h, w, s)
    stream = twf.skew_planar_plain(torch.from_numpy(logical), s)
    valid = twf.skew_planar_plain(torch.ones((b, h, w), dtype=torch.bool), s)
    noise = torch.from_numpy(rng.randint(0, 64, (d_total, b, h)).astype(np.int32))
    stream = torch.where(valid, stream, noise)

    out = twf.unskew_idx_plain(stream, s, h, w)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (b, h, w)
    assert out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), logical)
    assert twf.unskew_idx(stream, s, h, w) .equal(out)  # CPU: the plain version
    assert build.LAUNCHES["unskew_idx"] == 0

    lf = jwf._round_up(h + 4, 128)
    d_pad = jwf._round_up(jwf._round_up(d_total, 256), 8)
    wxp = jwf._round_up(w, 128)
    jstream = rng.randint(0, 64, (d_pad, b, lf)).astype(np.int32)
    jstream[:d_total, :, :h] = stream.numpy()
    lemma = np.asarray(jwf._unskew_idx_packed(jnp.asarray(jstream), s, lf, h, w,
                                              interpret=True))
    np.testing.assert_array_equal(out.numpy(), lemma)
    n_in = -(-(128 + 127 * s) // 128)
    kernel = np.asarray(jwf._unskew_transpose_call(b, lf, d_pad, s, wxp, True)(
        *([jnp.asarray(jstream)] * n_in)))
    np.testing.assert_array_equal(out.numpy(), kernel[:, :h, :w])


@pytest.mark.parametrize("dtype,top", [(torch.uint8, 256), (torch.uint16, 1024)])
def test_unskew_idx_plain_narrows_to_the_stream_type(dtype, top):
    rng = np.random.RandomState(top)
    logical = rng.randint(0, top, (3, 11, 17)).astype(np.int32)
    logical[0, 0, :2] = (top - 1, 0)
    for s in (1, 2, 3):
        stream = twf.skew_planar_plain(torch.from_numpy(logical), s)
        out = twf.unskew_idx_plain(stream, s, 11, 17, dtype)
        assert out.dtype == dtype
        np.testing.assert_array_equal(out.numpy().astype(np.int32), logical)
    with pytest.raises(TypeError, match="uint8 or uint16"):
        twf.unskew_idx(stream, 3, 11, 17, torch.int32)


# ---------------------------------------------------------------------------
# The index route of the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,dtype", [(2, torch.uint8), (32, torch.uint8), (256, torch.uint8),
                                     (257, torch.uint16), (300, torch.uint16),
                                     (1024, torch.uint16)])
def test_return_indices_dtype_and_gather(p, dtype):
    assert twf.index_dtype(p) == dtype
    frames = torch.from_numpy(_frames(2, 10, 14, p))
    pal_np = _unique_palette(p, p + 1)
    pal = torch.from_numpy(pal_np)
    colours = twf.ed_batch_wavefront(frames, pal)
    idx = twf.ed_batch_wavefront(frames, pal, return_indices=True)
    assert idx.dtype == dtype and tuple(idx.shape) == (2, 10, 14)
    assert idx.device == frames.device and int(idx.numpy().max()) < p
    np.testing.assert_array_equal(pal_np.astype(np.uint8)[idx.numpy()], colours.numpy())


@pytest.mark.parametrize("frame_dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("mode,kw", MODE_CASES, ids=MODE_IDS)
def test_return_indices_gathers_to_colours(mode, kw, frame_dtype):
    """palette_u8[idx] reproduces the colour path bit for bit in every mode:
    the same scan, only the output stream differs."""
    b, h, w = 3, 13, 19
    frames = torch.from_numpy(_frames(b, h, w, 5, frame_dtype))
    pal_np = _unique_palette(24, 6)
    pal = torch.from_numpy(pal_np)
    aux = _aux(mode, b, h, w, 7)
    colours = twf.ed_batch_wavefront(frames, pal, mode, aux=aux, **kw)
    idx = twf.ed_batch_wavefront(frames, pal, mode, aux=aux, return_indices=True, **kw)
    assert idx.dtype == torch.uint8 and tuple(idx.shape) == (b, h, w)
    np.testing.assert_array_equal(pal_np.astype(np.uint8)[idx.numpy()], colours.numpy())
    assert not build.LAUNCHES  # CPU tensors: plain versions only


@pytest.mark.parametrize("variant", ["floyd_steinberg", "jjn", "atkinson"])
@pytest.mark.parametrize("p", [16, 300])
def test_index_stream_bitwise_golden(variant, p):
    """The gathered index stream against the golden engine's f32 twin."""
    frames = _frames(2, 14, 22, 11)
    pal_np = _unique_palette(p, 12)
    idx = twf.ed_batch_wavefront(torch.from_numpy(frames), torch.from_numpy(pal_np),
                                 "fixed", variant, return_indices=True).numpy()
    got = pal_np.astype(np.uint8)[idx]
    for k, frame in enumerate(frames):
        gold = ed_host.ed_fixed_fast(frame.astype(np.float32).copy(), pal_np, variant)
        np.testing.assert_array_equal(got[k], gold.astype(np.uint8))


@pytest.mark.parametrize("mode,kw", [
    ("fixed", {"variant": "floyd_steinberg"}),
    ("hybrid", {"lum_factor": 1.0, "col_factor": 0.2}),
])
def test_index_stream_vs_jax_interpret(mode, kw):
    """The JAX package's own index stream, its packed kernel in interpret
    mode, at 16x20: a second witness under the JAX package's tolerance for
    its CPU scan."""
    imgs = np.random.RandomState(3).randint(0, 256, (3, 16, 20, 3)).astype(np.float32)
    pal_np = _unique_palette(16, 4)
    ref = jwf._run(mode, imgs.copy(), pal_np, return_indices=True, **kw)
    idx = twf.ed_batch_wavefront(torch.from_numpy(imgs), torch.from_numpy(pal_np), mode,
                                 return_indices=True, **kw).numpy()
    assert ref.dtype == idx.dtype == np.uint8 and ref.shape == idx.shape == (3, 16, 20)
    assert (ref == idx).mean() >= 0.98
    pal_u8 = pal_np.astype(np.uint8)
    for a, b in zip(pal_u8[idx], pal_u8[ref]):
        assert_perceptually_matched(a, b, min_identical=0.98, block=4,
                                    max_block_mean=8.0, max_block_max=48.0)


def test_return_indices_above_1024_colours_raises():
    frames = torch.zeros((1, 4, 5, 3), dtype=torch.uint8)
    pal = torch.from_numpy(_unique_palette(1025, 1))
    with pytest.raises(ValueError, match="return_indices requires a palette <= 1024"):
        twf.ed_batch_wavefront(frames, pal, return_indices=True)
    # The colour path still serves it (K1 -> K8 -> K9).
    assert twf.ed_batch_wavefront(frames, pal).shape == frames.shape
