"""The port's ordered path (dither_pie_tpu_torch.ops.ordered,
ops.ordered_fused) against the JAX package's, on the CPU.

On the CPU the K4 wrapper runs its plain PyTorch version, so these tests
pin down the function the CUDA kernel must compute; chip_smoke.py holds
the kernel to the same plain version on the card. The JAX Pallas kernel
runs in interpret mode, as tests/test_fused_ordered.py runs it.

Every comparison on integer-valued frames is bitwise (the ordered contract
is bit-exact): squared distances of integer pixels and palettes are exact
integers in float32, ties go to the lowest index, and the pick is
d1/(d1+d2) <= screen. float32 frames enter K4 as they are (the wavelet
mode's reconstruction); off the integers K4's direct differences and the
JAX package's expansion x^2 - 2xp + p^2 round differently, so there the
hold is identity >= 0.999 with every difference a near tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dither_pie_tpu.core import distance as jdist
from dither_pie_tpu.core.palette import as_palette_array
from dither_pie_tpu.core.thresholds import bayer_matrix, ign_thresholds
from dither_pie_tpu.ops import ordered as jord
from dither_pie_tpu.ops.ordered_pallas import ordered_dither_fused as jfused
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.ops import ordered as tord
from dither_pie_tpu_torch.ops import ordered_fused as tof
import torch_workers  # noqa: F401

# test_fused_ordered.py's four shapes: (B, H, W), P.
FUSED_CASES = [((2, 40, 56), 16), ((1, 100, 130), 5), ((3, 17, 200), 33),
               ((1, 8, 8), 2)]


def _case(b, h, w, p, seed):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (b, h, w, 3), dtype=np.uint8)
    pal = rng.randint(0, 256, (p, 3)).astype(np.float32)
    screen = np.asarray(jord.screen_for_matrix(bayer_matrix("8x8"), h, w))
    return imgs, pal, screen


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _pixels(n, p, seed):
    rng = np.random.RandomState(seed)
    px = rng.randint(0, 256, (n, 3)).astype(np.float32)
    pal = rng.randint(0, 256, (p, 3)).astype(np.float32)
    return px, pal


# ---------------------------------------------------------------------------
# The nearest colour: K4 against a screen of ones (the NONE mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,p,seed", [(500, 16, 0), (257, 2, 1), (300, 64, 2),
                                      (100, 300, 3)])
def test_screen_of_ones_is_the_nearest_colour(n, p, seed):
    """K4 with a screen of ones picks the JAX package's nearest colour
    (dense (N, P) argmin, lowest index on ties) in colours and indices."""
    px, pal = _pixels(n, p, seed)
    frames, ones = _t(px.astype(np.uint8).reshape(1, 1, n, 3),
                      np.ones((1, n), np.float32))
    tpal = torch.from_numpy(pal)
    np.testing.assert_array_equal(
        tof.ordered_dither_fused(frames, tpal, ones).numpy().reshape(n, 3),
        np.asarray(jdist.map_to_palette(px, pal)).astype(np.uint8))
    if p <= 256:
        np.testing.assert_array_equal(
            tof.ordered_dither_fused(frames, tpal, ones, return_indices=True).numpy().ravel(),
            np.asarray(jdist.nearest_palette_idx(px, pal)))


def _tie_cases():
    # (pixels, palette, expected (i1, i2)): the lowest index wins each tie.
    mid = (np.array([[101, 100, 100]], np.float32),
           np.array([[100, 100, 100], [102, 100, 100], [0, 0, 0]], np.float32),
           (0, 1))
    dup = (np.array([[40, 50, 60]], np.float32),
           np.array([[0, 0, 0], [40, 50, 60], [40, 50, 60]], np.float32),
           (1, 2))
    single = (np.array([[7, 8, 9]], np.float32),
              as_palette_array([(200, 100, 0)]), (0, 1))
    return {"midway": mid, "duplicate": dup, "singleton": single}


@pytest.mark.parametrize("name", ["midway", "duplicate", "singleton"])
def test_exact_ties_lowest_index_wins(name):
    px, pal, (e1, e2) = _tie_cases()[name]
    ref = jdist.top2_palette(jnp.asarray(px), jnp.asarray(pal))
    assert (int(ref[2][0]), int(ref[3][0])) == (e1, e2)
    # K4's running top-2 over a frame of the tied pixel, against every
    # screen level: screen 0 picks i2 unless d1 + d2 == 0 (factor 0).
    frame = np.broadcast_to(px[0].astype(np.uint8), (2, 3, 4, 3)).copy()
    for level in (0.0, 0.5, 1.0):
        screen = np.full((3, 4), level, np.float32)
        for indices in (False, True):
            ours = tof.ordered_dither_fused_plain(*_t(frame, pal, screen),
                                                  return_indices=indices).numpy()
            want = np.asarray(jfused(jnp.asarray(frame), jnp.asarray(pal),
                                     jnp.asarray(screen), interpret=True,
                                     bucket=False, return_indices=indices))
            np.testing.assert_array_equal(ours, want, err_msg=f"{level} {indices}")
    # Screen 1 always picks i1; screen 0 picks i2 unless d1 + d2 == 0.
    tot_zero = name == "duplicate"
    for level, want_idx in ((1.0, e1), (0.0, e1 if tot_zero else e2)):
        idx = tof.ordered_dither_fused_plain(
            *_t(frame, pal, np.full((3, 4), level, np.float32)), return_indices=True)
        assert int(idx.flatten()[0]) == want_idx, level


# ---------------------------------------------------------------------------
# K4's plain version against the JAX kernel and its XLA path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("indices", [False, True], ids=["colours", "indices"])
@pytest.mark.parametrize("case_index", range(len(FUSED_CASES)))
def test_fused_plain_equals_jax_kernel(case_index, indices):
    (b, h, w), p = FUSED_CASES[case_index]
    imgs, pal, screen = _case(b, h, w, p, sum((b, h, w)) + p)
    ours = tof.ordered_dither_fused(*_t(imgs, pal, screen), return_indices=indices)
    assert ours.dtype == torch.uint8
    assert tuple(ours.shape) == ((b, h, w) if indices else (b, h, w, 3))
    ours = ours.numpy()
    ja = [jnp.asarray(imgs), jnp.asarray(pal), jnp.asarray(screen)]
    np.testing.assert_array_equal(ours, np.asarray(jfused(
        *ja, interpret=True, bucket=False, return_indices=indices)))
    if indices:
        np.testing.assert_array_equal(ours, np.asarray(jord.ordered_dither_batch_indices(*ja)))
        np.testing.assert_array_equal(pal.astype(np.uint8)[ours],
                                      np.asarray(jord.ordered_dither_batch(*ja)))
    else:
        np.testing.assert_array_equal(ours, np.asarray(jord.ordered_dither_batch(*ja)))
    assert not build.LAUNCHES  # CPU tensors never launch a kernel


@pytest.mark.parametrize("p,seed", [(300, 6), (4096, 7)])
def test_fused_plain_large_palette_equals_xla(p, seed):
    """Palettes beyond the TPU kernel's 256, up to K4's 4096."""
    imgs, pal, screen = _case(2, 9, 14, p, seed)
    ours = tof.ordered_dither_fused(*_t(imgs, pal, screen)).numpy()
    ref = np.asarray(jord.ordered_dither_batch(
        jnp.asarray(imgs), jnp.asarray(pal), jnp.asarray(screen)))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("mode", ["bayer", "ign"])
def test_dispatch_equals_jax_xla_path(mode):
    """dispatch_ordered_batch on the CPU against every XLA-path entry of
    the JAX package: batch and single frame, colours and indices."""
    b, h, w, p = 3, 21, 34, 12
    imgs, pal, screen = _case(b, h, w, p, 8)
    if mode == "ign":
        screen = np.asarray(ign_thresholds(h, w, 1.3, 9))
    ti, tp, ts = _t(imgs, pal, screen)
    ja = [jnp.asarray(imgs), jnp.asarray(pal), jnp.asarray(screen)]
    ours = tord.dispatch_ordered_batch(ti, tp, ts).numpy()
    ours_idx = tord.dispatch_ordered_batch(ti, tp, ts, return_indices=True).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jord.ordered_dither_batch(*ja)))
    np.testing.assert_array_equal(ours, np.asarray(jord.dispatch_ordered_batch(*ja)))
    np.testing.assert_array_equal(ours[1], np.asarray(jord.ordered_dither(ja[0][1], *ja[1:])))
    np.testing.assert_array_equal(ours_idx,
                                  np.asarray(jord.ordered_dither_batch_indices(*ja)))
    np.testing.assert_array_equal(ours_idx[0],
                                  np.asarray(jord._ordered_indices_one(ja[0][0], *ja[1:])))


@pytest.mark.parametrize("indices", [False, True], ids=["colours", "indices"])
def test_dispatch_on_cpu_is_the_plain_version(indices):
    imgs, pal, screen = _case(2, 13, 19, 7, 10)
    args = _t(imgs, pal, screen)
    np.testing.assert_array_equal(
        tord.dispatch_ordered_batch(*args, return_indices=indices).numpy(),
        tof.ordered_dither_fused_plain(*args, return_indices=indices).numpy())
    # Integer-valued float32 frames give the u8 frames' output; float32
    # frames with fractions are not truncated to it.
    as_f32 = torch.from_numpy(imgs.astype(np.float32))
    np.testing.assert_array_equal(
        tord.dispatch_ordered_batch(as_f32, *args[1:], return_indices=indices).numpy(),
        tof.ordered_dither_fused_plain(*args, return_indices=indices).numpy())
    frac = torch.from_numpy(np.minimum(imgs.astype(np.float32) + 0.75, 255.0))
    got = tord.dispatch_ordered_batch(frac, *args[1:], return_indices=indices)
    assert torch.equal(got, tof.ordered_dither_fused_plain(frac, *args[1:],
                                                           return_indices=indices))
    assert not torch.equal(got, tof.ordered_dither_fused_plain(*args, return_indices=indices))
    assert not build.LAUNCHES


# ---------------------------------------------------------------------------
# float32 frames: the wavelet mode's pick
# ---------------------------------------------------------------------------

F32_CASES = [((2, 40, 56), 16, "random"), ((1, 33, 47), 5, "random"),
             ((3, 17, 60), 33, "ign"), ((2, 24, 32), 256, "random")]


def _f32_case(b, h, w, p, screen_kind, seed):
    rng = np.random.RandomState(seed)
    frames = rng.uniform(0.0, 255.0, (b, h, w, 3)).astype(np.float32)
    pal = rng.randint(0, 256, (p, 3)).astype(np.float32)
    if screen_kind == "ign":
        screen = np.asarray(ign_thresholds(h, w, 1.3, 9))
    else:  # the wavelet mode's screen: uniform random thresholds
        screen = rng.rand(h * w).astype(np.float32).reshape(h, w)
    return frames, pal, screen


def _near_tie(frames, pal, screen, differs):
    """True where a differing pixel is explained in float64: its pick
    factor d1/(d1+d2) is within 1e-5 of its threshold, or its second and
    third (or first and second) distances within 1e-5 relative."""
    px = frames.reshape(-1, 3).astype(np.float64)
    d = np.sort(((px[:, None, :] - pal[None].astype(np.float64)) ** 2).sum(-1), axis=1)
    tot = d[:, 0] + d[:, 1]
    factor = np.where(tot == 0, 0.0, d[:, 0] / np.maximum(tot, 1e-300))
    b = frames.shape[0]
    thr = np.broadcast_to(screen.reshape(1, -1), (b, screen.size)).reshape(-1)
    close = np.abs(factor - thr) <= 1e-5
    third = d[:, 2] if d.shape[1] > 2 else np.full(len(d), np.inf)
    ties = ((d[:, 1] - d[:, 0]) <= 1e-5 * np.maximum(d[:, 1], 1.0)) | (
        (third - d[:, 1]) <= 1e-5 * np.maximum(third, 1.0))
    return (close | ties).reshape(differs.shape) | ~differs


@pytest.mark.parametrize("case_index", range(len(F32_CASES)))
def test_f32_frames_against_jax_ordered_dither(case_index):
    """K4's plain version on non-integer float32 frames against the JAX
    package's ``ordered_dither`` and ``_ordered_indices_one`` (what its
    wavelet mode calls)."""
    (b, h, w), p, kind = F32_CASES[case_index]
    frames, pal, screen = _f32_case(b, h, w, p, kind, 20 + case_index)
    ti, tp, ts = _t(frames, pal, screen)
    ours = tof.ordered_dither_fused(ti, tp, ts).numpy()
    ours_idx = tof.ordered_dither_fused(ti, tp, ts, return_indices=True).numpy()
    assert ours.dtype == np.uint8 and ours_idx.dtype == np.uint8
    np.testing.assert_array_equal(pal.astype(np.uint8)[ours_idx], ours)
    ref = np.stack([np.asarray(jord.ordered_dither(jnp.asarray(f), jnp.asarray(pal),
                                                    jnp.asarray(screen))) for f in frames])
    ref_idx = np.stack([np.asarray(jord._ordered_indices_one(
        jnp.asarray(f), jnp.asarray(pal), jnp.asarray(screen))) for f in frames])
    differs = ours_idx != ref_idx
    assert 1.0 - differs.mean() >= 0.999
    assert _near_tie(frames, pal, screen, differs).all()
    np.testing.assert_array_equal(np.any(ours != ref, axis=-1) & ~differs, False)


@pytest.mark.parametrize("indices", [False, True], ids=["colours", "indices"])
@pytest.mark.parametrize("case_index", range(len(FUSED_CASES)))
def test_integer_valued_f32_frames_bitwise(case_index, indices):
    """Integer-valued float32 frames: the u8 frames' output, and the JAX
    package's, bit for bit."""
    (b, h, w), p = FUSED_CASES[case_index]
    imgs, pal, screen = _case(b, h, w, p, sum((b, h, w)) + p)
    ti, tp, ts = _t(imgs, pal, screen)
    ours = tof.ordered_dither_fused(ti.to(torch.float32), tp, ts, return_indices=indices)
    assert torch.equal(ours, tof.ordered_dither_fused(ti, tp, ts, return_indices=indices))
    ja = [jnp.asarray(imgs, jnp.float32), jnp.asarray(pal), jnp.asarray(screen)]
    ref = jord.ordered_dither_batch_indices(*ja) if indices else jord.ordered_dither_batch(*ja)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_fused_refuses_what_k4_does_not_take():
    imgs, pal, screen = _case(1, 4, 5, 300, 11)
    ti, tp, ts = _t(imgs, pal, screen)
    with pytest.raises(ValueError, match="256"):
        tord.dispatch_ordered_batch(ti, tp, ts, return_indices=True)
    with pytest.raises(ValueError, match="4096"):
        tof.ordered_dither_fused(ti, torch.zeros((4097, 3)), ts)
    with pytest.raises(ValueError, match="screen"):
        tof.ordered_dither_fused(ti, tp, ts[:, :4])
    with pytest.raises(ValueError, match="palette"):
        tof.ordered_dither_fused(ti, tp.double(), ts)
    with pytest.raises(TypeError):
        tof.ordered_dither_fused(ti.to(torch.int32), tp, ts)
    with pytest.raises(ValueError, match="not supported"):
        tof.ordered_dither_fused(ti.to("meta"), tp.to("meta"), ts.to("meta"))
