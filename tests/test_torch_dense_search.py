"""The dense-search path of the port (``dense_search="mxu"`` and ``"auto"``,
``DITHER_PIE_TPU_DENSE_SEARCH``) on the CPU: the score search of the scan's
plain version, the augmented palette, the first-batch gate, the fidelity
metrics and the search probe's plain versions, with a numpy model of the
probe kernel's cluster split (slices, per-slice extremum, rank-order merge).

Tolerances:
* ``augment_palette`` against the JAX package's ``_pad_palette_aug``:
  bitwise (the same three products and two sums in float32);
* the plain score pick against a numpy twin written here: exact (indices);
* the score scan against the port's exact scan, and against the JAX
  package's interpreted ``mxu`` run: perceptual (identity >= 0.98, 4x4
  block mean <= 8, max <= 48, the gate of tests/test_wavefront.py). The
  score search is another function than the exact one (near ties may flip)
  and XLA:CPU's ``dot`` rounds in its own order, so neither is bitwise;
* where the score search does not run (P <= 64, P > 1024) and between the
  score path's own outputs (colours, indices, planar): bitwise;
* the fidelity metrics against the JAX package's numpy ones: identity
  exact; block means within 1e-9 (float64 sums in another order).

chip_smoke.py holds the CUDA kernels to the same plain versions on the card.
"""

import os

import numpy as np
import pytest
import torch

from dither_pie_tpu.core import fidelity as jfid
from dither_pie_tpu.core.fidelity import assert_perceptually_matched
from dither_pie_tpu.ops import wavefront as jwf
import dither_pie_tpu_torch as tdpt
from dither_pie_tpu_torch import convert
from dither_pie_tpu_torch.core import fidelity as tfid
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.ops import wavefront as twf
from dither_pie_tpu_torch.tools import proto_mxu_search as probe
import torch_workers  # noqa: F401


def _frames(b, h, w, seed, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    return rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32)


def _unique_palette(p, seed):
    rng = np.random.RandomState(seed)
    pal = np.unique(rng.randint(0, 256, (8 * p + 64, 3)), axis=0)
    return pal[rng.permutation(len(pal))[:p]].astype(np.float32)


def _similar(a, b):
    assert_perceptually_matched(a.astype(np.float32), b.astype(np.float32),
                                min_identical=0.98, block=4, max_block_mean=8.0,
                                max_block_max=48.0)


def _mode_kw(mode, frames):
    """Keyword arguments of ed_batch_wavefront for a mode on these frames."""
    if mode == "adaptive":
        gates = np.random.RandomState(5).rand(*frames.shape[:3]) < 0.5
        return {"aux": torch.from_numpy(gates.astype(np.float32))}
    if mode == "hybrid":
        return {"lum_factor": 0.7, "col_factor": 0.45}
    return {}


# ---------------------------------------------------------------------------
# The augmented palette and the score pick
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 65, 100, 256, 1024])
def test_augment_palette_bitwise_equals_jax(p):
    rng = np.random.RandomState(p)
    pal = rng.randint(0, 256, (p, 3)).astype(np.float32)
    pal[0] = (254.9, 0.25, 17.5)  # the gamma path's palettes are not integers
    pp = max(8, 1 << (p - 1).bit_length())
    ref = jwf._pad_palette_aug(pal, pp)[:p, :4]
    got = convert.augment_palette(torch.from_numpy(pal))
    assert got.shape == (p, 4) and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))
    with pytest.raises(ValueError):
        convert.augment_palette(torch.zeros((p, 4)))


def _score_pick_twin(cur, pal):
    """numpy twin of the score pick: cur (3, N) float32, pal (P, 3) -> (N,)
    first maximum of ((r*x_r + g*x_g) + b*x_b) + n, n = -0.5*((r*r + g*g) +
    b*b), every operation in float32."""
    f = np.float32
    n = f(-0.5) * ((pal[:, 0] * pal[:, 0] + pal[:, 1] * pal[:, 1]) + pal[:, 2] * pal[:, 2])
    score = ((pal[:, 0, None] * cur[0][None] + pal[:, 1, None] * cur[1][None])
             + pal[:, 2, None] * cur[2][None]) + n[:, None]
    assert score.dtype == f
    return np.argmax(score, axis=0)  # numpy's argmax: the first maximum


def _exact_pick_twin(cur, pal):
    d = cur[None] - pal[:, :, None]  # (P, 3, N)
    sq = d * d
    return np.argmin((sq[:, 0] + sq[:, 1]) + sq[:, 2], axis=0)


@pytest.mark.parametrize("pp", [65, 256, 1024])
def test_probe_plain_versions_equal_numpy_twins(pp):
    """T2's shapes at a small lf: both plain searches against numpy twins,
    with planted duplicate colours (the first index wins) and lanes that sit
    exactly on a palette colour."""
    nb, lf = 8, 24
    cur, pal = probe.probe_inputs(pp, nb, lf, seed=pp)
    pal[pp - 1] = pal[3]
    pal[pp // 2] = pal[7]
    cur[[0, nb, 2 * nb], :5] = pal[3][:, None]  # frame 0, lanes 0-4: colour 3 exactly
    cur[[1, nb + 1, 2 * nb + 1], :5] = pal[7][:, None]
    cur_t, pal_t = torch.from_numpy(cur), torch.from_numpy(pal)
    flat = cur.reshape(3, nb * lf)
    exact = probe.search_exact(cur_t, pal_t)
    score = probe.search_score(cur_t, convert.augment_palette(pal_t), iters=3)
    assert exact.shape == score.shape == (nb, lf) and exact.dtype == score.dtype == torch.int32
    np.testing.assert_array_equal(exact.numpy().ravel(), _exact_pick_twin(flat, pal))
    np.testing.assert_array_equal(score.numpy().ravel(), _score_pick_twin(flat, pal))
    for got in (exact, score):
        assert not np.isin(got.numpy(), [pp - 1, pp // 2]).any()  # later copies never win
        assert (got[0, :5] == 3).all() and (got[1, :5] == 7).all()
    assert 0.0 <= probe.flip_fraction(exact, score) <= 0.02
    assert not build.LAUNCHES  # CPU tensors never launch a kernel


def cluster_search_model(cur, pal, n, score):
    """numpy model of ``search_probe.cu``'s cluster split: cur (3, N)
    float32, pal (P, 3) -> (N,). Rank r searches the slice [lo_r, lo_{r+1})
    of ``twf.palette_slices(P, n)`` for its first strict extremum, with key
    the distance or the negated score (exact), and the candidates merge in
    rank order keeping the first strict minimum of the key."""
    bounds = twf.palette_slices(len(pal), n)
    best_key = best_idx = None
    for r in range(n):
        lo, hi = bounds[r], bounds[r + 1]
        if score:
            f = np.float32
            sl = pal[lo:hi]
            nrm = f(-0.5) * ((sl[:, 0] * sl[:, 0] + sl[:, 1] * sl[:, 1]) + sl[:, 2] * sl[:, 2])
            val = ((sl[:, 0, None] * cur[0][None] + sl[:, 1, None] * cur[1][None])
                   + sl[:, 2, None] * cur[2][None]) + nrm[:, None]
            local = np.argmax(val, axis=0)
            key = -val[local, np.arange(cur.shape[1])]
        else:
            d = cur[None] - pal[lo:hi, :, None]
            sq = d * d
            val = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
            local = np.argmin(val, axis=0)
            key = val[local, np.arange(cur.shape[1])]
        assert key.dtype == np.float32
        if r == 0:
            best_key, best_idx = key, lo + local
        else:
            take = key < best_key  # strict: a tie keeps the lower rank
            best_key = np.where(take, key, best_key)
            best_idx = np.where(take, lo + local, best_idx)
    return best_idx


@pytest.mark.parametrize("form", ["exact", "score"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("pp", [65, 256, 1024])
def test_probe_cluster_model_equals_plain(pp, n, form):
    """The cluster split of T2 (slices, per-slice strict extremum,
    rank-order merge) == the single sweep's plain version, bit for bit, on
    a palette with duplicate colours planted across every slice border (the
    lower index, in the lower rank, must win) and lanes on those colours."""
    nb, lf = 8, 24
    cur, pal = probe.probe_inputs(pp, nb, lf, seed=pp + n)
    bounds = twf.palette_slices(pp, n)
    planted = []
    for k, lo in enumerate(bounds[1:-1]):
        pal[lo] = pal[lo - 1]  # the first colour of rank k + 1 repeats the last of rank k
        cur[[k % nb, nb + k % nb, 2 * nb + k % nb], 8 + k] = pal[lo]
        planted.append(lo)
    pal[pp - 1] = pal[2]  # a far copy in the last slice
    cur[[0, nb, 2 * nb], :4] = pal[2][:, None]
    planted.append(pp - 1)
    cur_t, pal_t = torch.from_numpy(cur), torch.from_numpy(pal)
    if form == "exact":
        want = probe.search_exact(cur_t, pal_t)
    else:
        want = probe.search_score(cur_t, convert.augment_palette(pal_t))
    got = cluster_search_model(cur.reshape(3, nb * lf), pal, n, form == "score")
    np.testing.assert_array_equal(got, want.numpy().ravel())
    assert not np.isin(got, planted).any()  # later copies never win
    assert (want[0, :4] == 2).all()


@pytest.mark.parametrize("form", ["exact", "score"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_probe_cluster_model_on_kmeans_inputs(n, form):
    """The second input set (a k-means palette of a photo-like frame and
    its pixels plus a diffused error, not integers): the cluster model ==
    the plain version, bit for bit."""
    nb, lf, pp = 8, 24, 65
    cur, pal = probe.kmeans_inputs(pp, nb, lf)
    assert cur.shape == (3 * nb, lf) and pal.shape == (pp, 3)
    assert (cur != np.round(cur)).mean() > 0.5 and 0 <= cur.min() and cur.max() <= 255
    cur_t, pal_t = torch.from_numpy(cur), torch.from_numpy(pal)
    if form == "exact":
        want = probe.search_exact(cur_t, pal_t)
    else:
        want = probe.search_score(cur_t, convert.augment_palette(pal_t))
    got = cluster_search_model(cur.reshape(3, nb * lf), pal, n, form == "score")
    np.testing.assert_array_equal(got, want.numpy().ravel())


def test_probe_cluster_sizes():
    """The probe's blocks a frame: the scan's table unless given; a size the
    kernel does not take, or more blocks than colours, is refused."""
    assert [probe.probe_cluster_size(p) for p in (1, 55, 56, 127, 128, 1024)] == [
        1, 1, 4, 4, 8, 8]
    assert probe.probe_cluster_size(256, 2) == 2
    with pytest.raises(ValueError):
        probe.probe_cluster_size(256, 3)
    with pytest.raises(ValueError):
        probe.probe_cluster_size(4, 8)


def test_probe_step_fit():
    """``fit_step`` recovers c_n + k * P / n from times made by it."""
    k, c = 0.035, {1: 1.6, 2: 2.7, 4: 2.9, 8: 3.5}
    times = {n: {p: c[n] + k * p / n for p in (64, 256, 1024)} for n in c}
    k_fit, c_fit, resid = probe.fit_step(times)
    assert abs(k_fit - k) < 1e-9 and resid < 1e-9
    assert all(abs(c_fit[n] - c[n]) < 1e-9 for n in c)


def test_probe_refuses_bad_inputs():
    cur, pal = (torch.from_numpy(a) for a in probe.probe_inputs(8, 2, 4))
    with pytest.raises(ValueError, match=r"\(pp, 4\)"):
        probe.search_score(cur, pal)
    with pytest.raises(ValueError, match=r"\(pp, 3\)"):
        probe.search_exact(cur, convert.augment_palette(pal))
    with pytest.raises(ValueError, match="cur must be"):
        probe.search_exact(cur[:5], pal)


@pytest.mark.parametrize("p", [65, 300])
def test_scan_score_pick_first_index_wins(p):
    """Flat frames that sit exactly on a palette colour and planted later
    duplicates of it: every pixel is an exact hit (score = |c|^2/2, the
    strict maximum), and the first copy's index is the one emitted."""
    pal = _unique_palette(p, 1)
    pal[p - 1] = pal[3]
    pal[p // 2] = pal[7]
    frames = np.zeros((2, 9, 12, 3), np.uint8)
    frames[0] = pal[3].astype(np.uint8)
    frames[1] = pal[7].astype(np.uint8)
    geom = twf.scan_geometry("floyd_steinberg")
    stream = twf.skew(torch.from_numpy(frames), geom.s)
    idx = twf.scan_idx(stream, torch.from_numpy(pal), geom, 12, dense_search="mxu").numpy()
    assert np.isin(idx[:, 0], [0, 3]).all() and np.isin(idx[:, 1], [0, 7]).all()
    assert (idx[:, 0] == 3).sum() == (idx[:, 1] == 7).sum() == 9 * 12
    out = twf.ed_batch_wavefront(torch.from_numpy(frames), torch.from_numpy(pal),
                                 dense_search="mxu").numpy()
    np.testing.assert_array_equal(out, frames)


# ---------------------------------------------------------------------------
# The score scan: against the exact scan, the JAX package, and itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("mode", twf.MODES)
def test_score_scan_matches_exact_scan_perceptually(mode, dtype):
    frames = _frames(2, 12, 18, 17, dtype)
    pal = torch.from_numpy(_unique_palette(256, 17))
    kw = _mode_kw(mode, frames)
    x = torch.from_numpy(frames)
    exact = twf.ed_batch_wavefront(x, pal, mode, **kw).numpy()
    score = twf.ed_batch_wavefront(x, pal, mode, dense_search="mxu", **kw).numpy()
    assert score.shape == frames.shape and score.dtype == np.uint8
    for a, b in zip(score, exact):
        _similar(a, b)


def test_score_scan_matches_jax_interpreted_mxu_run():
    """The shape of the JAX package's test_mxu_dense_search_matches_exact:
    2 x 12 x 18, 256 colours. Its interpreted ``mxu`` run is a perceptual
    witness only."""
    rng = np.random.RandomState(17)
    frames = rng.randint(0, 256, (2, 12, 18, 3)).astype(np.float32)
    pal = np.unique(rng.randint(0, 256, (700, 3)), axis=0)[:256].astype(np.float32)
    ref = jwf._run("fixed", frames.copy(), pal, variant="floyd_steinberg",
                   dense_search="mxu", interpret=True)
    out = twf.ed_batch_wavefront(torch.from_numpy(frames), torch.from_numpy(pal),
                                 dense_search="mxu").numpy()
    for a, b in zip(out, ref):
        _similar(a, b)


@pytest.mark.parametrize("mode", twf.MODES)
@pytest.mark.parametrize("p", [64, 2048])
def test_score_search_not_taken_outside_its_range(p, mode):
    """P <= 64 and P > PACKED_PALETTE_MAX run the exact search whatever is
    asked: the output is the exact one bit for bit."""
    frames = _frames(2, 8, 11, p, np.uint8)
    pal = torch.from_numpy(_unique_palette(p, p))
    kw = _mode_kw(mode, frames)
    x = torch.from_numpy(frames)
    assert not twf.score_search("mxu", p)
    assert torch.equal(twf.ed_batch_wavefront(x, pal, mode, dense_search="mxu", **kw),
                       twf.ed_batch_wavefront(x, pal, mode, **kw))
    assert torch.equal(twf.ed_batch_wavefront(x, pal, mode, dense_search="auto", **kw),
                       twf.ed_batch_wavefront(x, pal, mode, **kw))


def test_score_search_range_and_values():
    assert [twf.score_search("mxu", p) for p in (1, 64, 65, 1024, 1025)] == [
        False, False, True, True, False]
    assert not twf.score_search("exact", 256)
    for bad in ("auto", "MXU", None):
        with pytest.raises(ValueError, match="dense_search"):
            twf.score_search(bad, 256)
    with pytest.raises(ValueError, match="dense_search"):
        twf.wavefront_device_fn("fixed", "floyd_steinberg", 4, 5, 100, 1, dense_search="auto")
    with pytest.raises(ValueError, match="dense_search"):
        twf.ed_batch_wavefront(torch.zeros((1, 4, 5, 3), dtype=torch.uint8),
                               torch.zeros((100, 3)), dense_search="fast")


@pytest.mark.parametrize("mode", twf.MODES)
@pytest.mark.parametrize("p", [100, 300])
def test_score_indices_and_planar_equal_the_rgb_score_output(p, mode):
    """The score search is orthogonal to the output: the index stream
    gathered through the palette and the planar output transposed are the
    RGB NHWC score output bit for bit (u8 indices at 100 colours, u16 at
    300)."""
    frames = _frames(2, 9, 13, 3, np.uint8)
    pal_np = _unique_palette(p, 3)
    pal, x = torch.from_numpy(pal_np), torch.from_numpy(frames)
    kw = dict(_mode_kw(mode, frames), dense_search="mxu")
    rgb = twf.ed_batch_wavefront(x, pal, mode, **kw).numpy()
    idx = twf.ed_batch_wavefront(x, pal, mode, return_indices=True, **kw)
    assert idx.dtype == twf.index_dtype(p)
    np.testing.assert_array_equal(pal_np.astype(np.uint8)[idx.numpy()], rgb)
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, -1, 0)))
    planar = twf.ed_batch_wavefront(planes, pal, mode, planar=True, **kw).numpy()
    np.testing.assert_array_equal(np.moveaxis(planar, 0, -1), rgb)
    fn = twf.wavefront_device_fn(mode, "floyd_steinberg", 9, 13, p, 2, planar=True,
                                 lum_factor=kw.get("lum_factor", 1.0),
                                 col_factor=kw.get("col_factor", 0.2), dense_search="mxu")
    aux = twf.perceptual_sensitivity(x) if mode == "perceptual" else kw.get("aux")
    np.testing.assert_array_equal(fn(planes, pal, aux).numpy(), planar)


def test_score_search_differs_from_exact_somewhere():
    """The score search is a different function: near a tie the two pick
    different colours, so the tests above discriminate. Working values a few
    float32 steps above 100.5, between the colours 100 (first) and 101: the
    exact search sees 101 nearer; the two scores differ by x - 100.5, far
    below a step of their size (~28,000), so they round to a tie or apart.
    The port's plain versions follow their numpy twins at every value."""
    pal = np.zeros((70, 3), np.float32)
    pal[:, 0] = np.arange(70) * 3.0 + 300.0  # far away
    pal[5] = (100, 77, 200)
    pal[9] = (101, 77, 200)
    n = 48
    cur = np.empty((3, n), np.float32)
    cur[0] = np.float32(100.5) + np.arange(1, n + 1, dtype=np.float32) * np.float32(2.0 ** -17)
    cur[1], cur[2] = 77.0, 200.0
    exact, score = _exact_pick_twin(cur, pal), _score_pick_twin(cur, pal)
    assert (exact == 9).all()  # 101 is nearer, every time
    assert (score == 5).any()  # the score form gives some to the first colour
    cur_t, pal_t = torch.from_numpy(cur), torch.from_numpy(pal)
    np.testing.assert_array_equal(probe.search_exact(cur_t, pal_t).numpy()[0], exact)
    np.testing.assert_array_equal(
        probe.search_score(cur_t, convert.augment_palette(pal_t)).numpy()[0], score)


# ---------------------------------------------------------------------------
# The first-batch gate
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_run(monkeypatch):
    """``_run`` replaced by a recorder, as tests/test_wavefront.py patches
    the JAX package's: returns a fixed batch, or zeros for a "bad" score
    run, or raises."""
    base = torch.from_numpy(_frames(2, 12, 16, 4, np.uint8))
    calls = []

    def run(mode, images, palette, variant="", aux=None, lum_factor=1.0,
            col_factor=0.2, planar=False, return_indices=False, dense_search="exact"):
        calls.append(dense_search)
        if dense_search == "mxu" and run.mxu == "bad":
            return torch.zeros_like(base)
        if dense_search == "mxu" and run.mxu == "raise":
            raise RuntimeError("the score run failed")
        return base.clone()

    run.mxu = "good"
    run.calls = calls
    run.base = base
    monkeypatch.setattr(twf, "_run", run)
    twf._DENSE_GATE_CACHE.clear()
    yield run
    twf._DENSE_GATE_CACHE.clear()


def test_dense_search_auto_gate(fake_run):
    calls, base = fake_run.calls, fake_run.base
    imgs = torch.from_numpy(_frames(2, 12, 16, 5, np.float32))
    pal = torch.from_numpy(_unique_palette(100, 4))

    out = twf.ed_batch_wavefront(imgs, pal, dense_search="auto")
    assert torch.equal(out, base)
    assert calls == ["exact", "mxu"]  # the first batch runs both
    twf.ed_batch_wavefront(imgs, pal, dense_search="auto")
    assert calls[2:] == ["mxu"]  # locked in: one run
    # Another key (variant, mode, factors or palette) is gated anew.
    twf.ed_batch_wavefront(imgs, pal, variant="jjn", dense_search="auto")
    assert calls[3:] == ["exact", "mxu"]
    twf.ed_batch_wavefront(imgs, pal + 1.0, dense_search="auto")
    assert calls[5:] == ["exact", "mxu"]
    assert len(twf._DENSE_GATE_CACHE) == 3
    # A caller that holds the palette's bytes hands them over as the key:
    # the same bytes meet the verdict above, other bytes are gated anew.
    calls.clear()
    twf.ed_batch_wavefront(imgs, pal, dense_search="auto", palette_key=pal.numpy().tobytes())
    assert calls == ["mxu"]
    twf.ed_batch_wavefront(imgs, pal, dense_search="auto", palette_key=b"another palette")
    assert calls[1:] == ["exact", "mxu"]

    # A score output that differs too much locks the exact search.
    calls.clear()
    twf._DENSE_GATE_CACHE.clear()
    fake_run.mxu = "bad"
    out = twf.ed_batch_wavefront(imgs, pal, dense_search="auto")
    assert torch.equal(out, base)
    assert calls == ["exact", "mxu"]
    twf.ed_batch_wavefront(imgs, pal, dense_search="auto")
    assert calls[2:] == ["exact"]

    # Small and very large palettes never enter the gate; an explicit
    # choice bypasses it.
    calls.clear()
    for p in (4, 64, 1025):
        twf.ed_batch_wavefront(imgs, torch.from_numpy(_unique_palette(p, p)),
                               dense_search="auto")
    twf.ed_batch_wavefront(imgs, pal, dense_search="mxu")
    twf.ed_batch_wavefront(imgs, pal)
    assert calls == ["exact", "exact", "exact", "mxu", "exact"]


def test_dense_search_auto_gate_propagates_a_failing_score_run(fake_run):
    """The JAX package locks "exact" when its mxu run raises; the port
    raises, and decides nothing."""
    fake_run.mxu = "raise"
    imgs = torch.from_numpy(_frames(2, 12, 16, 5, np.uint8))
    pal = torch.from_numpy(_unique_palette(100, 4))
    with pytest.raises(RuntimeError, match="the score run failed"):
        twf.ed_batch_wavefront(imgs, pal, dense_search="auto")
    assert fake_run.calls == ["exact", "mxu"] and not twf._DENSE_GATE_CACHE


def test_dense_search_auto_gate_decides_once_under_threads(fake_run):
    """The video pipeline's overlap workers reach the gate at once: more
    threads than cores on one undecided key run both searches once, and
    every other call takes the verdict."""
    import sys
    import threading

    imgs = torch.from_numpy(_frames(2, 12, 16, 5, np.uint8))
    pal = torch.from_numpy(_unique_palette(100, 4))
    n_threads = 4 * (os.cpu_count() or 1)
    start = threading.Barrier(n_threads)
    outs = []

    def call():
        start.wait(timeout=60)
        outs.append(twf.ed_batch_wavefront(imgs, pal, dense_search="auto"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(outs) == n_threads and all(torch.equal(o, fake_run.base) for o in outs)
    assert sorted(fake_run.calls) == ["exact"] + ["mxu"] * n_threads
    assert fake_run.calls[:2] == ["exact", "mxu"]


def test_dense_search_auto_gate_cache_is_bounded(fake_run):
    imgs = torch.from_numpy(_frames(2, 12, 16, 5, np.uint8))
    for i in range(twf._DENSE_GATE_MAX_KEYS + 3):
        pal = torch.from_numpy(_unique_palette(70, 1000 + i))
        twf.ed_batch_wavefront(imgs, pal, dense_search="auto")
        assert len(twf._DENSE_GATE_CACHE) <= twf._DENSE_GATE_MAX_KEYS + 1


@pytest.mark.parametrize("kw", [{}, {"return_indices": True}, {"planar": True},
                                {"planar": True, "return_indices": True}],
                         ids=["rgb", "indices", "planar", "planar-indices"])
def test_dense_search_auto_gate_real_run_locks_the_score_search(kw):
    """The gate on the real plain scan, every output shape: at 2 x 12 x 18
    and 300 colours the score output passes the thresholds, "mxu" is locked
    in, and the first call returns the score output."""
    twf._DENSE_GATE_CACHE.clear()
    frames = _frames(2, 12, 18, 9, np.uint8)
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, -1, 0))
                         if kw.get("planar") else frames)
    pal = torch.from_numpy(_unique_palette(300, 9))
    out = twf.ed_batch_wavefront(x, pal, dense_search="auto", **kw)
    assert list(twf._DENSE_GATE_CACHE.values()) == ["mxu"]
    want = twf.ed_batch_wavefront(x, pal, dense_search="mxu", **kw)
    assert out.dtype == want.dtype  # uint16 indices at 300 colours
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    twf._DENSE_GATE_CACHE.clear()


# ---------------------------------------------------------------------------
# The facade and the environment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value,batch_search,single_search", [
    (None, "exact", "exact"), ("exact", "exact", "exact"), ("mxu", "mxu", "mxu"),
    ("auto", "auto", "exact")])
def test_facade_follows_environment(monkeypatch, value, batch_search, single_search):
    """DITHER_PIE_TPU_DENSE_SEARCH is read in the api layer and handed to
    ``ed_batch_wavefront`` as an argument; a single image never enters the gate."""
    from PIL import Image

    if value is None:
        monkeypatch.delenv("DITHER_PIE_TPU_DENSE_SEARCH", raising=False)
    else:
        monkeypatch.setenv("DITHER_PIE_TPU_DENSE_SEARCH", value)
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    seen, keys = [], []
    real = twf.ed_batch_wavefront

    def spy(images, palette, mode="fixed", **kw):
        seen.append(kw.get("dense_search"))
        keys.append(kw.get("palette_key"))
        return real(images, palette, mode, **{**kw, "dense_search": "exact"})

    monkeypatch.setattr(twf, "ed_batch_wavefront", spy)
    palette = [tuple(int(v) for v in c) for c in _unique_palette(70, 2)]
    ditherer = tdpt.ImageDitherer(num_colors=70, dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                                  palette=palette, dither_params={"variant": "floyd_steinberg"},
                                  device="cpu")
    frames = _frames(2, 8, 10, 1, np.uint8)
    ditherer.apply_dithering_batch(frames)
    ditherer.apply_dithering_batch(np.ascontiguousarray(np.moveaxis(frames, -1, 0)), planar=True)
    ditherer.apply_dithering(Image.fromarray(frames[0]))
    assert seen == [batch_search, batch_search, single_search]
    # The gate's key is the host palette's bytes, and only "auto" needs it.
    host_key = np.asarray(palette, np.float32).tobytes()
    assert keys == [host_key if search == "auto" else None for search in seen]


def test_facade_refuses_unknown_environment_value(monkeypatch):
    monkeypatch.setenv("DITHER_PIE_TPU_DENSE_SEARCH", "fast")
    ditherer = tdpt.ImageDitherer(num_colors=4, dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                                  palette=[(0, 0, 0), (255, 255, 255)], device="cpu")
    with pytest.raises(ValueError, match="DITHER_PIE_TPU_DENSE_SEARCH"):
        ditherer.apply_dithering_batch(_frames(1, 4, 5, 0, np.uint8))


def test_facade_mxu_output_is_the_score_output_of_ed_batch_wavefront(monkeypatch):
    monkeypatch.setenv("DITHER_PIE_TPU_DENSE_SEARCH", "mxu")
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")
    pal_np = _unique_palette(128, 6)
    palette = [tuple(int(v) for v in c) for c in pal_np]
    frames = _frames(2, 10, 14, 6, np.uint8)
    for mode, wmode in ((tdpt.DitherMode.ERROR_DIFFUSION, "fixed"),
                        (tdpt.DitherMode.OSTROMOUKHOV, "ostromoukhov")):
        params = {"variant": "floyd_steinberg"} if wmode == "fixed" else {}
        ditherer = tdpt.ImageDitherer(num_colors=128, dither_mode=mode, palette=palette,
                                      dither_params=params, device="cpu")
        want = twf.ed_batch_wavefront(torch.from_numpy(frames), torch.from_numpy(pal_np), wmode,
                                      dense_search="mxu").numpy()
        np.testing.assert_array_equal(ditherer.apply_dithering_batch(frames), want)
        monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "1")
        np.testing.assert_array_equal(ditherer.apply_dithering_batch(frames), want)
        monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")


# ---------------------------------------------------------------------------
# The fidelity metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,block", [(12, 16, 4), (13, 18, 4), (3, 9, 4), (8, 8, 8), (10, 7, 2)])
def test_fidelity_equals_jax_package(h, w, block):
    rng = np.random.RandomState(h * w)
    a = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    b = a.copy()
    flip = rng.rand(h, w) < 0.3
    b[flip] = rng.randint(0, 256, (int(flip.sum()), 3))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert tfid.identity_fraction(ta, tb) == jfid.identity_fraction(a, b)
    assert tfid.identity_fraction(ta, ta) == 1.0
    got = tfid.block_mean_error(ta, tb, block=block)
    want = jfid.block_mean_error(a.astype(np.float32), b.astype(np.float32), block=block)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert tfid.block_mean_error(ta, ta, block=block) == (0.0, 0.0)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfid.identity_fraction(ta, tb[:-1])
    with pytest.raises(ValueError, match="shape mismatch"):
        tfid.block_mean_error(ta, tb[:, :-1])
