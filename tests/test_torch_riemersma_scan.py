"""The port's Riemersma scan (dither_pie_tpu_torch.ops.riemersma_scan, the
plain version of R1, and ``DITHER_PIE_TPU_RIEMERSMA=scan`` in the facade)
against the host engine and the JAX package, on the CPU.

Tolerances: the curve's maps equal the JAX package's ``_path_maps`` bit
for bit, and the plain version equals the port's host engine
(``ed_host.ed_riemersma_fast``, the float32 twin) bit for bit at every
shape, palette size (2 to 300), input dtype and tie case here: both run
separate float32 roundings in the same order, with no contraction into an
FMA. Against the JAX package's ``riemersma_scan_batch`` on the CPU the
standard is the JAX tests' own: bitwise at the three shapes where
``tests/test_riemersma_scan.py::test_scan_matches_cxx_twin`` is bitwise,
and ``assert_perceptually_matched(min_identical=0.99)`` on the adversarial
four-colour content, because XLA:CPU contracts the scan's ``a*b + c`` into
FMA and flips rare near ties there (ROADMAP C2); on that content the plain
version is also held to the host engine bitwise. R1's staging
(``staged_records``) is held to ``path_maps`` and the frame exactly, and
``r1_model``, a numpy float32 model of R1's walk (whole chunks, the ring,
the three search forms with their lane split, merges and tie rule), to the
plain version bitwise. Under the switch a CPU device runs the float32 twin
itself (bitwise, a 1080p frame) up to 4096 colours and the plain loop
above. Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import dither_pie_tpu_torch as tdpt
from dither_pie_tpu.core.fidelity import assert_perceptually_matched
from dither_pie_tpu.ops import riemersma_scan as jscan
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.ops import ed_host as thost
from dither_pie_tpu_torch.ops import riemersma_scan as tscan
import torch_workers  # noqa: F401

SHAPES = [(16, 16), (13, 22), (34, 18), (1, 97), (97, 1), (33, 65)]
PALETTES = [2, 16, 32, 300]
SHAPE_IDS = [f"{h}x{w}" for h, w in SHAPES]


def _frames(b, h, w, dtype, seed):
    rng = np.random.RandomState(seed)
    if dtype == "u8":
        return rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    # float32 frames as the facade hands them over, off the integers
    return rng.uniform(0.0, 255.0, (b, h, w, 3)).astype(np.float32)


def _plain(frames, pal):
    b, h, w, _ = frames.shape
    order, wt = tscan.path_maps(h, w)
    return tscan.riemersma_scan_plain(
        torch.from_numpy(np.ascontiguousarray(frames)), torch.from_numpy(pal),
        torch.from_numpy(order.copy()), torch.from_numpy(wt.copy())).numpy()


def _golden(frames, pal):
    return np.stack([thost.ed_riemersma_fast(f.astype(np.float32), pal).astype(np.uint8)
                     for f in frames])


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _decode_masks(mask):
    """numpy model of R1's decoding: the d-th set bit k of a step's mask
    puts FS_WEIGHTS[k] in column d - 1."""
    wt = np.zeros((mask.shape[0], 4), np.float32)
    d = np.zeros(mask.shape[0], np.int64)
    for k in range(4):
        on = (mask >> k) & 1 == 1
        wt[on, d[on]] = tscan.FS_WEIGHTS[k]
        d += on
    return wt


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_path_maps_equal_jax(shape):
    order, wt = tscan.path_maps(*shape)
    jorder, jwt = jscan._path_maps(*shape)
    assert order.dtype == np.int32 and wt.dtype == np.float32
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(_bits(wt), _bits(jwt))
    # R1's one byte a step decodes to the same float32 rows
    mask = tscan.receiver_masks(*shape)
    assert mask.dtype == np.uint8 and mask.shape == order.shape and mask.max() < 16
    np.testing.assert_array_equal(_bits(_decode_masks(mask)), _bits(wt))


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("p", PALETTES)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_equals_host_engine(shape, p, dtype):
    h, w = shape
    frames = _frames(3, h, w, dtype, h * w + p)
    pal = np.random.RandomState(p).randint(0, 256, (p, 3)).astype(np.float32)
    got = _plain(frames, pal)
    assert got.dtype == np.uint8 and got.shape == frames.shape
    np.testing.assert_array_equal(got, _golden(frames, pal))


def _tie_case(name):
    """(frames, palette) whose searches meet exact ties."""
    rng = np.random.RandomState(7)
    if name == "duplicates":  # every colour twice: the lower index must win
        base = rng.randint(0, 256, (8, 3))
        pal = np.concatenate([base, base[::-1]]).astype(np.float32)
        frames = rng.randint(0, 256, (3, 13, 22, 3)).astype(np.uint8)
    elif name == "duplicates_300":  # planted duplicates beyond 32 colours
        base = rng.randint(0, 256, (150, 3))
        pal = np.concatenate([base, base]).astype(np.float32)
        frames = rng.randint(0, 256, (3, 13, 22, 3)).astype(np.uint8)
    elif name == "equidistant_flat":  # flat frames midway between two colours
        pal = np.array([[100, 100, 100], [102, 100, 100], [0, 0, 0]], np.float32)
        frames = np.zeros((3, 16, 16, 3), np.uint8)
        frames[...] = (101, 100, 100)
    else:  # "equidistant_pairs": pairs 2 apart around every grey, odd greys
        greys = np.arange(1, 255, 8)
        pal = np.concatenate([np.stack([greys - 1] * 3, -1),
                              np.stack([greys + 1] * 3, -1)]).astype(np.float32)
        frames = np.repeat(rng.choice(greys, (3, 34, 18, 1)), 3, axis=-1).astype(np.uint8)
    return frames, pal


@pytest.mark.parametrize(
    "case", ["duplicates", "duplicates_300", "equidistant_flat", "equidistant_pairs"])
def test_plain_ties_equal_host_engine(case):
    frames, pal = _tie_case(case)
    np.testing.assert_array_equal(_plain(frames, pal), _golden(frames, pal))
    np.testing.assert_array_equal(_plain(frames.astype(np.float32), pal),
                                  _golden(frames, pal))


@pytest.mark.parametrize("shape", [(16, 16), (13, 22), (34, 18)], ids=str)
def test_plain_equals_jax_scan(shape):
    """The inputs of test_scan_matches_cxx_twin, where the JAX scan is
    bitwise on the CPU too."""
    h, w = shape
    rng = np.random.RandomState(h * w)
    imgs = rng.randint(0, 256, (3, h, w, 3)).astype(np.float32)
    pal = np.unique(rng.randint(0, 256, (40, 3)), axis=0)[:16].astype(np.float32)
    want = jscan.riemersma_scan_batch(imgs.copy(), pal)
    np.testing.assert_array_equal(_plain(imgs, pal), want)
    np.testing.assert_array_equal(want, _golden(imgs, pal))


def test_plain_against_jax_scan_adversarial():
    """The JAX tests' adversarial content: perceptual against the JAX scan
    under XLA:CPU's FMA contraction (C2), bitwise against the host engine."""
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 256, (24, 30, 3), dtype=np.uint8).astype(np.float32)
    pal = np.array([(0, 0, 0), (255, 255, 255), (255, 0, 0), (0, 0, 255)], np.float32)
    got = _plain(arr[None], pal)[0]
    assert_perceptually_matched(got, jscan.riemersma_scan_batch(arr[None].copy(), pal)[0],
                                min_identical=0.99)
    np.testing.assert_array_equal(got, _golden(arr[None], pal)[0])


def _ditherer(pal):
    return tdpt.ImageDitherer(num_colors=len(pal), dither_mode=tdpt.DitherMode.RIEMERSMA,
                              palette=[tuple(int(v) for v in c) for c in pal], device="cpu")


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_facade_scan_switch(monkeypatch, dtype):
    """DITHER_PIE_TPU_RIEMERSMA=scan: dither_batch and dither equal the
    plain version; nothing is launched on the CPU."""
    monkeypatch.setenv("DITHER_PIE_TPU_RIEMERSMA", "scan")
    rng = np.random.RandomState(11)
    pal = rng.randint(0, 256, (16, 3)).astype(np.float32)
    frames = _frames(3, 13, 22, dtype, 5)
    strategy = tdpt.RiemersmaDitherStrategy(device="cpu")
    build.reset_launch_counts()
    out = strategy.dither_batch(frames, pal)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, _plain(frames, pal))
    single = strategy.dither(frames[0].reshape(-1, 3), pal, (13, 22))
    assert single.dtype == np.float32 and single.shape == (13 * 22, 3)
    np.testing.assert_array_equal(single.reshape(13, 22, 3),
                                  _plain(frames[:1], pal)[0].astype(np.float32))
    # and through the facade's entry points
    d = _ditherer(pal)
    u8 = frames.astype(np.uint8)
    np.testing.assert_array_equal(d.apply_dithering_batch(u8), _plain(u8, pal))
    np.testing.assert_array_equal(np.asarray(d.apply_dithering(Image.fromarray(u8[1]))),
                                  _plain(u8[1:2], pal)[0])
    assert dict(build.LAUNCHES) == {}


@pytest.mark.parametrize("value", [None, "", "host", "SCAN"])
def test_facade_without_switch_runs_host_engine(monkeypatch, value):
    """Unset or any value but "scan": the host engine, bitwise as before
    (the float32 twin for batches, the float64 engine for single images)."""
    if value is None:
        monkeypatch.delenv("DITHER_PIE_TPU_RIEMERSMA", raising=False)
    else:
        monkeypatch.setenv("DITHER_PIE_TPU_RIEMERSMA", value)
    rng = np.random.RandomState(12)
    pal = rng.randint(0, 256, (16, 3)).astype(np.float32)
    frames = _frames(3, 13, 22, "u8", 6)
    build.reset_launch_counts()
    d = _ditherer(pal)
    np.testing.assert_array_equal(d.apply_dithering_batch(frames), _golden(frames, pal))
    single = np.asarray(d.apply_dithering(Image.fromarray(frames[0])))
    np.testing.assert_array_equal(
        single, thost.ed_riemersma(frames[0].astype(np.float32), pal).astype(np.uint8))
    assert dict(build.LAUNCHES) == {}


def test_wrapper_routes_and_refuses():
    """CPU tensors take the plain version (uint8 and float32 alike, other
    dtypes as float32); malformed inputs raise; the device maps equal the
    host maps."""
    rng = np.random.RandomState(13)
    pal = rng.randint(0, 256, (5, 3)).astype(np.float32)
    frames = _frames(2, 7, 9, "u8", 8)
    want = _plain(frames, pal)
    pal_t = torch.from_numpy(pal)
    build.reset_launch_counts()
    for f in (torch.from_numpy(frames), torch.from_numpy(frames).float(),
              torch.from_numpy(frames).to(torch.int32)):
        np.testing.assert_array_equal(tscan.riemersma_scan(f, pal_t).numpy(), want)
    np.testing.assert_array_equal(tscan.riemersma_scan_batch(frames, pal, "cpu"), want)
    assert dict(build.LAUNCHES) == {}
    with pytest.raises(ValueError):
        tscan.riemersma_scan(torch.from_numpy(frames[0]), pal_t)
    with pytest.raises(ValueError):
        tscan.riemersma_scan(torch.from_numpy(frames), torch.zeros((0, 3)))
    with pytest.raises(ValueError):
        tscan.riemersma_scan(torch.from_numpy(frames), torch.zeros((tscan.MAX_PALETTE + 1, 3)))
    order, mask = tscan.device_maps(7, 9, torch.device("cpu"))
    assert order.dtype == torch.int32 and mask.dtype == torch.uint8
    np.testing.assert_array_equal(order.numpy(), tscan.path_maps(7, 9)[0])
    np.testing.assert_array_equal(mask.numpy(), tscan.receiver_masks(7, 9))


# ---------------------------------------------------------------------------
# R1's staging and walk (riemersma_scan.cu), modelled in numpy: the
# producer's records, the chain's whole chunks with the ring rotated by
# renaming, and the three search forms with their lane split and merges.
# ---------------------------------------------------------------------------

_INF = np.float32(np.inf)


def _dist(v, pr, pg, pb):
    dr, dg, db = v[0] - pr, v[1] - pg, v[2] - pb
    return (dr * dr + dg * dg) + db * db


def _pick(v, pal):
    """R1's pick for working value v (3,) float32: index and error. Colour
    c lies in lane 31 - c mod 32."""
    p = pal.shape[0]
    lanes = np.arange(32)
    c0 = 31 - lanes
    if p <= 32:  # a colour a lane, +inf past P; the highest lane at the minimum
        col = np.full((32, 3), _INF, np.float32)
        col[c0 < p] = pal[c0[c0 < p]]
        d = _dist(v, col[:, 0], col[:, 1], col[:, 2])
        key = d.view(np.uint32)
        src = int(lanes[key == key.min()].max())
        return 31 - src, v - col[src]
    if p <= 512:  # 8 or 16 colours 31 - lane + 32 j in registers, a tree of strict compares
        npl = tscan.colours_a_lane(p)
        c = c0[None] + 32 * np.arange(npl)[:, None]  # (npl, 32)
        col = np.full((npl, 32, 3), _INF, np.float32)
        col[c < p] = pal[c[c < p]]
        d = _dist(v, col[..., 0], col[..., 1], col[..., 2])
        j_of = np.repeat(np.arange(npl)[:, None], 32, 1)
        span = 1
        while span < npl:
            for j in range(0, npl, 2 * span):
                up = d[j + span] < d[j]
                d[j] = np.where(up, d[j + span], d[j])
                j_of[j] = np.where(up, j_of[j + span], j_of[j])
            span *= 2
        best, best_i = d[0], c0 + 32 * j_of[0]
    else:  # four running minima over colours c0 + 32 a + 128 i, +inf padding
        pp = -(-p // 128) * 128
        padded = np.full((pp, 3), _INF, np.float32)
        padded[:p] = pal
        best = np.empty((4, 32), np.float32)
        ib = np.empty((4, 32), np.int64)
        for a in range(4):
            c = c0 + 32 * a
            best[a], ib[a] = _dist(v, *padded[c].T), c
        for base in range(128, pp, 128):
            for a in range(4):
                c = base + c0 + 32 * a
                dd = _dist(v, *padded[c].T)
                take = dd < best[a]
                best[a], ib[a] = np.where(take, dd, best[a]), np.where(take, c, ib[a])
        for span in (1, 2):
            for a in range(0, 4, 2 * span):
                up = (best[a + span] < best[a]) | ((best[a + span] == best[a])
                                                   & (ib[a + span] < ib[a]))
                best[a] = np.where(up, best[a + span], best[a])
                ib[a] = np.where(up, ib[a + span], ib[a])
        best, best_i = best[0], ib[0]
    key = best.view(np.uint32)
    at_min = key == key.min()
    # one lane at the minimum: its index; lanes that tie: the lowest index
    idx = int(best_i[at_min].min()) if at_min.sum() > 1 else int(best_i[at_min][0])
    return idx, v - pal[idx]


def r1_model(frame, pal):
    """numpy model of one frame through R1: (H, W, 3) -> (H, W, 3) uint8."""
    h, w, _ = frame.shape
    order, mask = tscan.path_maps(h, w)[0], tscan.receiver_masks(h, w)
    head, rec, orders = tscan.staged_records(frame, order, mask)
    select = frame.dtype != np.uint8
    ring = head[:, :3].copy()
    picks = np.empty(rec.shape[0], np.int64)
    for t in range(rec.shape[0]):  # whole chunks, past the curve too
        k = t % 5
        idx, e = _pick(ring[k], pal)
        for d in range(1, 5):
            wt = rec[t, d - 1]
            q = ring[(k + d) % 5]
            v = np.minimum(np.maximum(q + e * wt, np.float32(0)), np.float32(255))
            ring[(k + d) % 5] = v if (not select or wt > 0) else q
        ring[k] = rec[t, 4:7]
        picks[t] = idx
    n = order.shape[0]
    out = np.zeros((h * w, 3), np.uint8)
    out[orders[:n]] = pal[picks[:n]].astype(np.uint8)
    return out.reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(13, 22), (1, 97), (17, 19), (1, 1)], ids=str)
def test_staged_records(shape):
    """The producer's records: weights decode the masks to path_maps' rows,
    the pixel of step t + 5 rides in record t, zeros and order -1 past the
    curve, the head holds steps 0..4, whole chunks."""
    h, w = shape
    frame = _frames(1, h, w, "u8", 3)[0]
    order, wt = tscan.path_maps(h, w)
    head, rec, orders = tscan.staged_records(frame, order, tscan.receiver_masks(h, w))
    n = order.shape[0]
    assert rec.shape[0] % tscan.R1_CHUNK == 0 and 0 <= rec.shape[0] - n < tscan.R1_CHUNK
    px = frame.reshape(-1, 3)[order].astype(np.float32)
    np.testing.assert_array_equal(_bits(rec[:n, :4]), _bits(wt))
    assert not rec[n:].any() and not rec[:, 7].any() and not head[:, 3].any()
    np.testing.assert_array_equal(rec[:max(n - 5, 0), 4:7], px[5:])
    np.testing.assert_array_equal(head[:min(n, 5), :3], px[:5])
    assert not head[n:].any()
    np.testing.assert_array_equal(orders[:n], order)
    assert (orders[n:] == -1).all()


def test_smem_bytes():
    """R1's shared memory: the ring and 12 bytes a colour (the palette
    padded as far as its search form reads: 32, 256, 512 colours, then
    whole 128-colour passes), inside the H100's 232,448 bytes a block at
    MAX_PALETTE colours; the four slots hold four chunks of 32-byte
    records, orders and indices."""
    ring = 2 * tscan.R1_SLOTS * 8 + 80 + tscan.R1_SLOTS * tscan.R1_CHUNK * 40
    assert tscan.smem_bytes(1) == tscan.smem_bytes(32) == ring + 12 * 32
    assert tscan.smem_bytes(33) == tscan.smem_bytes(256) == ring + 12 * 256
    assert tscan.smem_bytes(300) == tscan.smem_bytes(512) == ring + 12 * 512
    assert tscan.smem_bytes(513) == tscan.smem_bytes(640) == ring + 12 * 640
    assert tscan.smem_bytes(tscan.MAX_PALETTE) <= 232448  # an H100 block's most
    assert tscan.R1_CHUNK % 5 == 0 and tscan.R1_CHUNK % 32 == 0


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("p", [2, 32, 33, 256, 257, 300, 513, 700])
def test_r1_model_equals_plain(p, dtype):
    """The model of R1's walk and search forms == the plain version, at
    each form's edges (32 / 33, 256 / 257, 512 / 513 colours)."""
    rng = np.random.RandomState(p)
    pal = rng.randint(0, 256, (p, 3)).astype(np.float32)
    frames = (rng.randint(0, 256, (1, 13, 22, 3)).astype(np.uint8) if dtype == "u8"
              else rng.uniform(-8.0, 263.0, (1, 13, 22, 3)).astype(np.float32))
    np.testing.assert_array_equal(r1_model(frames[0], pal), _plain(frames, pal)[0])


@pytest.mark.parametrize(
    "case", ["duplicates", "duplicates_300", "equidistant_flat", "equidistant_pairs"])
def test_r1_model_ties(case):
    """Exact ties go to the lower palette index in every search form."""
    frames, pal = _tie_case(case)
    np.testing.assert_array_equal(r1_model(frames[0], pal), _plain(frames[:1], pal)[0])


def test_switch_cpu_route_is_the_twin(monkeypatch):
    """DITHER_PIE_TPU_RIEMERSMA=scan on a CPU device, 1080p: the float32
    twin's bits as uint8, batch and single image, and the plain loop never
    runs."""
    monkeypatch.setenv("DITHER_PIE_TPU_RIEMERSMA", "scan")

    def refuse(*a, **k):
        raise AssertionError("the plain loop ran")

    monkeypatch.setattr(tscan, "riemersma_scan_plain", refuse)
    rng = np.random.RandomState(19)
    pal = np.unique(rng.randint(0, 256, (64, 3)), axis=0)[:32].astype(np.float32)
    frame = rng.uniform(0.0, 255.0, (1080, 1920, 3)).astype(np.float32)
    want = thost.ed_riemersma_fast(frame.copy(), pal).astype(np.uint8)
    strategy = tdpt.RiemersmaDitherStrategy(device="cpu")
    out = strategy.dither_batch(frame[None], pal)
    assert out.dtype == np.uint8 and out.shape == (1, 1080, 1920, 3)
    np.testing.assert_array_equal(out[0], want)
    single = strategy.dither(frame.reshape(-1, 3).copy(), pal, (1080, 1920))
    assert single.dtype == np.float32
    np.testing.assert_array_equal(single.reshape(1080, 1920, 3), want.astype(np.float32))


def test_switch_cpu_route_above_twin_runs_plain(monkeypatch):
    """Above F32_TWIN_MAX_PAL colours the twin hands over to float64, so
    the switch keeps the scan's plain loop there."""
    monkeypatch.setenv("DITHER_PIE_TPU_RIEMERSMA", "scan")
    rng = np.random.RandomState(20)
    p = thost.F32_TWIN_MAX_PAL + 4
    pal = np.unique(rng.randint(0, 256, (2 * p, 3)), axis=0)[:p].astype(np.float32)
    frames = _frames(2, 3, 4, "u8", 9)
    want = _plain(frames, pal)
    calls = []
    plain = tscan.riemersma_scan_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(tscan, "riemersma_scan_plain", counted)
    strategy = tdpt.RiemersmaDitherStrategy(device="cpu")
    out = strategy.dither_batch(frames, pal)
    assert calls == [1] and out.dtype == np.uint8
    np.testing.assert_array_equal(out, want)
    single = strategy.dither(frames[0].reshape(-1, 3), pal, (3, 4))
    assert calls == [1, 1]
    np.testing.assert_array_equal(single.reshape(3, 4, 3), want[0].astype(np.float32))
