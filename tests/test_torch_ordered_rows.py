"""K4 (``kernels/csrc/ordered.cu``) held on the CPU: its row plan and a
numpy model of its walk.

The CUDA kernel does not run here, so this file holds what it is built
from. ``ordered_plan`` covers every pixel of the batch exactly once at
ragged widths. The model follows the kernel step for step: block
(x, y, z) takes row y of frames z, z + grid[2], ...; thread t the
ORDERED_PIXELS pixels from x0 = (x*threads + t)*ORDERED_PIXELS; the block
votes whether every palette value is an integer in [0, 255] and, for u8
frames, then runs the integer body (packed keys c_p - 8192 x.p, the
branch-free top-2 m2 = min(m2, max(m1, k)), m1 = min(m1, k), INT_MAX as
m2's sentinel), else the float body. Pixels are loaded as the aligned
32-bit words that cover a thread's run and realigned by a funnel shift,
and the output is stored as 32-bit words with the head and tail bytes one
by one, on flat byte buffers with the tensors at odd offsets and random
bytes around them: every output byte is written exactly once and every
word read overlaps its tensor. The model is held to
``ordered_dither_fused_plain`` bit for bit; the plain version is held to
the JAX package in ``test_torch_ordered.py``.
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu_torch.ops import ordered_fused as tof
import torch_workers  # noqa: F401

INT_MAX = 2**31 - 1
M32 = np.uint64(0xFFFFFFFF)


def _jobs(plan, b, w):
    """(frame, row, first pixel, pixels) of every (block, thread, frame)
    job that holds pixels."""
    gx, gy, gz = plan.grid
    bx, y, z, t = (a.ravel() for a in np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz),
                                                  np.arange(plan.threads), indexing="ij"))
    x0 = (bx * plan.threads + t) * plan.pixels
    keep = x0 < w
    y, z, x0 = y[keep], z[keep], x0[keep]
    frames = [np.arange(zz, b, gz) for zz in range(gz)]
    reps = np.array([len(f) for f in frames])[z]
    bb = np.concatenate([frames[zz] for zz in z]) if len(z) else np.zeros(0, np.int64)
    y, x0 = np.repeat(y, reps), np.repeat(x0, reps)
    return bb, y, x0, np.minimum(plan.pixels, w - x0)


class Bytes:
    """A flat byte buffer with one tensor at ``offset``; random bytes around
    it, ``writes`` counts the stores into each byte."""

    def __init__(self, rng, payload, offset, size):
        self.data = rng.randint(0, 256, offset + size + 16).astype(np.uint8)
        if payload is not None:
            self.data[offset:offset + size] = np.frombuffer(payload, np.uint8)
        self.writes = np.zeros(len(self.data), np.int64)
        self.offset, self.size = offset, size

    def words(self, addr):
        """The aligned 32-bit words at ``addr``, each overlapping the
        tensor (so inside its allocation)."""
        assert np.all(addr % 4 == 0)
        assert np.all((addr + 4 > self.offset) & (addr < self.offset + self.size))
        return self.data[addr[:, None] + np.arange(4)].copy().view("<u4")[:, 0].astype(np.uint64)

    def store(self, addr, byts):
        assert np.all((addr >= self.offset) & (addr < self.offset + self.size))
        self.data[addr] = byts
        np.add.at(self.writes, addr, 1)

    def tensor(self, dtype, shape):
        assert np.all(self.writes[self.offset:self.offset + self.size] == 1)
        assert not self.writes[:self.offset].any()
        assert not self.writes[self.offset + self.size:].any()
        return self.data[self.offset:self.offset + self.size].view(dtype).reshape(shape)


def _funnel_r(lo, hi, shift):
    """__funnelshift_r: the low word of (hi:lo) >> shift."""
    return (((hi << np.uint64(32)) | lo) >> shift.astype(np.uint64)) & M32


def _funnel_l(lo, hi, shift):
    """__funnelshift_l: the high word of (hi:lo) << shift."""
    return ((((hi << np.uint64(32)) | lo) << shift.astype(np.uint64)) >> np.uint64(32)) & M32


def _load_run(mem, lo, nb, nw):
    """The kernel's load_run: bytes [lo, lo + nb) as nw realigned words."""
    a0 = lo & ~3
    u = np.zeros((len(lo), nw + 1), np.uint64)
    for k in range(nw + 1):
        live = a0 + 4 * k < lo + nb
        u[live, k] = mem.words(a0[live] + 4 * k)
    shift = 8 * (lo & 3)
    return [_funnel_r(u[:, m], u[:, m + 1], shift) for m in range(nw)]


def _store_run(mem, lo, v, nb):
    """The kernel's store_run: bytes [lo, lo + nb) of the words v, whole
    aligned words in the run as one store, the rest byte by byte (both
    written the same here; the check is which bytes)."""
    hi = lo + nb
    a0 = lo & ~3
    shift = 8 * (lo & 3)
    nw = len(v)
    zero = np.zeros(len(lo), np.uint64)
    for k in range(nw + 1):
        wa = a0 + 4 * k
        w = _funnel_l(v[k - 1] if k > 0 else zero, v[k] if k < nw else zero, shift)
        for i in range(4):
            live = (wa + i >= lo) & (wa + i < hi)
            mem.store(wa[live] + i, ((w[live] >> np.uint64(8 * i)) & np.uint64(255)).astype(np.uint8))


def _is_u8_values(palette):
    return bool(np.all((palette >= 0) & (palette <= 255) & (palette == np.trunc(palette))))


def _pick(d1, i1, d2, i2, screen):
    tot = d1 + d2
    with np.errstate(divide="ignore", invalid="ignore"):
        factor = np.where(tot == 0, np.float32(0), d1 / tot).astype(np.float32)
    return np.where(factor <= screen, i1, i2)


def ordered_model(frames, palette, screen, return_indices, in_off, out_off, seed=0):
    """K4's walk on (B, H, W, 3) u8 or float32 frames at byte offset
    ``in_off``; the output at ``out_off``. Returns (output, integer body
    taken)."""
    rng = np.random.RandomState(seed)
    b, h, w, _ = frames.shape
    p = len(palette)
    plan = tof.ordered_plan(b, h, w, p)
    pix = plan.pixels
    assert pix % 4 == 0 and plan.threads % 32 == 0 and plan.threads <= 256
    assert plan.smem_bytes == 16 * p
    bb, y, x0, n = _jobs(plan, b, w)
    px = (bb.astype(np.int64) * h + y) * w + x0
    u8 = frames.dtype == np.uint8
    src = Bytes(rng, frames.tobytes(), in_off, frames.nbytes)
    out_bytes = b * h * w * (1 if return_indices else 3)
    dst = Bytes(rng, None, out_off, out_bytes)
    sc = np.stack([screen.reshape(-1)[np.minimum(y * w + x0 + j, h * w - 1)]
                   for j in range(pix)], 1).astype(np.float32)

    integer = u8 and _is_u8_values(palette)
    nw = 3 * pix // 4  # words of a thread's u8 or colour run
    zero = np.zeros(len(px), np.uint64)
    if u8:
        q = _load_run(src, in_off + 3 * px, 3 * n, nw)
        # Pixel j: bytes 3j..3j+2, a funnel shift of words 3j/4 and 3j/4 + 1.
        xp = [_funnel_r(q[3 * j // 4], q[3 * j // 4 + 1] if 3 * j // 4 + 1 < nw else zero,
                        np.full(len(px), 8 * (3 * j % 4))) & np.uint64(0xFFFFFF)
              for j in range(pix)]
        chan = np.stack([np.stack([(x >> np.uint64(8 * c)) & np.uint64(255) for c in range(3)], 1)
                         for x in xp], 1).astype(np.int64)  # (jobs, pix, 3)
    else:
        assert in_off % 4 == 0
        pos = in_off + 12 * px[:, None, None] + 12 * np.arange(pix)[None, :, None] \
            + 4 * np.arange(3)[None, None, :]
        live = np.arange(pix)[None, :] < n[:, None]
        vals = np.zeros(pos.shape, np.float32)
        vals[live] = src.words(pos[live].ravel()).astype(np.uint32).view(np.float32).reshape(-1, 3)
        chan = vals

    if integer:
        pal_i = palette.astype(np.int64)
        packed = pal_i[:, 0] | (pal_i[:, 1] << 8) | (pal_i[:, 2] << 16)
        cp = ((pal_i ** 2).sum(1) << 12) | np.arange(p)
        m1 = np.full(chan.shape[:2], INT_MAX, np.int64)
        m2 = m1.copy()
        for k in range(p):
            dot = (chan * pal_i[k]).sum(-1)
            key = cp[k] - dot * 8192
            assert np.all(dot * 8192 < 2**31) and np.all(np.abs(key) < 2**31)
            m2 = np.minimum(m2, np.maximum(m1, key))
            m1 = np.minimum(m1, key)
        xx = (chan ** 2).sum(-1)
        one = m2 == INT_MAX
        d1 = ((m1 >> 12) + xx).astype(np.float32)
        d2 = np.where(one, np.float32(np.inf), ((m2 >> 12) + xx).astype(np.float32))
        idx = _pick(d1, m1 & 4095, d2, np.where(one, 0, m2 & 4095), sc)
        colour = packed[idx].astype(np.uint64)
    else:
        x = chan.astype(np.float32)
        pal_f = palette.astype(np.float32)
        d1 = np.full(x.shape[:2], np.inf, np.float32)
        d2 = d1.copy()
        i1 = np.zeros(x.shape[:2], np.int64)
        i2 = i1.copy()
        for k in range(p):
            dr, dg, db = (x[..., c] - pal_f[k, c] for c in range(3))
            d = (dr * dr + dg * dg) + db * db
            lt1, lt2 = d < d1, d < d2
            d2 = np.where(lt1, d1, np.where(lt2, d, d2))
            i2 = np.where(lt1, i1, np.where(lt2, k, i2))
            d1 = np.where(lt1, d, d1)
            i1 = np.where(lt1, k, i1)
        idx = _pick(d1, i1, d2, i2, sc)
        trunc = pal_f[idx].astype(np.int32).astype(np.uint8).astype(np.uint64)
        colour = trunc[..., 0] | (trunc[..., 1] << np.uint64(8)) | (trunc[..., 2] << np.uint64(16))
    assert np.all((idx >= 0) & (idx < p))

    if return_indices:
        i = (idx & 255).astype(np.uint64)
        words = [i[:, 4 * m] | (i[:, 4 * m + 1] << np.uint64(8)) | (i[:, 4 * m + 2] << np.uint64(16))
                 | (i[:, 4 * m + 3] << np.uint64(24)) for m in range(pix // 4)]
        _store_run(dst, out_off + px, words, n)
        return dst.tensor(np.uint8, (b, h, w)), integer
    # Word m holds bytes 4m..4m+3 of the colour run: pixel j's colour sits
    # 3j - 4m bytes into it.
    words = []
    for m in range(nw):
        v = zero.copy()
        for j in range(pix):
            sh = 3 * j - 4 * m
            if -3 < sh < 4:
                v |= (colour[:, j] << np.uint64(8 * sh) if sh >= 0
                      else colour[:, j] >> np.uint64(-8 * sh)) & M32
        words.append(v)
    _store_run(dst, out_off + 3 * px, words, 3 * n)
    return dst.tensor(np.uint8, (b, h, w, 3)), integer


def _hold(frames, palette, screen, in_off=0, out_off=0, indices=(False, True), integer=None):
    """The model == the plain version, colours and (P <= 256) indices."""
    for ind in indices:
        if ind and len(palette) > tof.INDEX_PALETTE_MAX:
            continue
        got, took = ordered_model(frames, palette, screen, ind, in_off, out_off)
        want = tof.ordered_dither_fused_plain(torch.from_numpy(frames), torch.from_numpy(palette),
                                              torch.from_numpy(screen), ind).numpy()
        assert got.shape == want.shape and np.array_equal(got, want), (ind, in_off, out_off)
        if integer is not None:
            assert took == integer


def _screen(rng, h, w):
    return rng.rand(h, w).astype(np.float32)


# ---------------------------------------------------------------------------
# (c) The plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(1, 1, 1), (3, 37, 53), (2, 5, 1023), (1, 3, 1024), (1, 3, 1025),
               (2, 4, 1920), (1, 2, 4097), (70000, 1, 5), (17, 9, 130)]


@pytest.mark.parametrize("b,h,w", PLAN_SHAPES)
def test_plan_covers_every_pixel_once(b, h, w):
    """Every pixel (b, y, x) lies in exactly one job, the blocks are as few
    as 256 threads allow and their threads a multiple of 32."""
    plan = tof.ordered_plan(b, h, w, 16)
    groups = -(-w // plan.pixels)
    assert plan.grid[0] == -(-groups // 256) and plan.grid[1] == h
    assert plan.grid[2] == min(-(-b // plan.frames), 65535)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.grid[0] * plan.threads >= groups > (plan.grid[0] - 1) * plan.threads
    bb, y, x0, n = _jobs(plan, b, w)
    assert np.all(n >= 1)
    first = (bb.astype(np.int64) * h + y) * w + x0
    cover = np.bincount(np.concatenate([first + j for j in range(plan.pixels)])[
        np.concatenate([j < n for j in range(plan.pixels)])], minlength=b * h * w)
    assert len(cover) == b * h * w and np.all(cover == 1)


def test_plan_at_1080p():
    plan = tof.ordered_plan(16, 1080, 1920, 16)
    f = tof.ORDERED_FRAMES
    assert plan == tof.OrderedPlan(256, 4, f, (2, 1080, -(-16 // f)), 256)
    assert tof.ordered_plan(1, 512, 512, 16) == tof.OrderedPlan(128, 4, f, (1, 512, 1), 256)
    assert tof.ordered_plan(3, 37, 53, 4096).smem_bytes == 65536


@pytest.mark.parametrize("shape", [(1, 65536, 1, 2), (1, 1, 1, 0), (1, 1, 1, 4097), (0, 1, 1, 2)])
def test_plan_refuses(shape):
    with pytest.raises(ValueError):
        tof.ordered_plan(*shape)


# ---------------------------------------------------------------------------
# (b) The model against the plain version
# ---------------------------------------------------------------------------

# (input offset, output offset) in bytes: a contiguous slice may start
# anywhere.
OFFSETS = [(0, 0), (1, 3), (13, 6), (7, 1)]


@pytest.mark.parametrize("offsets", OFFSETS, ids=lambda v: f"in{v[0]}-out{v[1]}")
@pytest.mark.parametrize("p", (1, 2, 16, 33, 256, 300))
def test_integer_body_equals_plain(p, offsets):
    rng = np.random.RandomState(p)
    frames = rng.randint(0, 256, (3, 7, 53, 3)).astype(np.uint8)
    palette = rng.randint(0, 256, (p, 3)).astype(np.float32)
    _hold(frames, palette, _screen(rng, 7, 53), *offsets, integer=True)


@pytest.mark.parametrize("ind", (False, True), ids=("colours", "indices"))
def test_integer_body_4096_colours(ind):
    """The largest palette (indices stop at 256 colours: a 256-colour
    palette there), keys at both ends of their range: black and white
    pixels against black and white colours."""
    rng = np.random.RandomState(4096)
    p = 256 if ind else 4096
    frames = rng.randint(0, 256, (2, 5, 19, 3)).astype(np.uint8)
    frames[0, 0, :4] = 255
    frames[0, 1, :4] = 0
    palette = rng.randint(0, 256, (p, 3)).astype(np.float32)
    palette[:2] = [[255, 255, 255], [0, 0, 0]]
    _hold(frames, palette, _screen(rng, 5, 19), 5, 2, (ind,), integer=True)


@pytest.mark.parametrize("level", (0.0, 0.5, 1.0))
def test_integer_body_exact_ties(level):
    """Flat frames midway between two colours (d1 == d2), on a duplicated
    colour (d1 + d2 == 0) and planted duplicates anywhere: the lowest index
    wins, against flat screens 0, 0.5 and 1."""
    b, h, w = 3, 5, 37
    screen = np.full((h, w), level, np.float32)
    for colour, rows in (((101, 100, 100), [[100, 100, 100], [102, 100, 100], [0, 0, 0]]),
                         ((40, 50, 60), [[0, 0, 0], [40, 50, 60], [40, 50, 60]]),
                         ((7, 7, 7), [[7, 7, 7]]),
                         ((10, 10, 10), [[12, 10, 10], [8, 10, 10], [10, 12, 10], [10, 8, 10]])):
        frames = np.broadcast_to(np.array(colour, np.uint8), (b, h, w, 3)).copy()
        _hold(frames, np.array(rows, np.float32), screen, 3, 1, integer=True)
    rng = np.random.RandomState(11)
    palette = rng.randint(0, 256, (40, 3)).astype(np.float32)
    palette[[5, 17, 33]] = palette[2]
    palette[[30, 39]] = palette[29]
    frames = palette[rng.randint(0, 40, (b, h, w))].astype(np.uint8)
    _hold(frames, palette, screen, 1, 7, integer=True)


@pytest.mark.parametrize("bad", ("fraction", "above", "below"))
def test_vote_sends_such_palettes_to_the_float_body(bad):
    """One non-integer or out-of-range value anywhere in the palette sends
    the block to the float body, which still equals the plain version."""
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (2, 6, 21, 3)).astype(np.uint8)
    palette = rng.randint(0, 256, (33, 3)).astype(np.float32)
    palette[31, 1] = {"fraction": 100.5, "above": 256.0, "below": -1.0}[bad]
    _hold(frames, palette, _screen(rng, 6, 21), 2, 3, integer=False)


@pytest.mark.parametrize("p", (1, 16, 300))
def test_float_frames_take_the_float_body(p):
    """float32 frames (the wavelet mode's reconstruction) never vote: the
    float body, at float32-aligned offsets, equals the plain version."""
    rng = np.random.RandomState(p + 1)
    frames = rng.uniform(-8.0, 263.0, (2, 5, 23, 3)).astype(np.float32)
    palette = rng.randint(0, 256, (p, 3)).astype(np.float32)
    _hold(frames, palette, _screen(rng, 5, 23), 4, 3, integer=False)
    _hold(frames.round(), palette, _screen(rng, 5, 23), 0, 0, integer=False)
