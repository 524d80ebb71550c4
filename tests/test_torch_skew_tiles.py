"""The tile walks of K1 (``skew.cu``) and K3 (``unskew_unpack.cu``), held
on the CPU; K7 is K1's walk with a uint8 load into a float32 stream.

Neither CUDA kernel runs here, so this file holds what they are built
from: the tile plans of ``dither_pie_tpu_torch.ops.wavefront``
(``skew_tile_plan``, ``unskew_tile_plan``) cover the (D, H) stream plane
exactly once and fit a block's shared memory, and a numpy model of each
kernel, written from the plan and step for step as the kernel walks it,
reproduces the plain versions ``skew_plain`` and ``unskew_unpack_plain``
bit for bit.

The unskew's model walks every output kind of the one tile kernel; K5's
index kinds are held in ``test_torch_unskew_idx_tiles.py``.

The models work on flat byte buffers with the tensors at chosen offsets,
so the 16-byte words that cover each run and the heads and tails of the
stores are those the card would see, and every byte outside the tensors is
random, so a byte read or written where the kernel must not shows. Each
model checks that every shared-memory and device-memory access lies in its
buffer and that every output byte is written exactly once. Everything
here is exact. The plain versions themselves are held to the JAX package
in ``test_torch_wavefront.py`` and ``test_torch_planar.py``.
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu_torch.ops import wavefront as twf
import torch_workers  # noqa: F401

SMEM_STATIC_MAX = 48 * 1024  # static shared memory a block may have
# __byte_perm selectors of K3's NHWC store, by the phase (element index mod
# 3) of a 4-byte word's first byte: bytes (r, g, b) of a pixel v are bytes
# 2, 1, 0 of v; bytes 4-7 are those of the next pixel.
NHWC_SELECTORS = (0x6012, 0x5601, 0x4560)


def _blocks(plan, b, s=None):
    """Tile origins (y0, d0) and frame of every (block, frame) pair: block
    (x, y, z) takes row tile x, step tile y (K1) or the y-th step tile of
    row tile x's band (K3: ``s`` given) and frames z, z + grid[2], ..."""
    gx, gy, gz = plan.grid
    y0, d0, frame = [], [], []
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                first = 0 if s is None else (s * x * plan.ty) // plan.td
                for f in range(z, b, gz):
                    y0.append(x * plan.ty)
                    d0.append((first + y) * plan.td)
                    frame.append(f)
    return np.array(y0), np.array(d0), np.array(frame)


def _tile_classes(ya, yb, d0, w, s, td):
    """(empty, full) of tiles over the rows [ya, yb] and steps [d0, d0 +
    TD): empty tiles lie wholly outside the image parallelogram
    0 <= d - s*y < W, full ones wholly inside."""
    empty = (d0 + td - 1 < s * ya) | (d0 >= s * yb + w)
    full = (d0 >= s * yb) & (d0 + td - 1 < s * ya + w)
    return empty, full


class Memory:
    """A flat byte buffer: random bytes with one tensor at ``offset``;
    ``writes`` counts the stores into each byte."""

    def __init__(self, rng, payload: bytes, offset: int, size: int):
        self.data = rng.randint(0, 256, offset + size + 64).astype(np.uint8)
        if payload is not None:
            self.data[offset:offset + len(payload)] = np.frombuffer(payload, np.uint8)
        self.writes = np.zeros(len(self.data), np.int64)
        self.offset, self.size = offset, size

    def words(self, addr):
        """The 16-byte words at ``addr`` (16-aligned), each inside the
        allocation that holds the tensor: a word overlapping the tensor."""
        assert np.all(addr % 16 == 0)
        assert np.all((addr + 16 > self.offset) & (addr < self.offset + self.size))
        return self.data[addr[:, None] + np.arange(16)]

    def store(self, addr, byts, lo, hi):
        """Bytes [lo, hi) of the 16-byte words ``byts`` at ``addr``."""
        sel = (np.arange(16) >= lo[:, None]) & (np.arange(16) < hi[:, None])
        where = (addr[:, None] + np.arange(16))[sel]
        assert np.all((where >= self.offset) & (where < self.offset + self.size))
        self.data[where] = byts[sel]
        np.add.at(self.writes, where, 1)

    def tensor(self, dtype, shape):
        assert np.all(self.writes[self.offset:self.offset + self.size] == 1)
        assert not self.writes[:self.offset].any() and not self.writes[self.offset + self.size:].any()
        return self.data[self.offset:self.offset + self.size].view(dtype).reshape(shape)


def _covering_words(lo, hi, k):
    """Word k of the 16-byte words that cover bytes [lo, hi), and whether it
    exists."""
    addr = (lo & ~15) + 16 * k
    return addr, (addr < hi) & (lo < hi)


def _store_words(mem, lo_run, hi_run, addr, byts):
    """A store phase's words: whole words in the run go out as one 16-byte
    store, the head and tail words of a run only their bytes in it."""
    lo = np.maximum(lo_run - addr, 0)
    hi = np.minimum(hi_run - addr, 16)
    mem.store(addr, byts, lo, hi)


def _funnel_read(smem32, blk, word_index, shift):
    """K1's read of 16 bytes at a byte offset from shared memory: five
    aligned 32-bit words u and __funnelshift_r(u[m], u[m+1], 8*shift)."""
    assert np.all((word_index >= 0) & (word_index + 5 <= smem32.shape[1]))
    u = smem32[blk[:, None], word_index[:, None] + np.arange(5)].astype(np.uint64)
    q = ((u[:, 1:] << np.uint64(32)) | u[:, :4]) >> (8 * shift[:, None]).astype(np.uint64)
    return (q & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def skew_model(frames: np.ndarray, s: int, plan, in_off: int, out_off: int, seed=0,
               out_dtype=None):
    """The walk of ``skew.cu``'s tile kernel: (B, H, W, C) uint8 or float32
    frames at byte offset ``in_off`` -> the (D, C*B, H) stream of
    ``out_dtype`` (the frames' dtype, or float32 from uint8: K7's cast)
    written at ``out_off``. C = 3 is K1; C = 1 is K6, its R planes as
    (R, H, W, 1). Shared memory holds the output type: the load widens each
    element as it de-interleaves it, every size but the load's word count
    is the output type's."""
    rng = np.random.RandomState(seed)
    b, h, w, nc = frames.shape
    out_dtype = np.dtype(frames.dtype if out_dtype is None else out_dtype)
    ei = frames.dtype.itemsize  # input element bytes
    e = out_dtype.itemsize  # output and shared-memory element bytes
    td, ty, nt, lead = plan.td, plan.ty, plan.threads, plan.lead
    assert lead == twf.skew_lead_rows(h, e, out_off % 32)
    d_total = w + s * (h - 1)
    rows = nc * td  # stream rows (dd, c) of the tile, r = C*dd + c
    slots = rows + rows // 32  # row r sits in slot r + r/32
    pitch = (ty + 32 // e) * e + 4  # bytes of a stream row in shared memory
    wpr = nc * td * ei // 16 + 1  # most covering words of a frame-row run
    nwr = ty * e // 16 + 1  # most covering words of a stream run
    smem_bytes = 16 + slots * pitch + 32
    assert smem_bytes == plan.smem_bytes <= SMEM_STATIC_MAX
    assert pitch % 8 == 4  # an odd count of 32-bit words
    src = Memory(rng, frames.tobytes(), in_off, frames.nbytes)
    dst = Memory(rng, None, out_off, d_total * nc * b * h * e)

    # Tile rows y in [y0 - lead, y0 + TY); row j at y = y0 - lead + j.
    y0, d0, bb = _blocks(plan, b)
    nb = len(y0)
    ya = np.maximum(0, y0 - lead)
    yb = np.minimum(h, y0 + ty) - 1
    assert np.all(ya <= yb)
    empty, full = _tile_classes(ya, yb, d0, w, s, td)
    smem = rng.randint(0, 256, (nb, smem_bytes)).astype(np.uint8)
    smem[~empty & ~full, 16:16 + slots * pitch] = 0  # partial tiles start zeroed
    written = np.zeros((nb, smem_bytes), np.int64)

    # Load along the frame rows, in batches of 4 items a thread: item f of
    # a block is word k of row j.
    batches = -(-(ty + 32 // e - 1) * wpr // (4 * nt))
    f = np.arange(batches * 4 * nt)
    j, k = f // wpr, f % wpr
    y = y0[:, None] - lead + j
    xlo = np.maximum(0, d0[:, None] - s * y)
    xhi = np.minimum(w, d0[:, None] + td - s * y)
    row = in_off + (bb[:, None] * h + y).astype(np.int64) * (w * nc * ei)
    addr, live = _covering_words(row + xlo * nc * ei, row + xhi * nc * ei, k)
    live &= (y >= ya[:, None]) & (y <= yb[:, None]) & ~empty[:, None]
    assert not live[:, (ty + lead) * wpr:].any()
    blk, item = np.nonzero(live)
    words = src.words(addr[blk, item])
    vals = words.view(frames.dtype)  # (n, 16 / ei)
    yb_, jb = y[blk, item], j[item]
    e0 = (addr[blk, item] - row[blk, item]) // ei  # element of the row, may be < 0
    el = e0[:, None] + np.arange(16 // ei)
    ok = (el >= nc * xlo[blk, item][:, None]) & (el < nc * xhi[blk, item][:, None])
    # Element el = C*x + c of the row is pixel x, channel c, and goes to the
    # stream row r = C*dd + c with dd = x + s*y - d0: r = el + C*(s*y - d0),
    # in slot r + r/32. The kernel takes the word's first row r0 and its
    # slot once; element i sits i slots further, one more from i = t on.
    r0 = e0 + nc * (s * yb_ - d0[blk])
    t = 32 - (r0 & 31)
    i = np.arange(16 // ei)
    at = (16 + (r0 + (r0 >> 5)) * pitch + jb * e)[:, None] + (i + (i >= t[:, None])) * pitch
    r = r0[:, None] + i
    assert np.array_equal(at, 16 + (r + (r >> 5)) * pitch + jb[:, None] * e)
    at, vb = at[ok], vals[ok].astype(out_dtype)  # the cast: exact
    blk_el = np.broadcast_to(blk[:, None], ok.shape)[ok]
    assert np.all((r[ok] >= 0) & (r[ok] < rows))
    for byte in range(e):
        smem[blk_el, at + byte] = vb.view(np.uint8).reshape(-1, e)[:, byte]
        np.add.at(written, (blk_el, at + byte), 1)
    assert written.max() <= 1

    # Store along y: item f of a block is word k of stream row R = d*C*B +
    # c*B + b (r = C*dd + c of the tile), over its window y in [y0 - ph,
    # y0 - ph + TY), ph = the sector phase of R's start in elements.
    f = np.arange(-(-rows * nwr // nt) * nt)
    r, k = f // nwr, f % nwr
    dd, c = r // nc, r % nc
    d = d0[:, None] + dd
    rs = out_off + (d.astype(np.int64) * nc * b + c * b + bb[:, None]) * h * e
    ph = (rs % 32) // e
    assert np.all(ph <= lead)
    ys = np.maximum(0, y0[:, None] - ph)
    ye = np.minimum(h, y0[:, None] - ph + ty)
    addr, live = _covering_words(rs + ys * e, rs + ye * e, k)
    live &= (r < rows) & (d < d_total)
    blk, item = np.nonzero(live)
    gs, ge = rs[blk, item] + ys[blk, item] * e, rs[blk, item] + ye[blk, item] * e
    whole = ys[blk, item] == y0[blk] - ph[blk, item]  # a window not cut at y = 0
    assert np.all(gs[whole] % 32 == 0)
    o = (ys[blk, item] - y0[blk] + lead) * e + addr[blk, item] - gs  # byte of the shared row
    word = (16 + (r[item] + (r[item] >> 5)) * pitch) // 4 + (o >> 2)
    q = _funnel_read(smem.view(np.uint32), blk, word, o & 3)
    q[empty[blk]] = 0  # empty tiles store zeros without loading
    _store_words(dst, gs, ge, addr[blk, item], q.view(np.uint8).reshape(-1, 16))
    return dst.tensor(out_dtype, (d_total, nc * b, h))


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte n of the result is byte (sel >> 4n) & 7 of
    the 8 bytes (y:x)."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint64)
    for n in range(4):
        pick = ((sel >> (4 * n)) & 7).astype(np.uint64)
        out |= ((both >> (8 * pick)) & np.uint64(255)) << np.uint64(8 * n)
    return out.astype(np.uint32)


# Of each output kind of the unskew tile kernel: bytes a pixel of an output
# row, output rows a tile row (planar: one in each plane), and the output's
# dtype and shape.
UNSKEW_U = {"nhwc": 3, "planar": 1, "u8": 1, "u16": 2, "select": 3}
UNSKEW_PLANES = {"nhwc": 1, "planar": 3, "u8": 1, "u16": 1, "select": 1}


def unskew_out(kind, b, h, w):
    """(dtype, shape) of the unskew's output of ``kind``."""
    return {"nhwc": (np.uint8, (b, h, w, 3)), "planar": (np.uint8, (3, b, h, w)),
            "u8": (np.uint8, (b, h, w)), "u16": (np.uint16, (b, h, w)),
            "select": (np.uint8, (b, h, w, 3))}[kind]


def packed_palette(palette: np.ndarray) -> np.ndarray:
    """K9's packing kernel: (P, 3) float32 -> (P,) uint32
    (u8)(int)r << 16 | (u8)(int)g << 8 | (u8)(int)b, the float32 -> int32
    cast truncating and the int32 -> uint8 one keeping the low byte."""
    c = palette.astype(np.int32).astype(np.uint8).astype(np.uint32)
    return (c[:, 0] << np.uint32(16)) | (c[:, 1] << np.uint32(8)) | c[:, 2]


def unskew_model(col: np.ndarray, s: int, h: int, w: int, plan, kind: str,
                 in_off: int, out_off: int, seed=0, palette=None):
    """The walk of ``unskew_unpack.cu``'s tile kernel: the (D', B, H) int32
    stream at byte offset ``in_off`` -> at ``out_off``, by output ``kind``:
    K3's (B, H, W, 3) uint8 ("nhwc") or (3, B, H, W) ("planar"), K5's
    (B, H, W) uint8 ("u8") or uint16 ("u16") index stream, K9's (B, H, W, 3)
    uint8 colours of the indices in the (P, 3) float32 ``palette``
    ("select": each loaded index is looked up in the packed palette as it
    goes into the tile, then the store is NHWC's)."""
    rng = np.random.RandomState(seed)
    _, b, _ = col.shape
    td, ty, nt, lead = plan.td, plan.ty, plan.threads, plan.lead
    u = UNSKEW_U[kind]  # bytes a pixel of an output row
    assert lead == -(-31 // u)
    cols = lead + td  # tile row j holds steps d0 - lead .. d0 + td - 1
    pitch = (cols + cols // 32) | 1  # int32 words: a spare after every 32, odd
    assert plan.smem_bytes == 4 * ty * pitch + 4 * cols <= SMEM_STATIC_MAX
    src = Memory(rng, col.astype(np.int32).tobytes(), in_off, col.nbytes)
    dst = Memory(rng, None, out_off, UNSKEW_PLANES[kind] * b * h * w * u)

    y0, d0, bb = _blocks(plan, b, s)
    ny = np.minimum(ty, h - y0)
    keep = d0 - lead < s * (y0 + ny - 1) + w  # past the band: the block returns
    y0, d0, bb, ny = y0[keep], d0[keep], bb[keep], ny[keep]
    nb = len(y0)
    tile = rng.randint(-2**31, 2**31, (nb, ty * pitch), dtype=np.int64).astype(np.int32)
    written = np.zeros(tile.shape, np.int64)

    # Load along y: item f of a block is word k of column i's run (step
    # d = d0 - lead + i), restricted to the rows j whose pixel
    # x = d - s*(y0 + j) lies in [0, W).
    nwr = ty * 4 // 16 + 1
    f = np.arange(-(-cols * nwr // nt) * nt)
    i, k = f // nwr, f % nwr
    d = d0[:, None] - lead + i
    t = d - s * y0[:, None]
    jlo = np.maximum(0, (t - w) // s + 1)  # numpy's // floors
    jhi = np.minimum(ny[:, None] - 1, t // s)
    run = in_off + ((d.astype(np.int64) * b + bb[:, None]) * h + y0[:, None]) * 4
    addr, live = _covering_words(run + 4 * jlo, run + 4 * (jhi + 1), k)
    live &= (i < cols) & (jlo <= jhi)
    blk, item = np.nonzero(live)
    vals = src.words(addr[blk, item]).view(np.int32)  # (n, 4)
    jj = (addr[blk, item] - run[blk, item])[:, None] // 4 + np.arange(4)
    ok = (jj >= jlo[blk, item][:, None]) & (jj <= jhi[blk, item][:, None])
    ib = np.broadcast_to(i[item][:, None], ok.shape)
    at = (jj * pitch + ib + ib // 32)[ok]
    blk_el = np.broadcast_to(blk[:, None], ok.shape)[ok]
    assert np.all((at >= 0) & (at < ty * pitch))
    put = vals[ok]
    if kind == "select":
        # One lookup a pixel, of indices inside the image only: the
        # palette's rows, every one of them.
        assert np.all((put >= 0) & (put < len(palette)))
        put = packed_palette(palette)[put].view(np.int32)
    tile[blk_el, at] = put
    np.add.at(written, (blk_el, at), 1)
    assert written.max() <= 1

    def pixel(blk, j, i):
        """The tile's packed colours of columns i (clamped into the tile:
        the head and tail words read pixels they do not store) in rows j."""
        i = np.clip(i, 0, cols - 1)
        return tile[blk[:, None], j[:, None] * pitch + i + i // 32].astype(np.uint32)

    # Store along x: of output row (b, y) of plane c (0 but for planar), the
    # window of u*TD bytes from the sector boundary at or before pixel
    # x0 = d0 - s*y.
    lanes = UNSKEW_PLANES[kind]  # planar: three runs a row, one a plane
    per_run = u * td // 16 + 1
    f = np.arange(-(-lanes * ty * per_run // nt) * nt)
    rr, k = f // per_run, f % per_run
    c, j = rr // ty, rr % ty
    y = y0[:, None] + j
    row = (c * b + bb[:, None]) * h + y
    rs = out_off + row.astype(np.int64) * w * u
    win = (rs + u * (d0[:, None] - s * y)) & ~31
    gs = np.maximum(win, rs)
    ge = np.minimum(win + u * td, rs + u * w)
    addr, live = _covering_words(gs, ge, k)
    live &= (rr < lanes * ty) & (j < ny[:, None])
    blk, item = np.nonzero(live)
    assert np.all(gs[blk, item][gs[blk, item] > rs[blk, item]] % 32 == 0)
    e0 = addr[blk, item] - rs[blk, item]  # byte of the row: >= -15
    off = s * y[blk, item] - d0[blk] + lead  # column of pixel x = 0
    jb = j[item]
    if kind in ("planar", "u8"):
        # Byte 2 - c of 16 packed colours (planar) or the low byte of 16
        # indices (u8, the selector of c = 2): two pixels a __byte_perm,
        # then two pairs.
        v = pixel(blk, jb, e0[:, None] + np.arange(16) + off[:, None])
        cb = 2 - c[item] if kind == "planar" else np.zeros(len(blk), np.int64)
        pair = cb | ((cb + 4) << 4)
        q = np.zeros((len(blk), 4), np.uint32)
        for m in range(4):
            lo2 = _byte_perm(v[:, 4 * m], v[:, 4 * m + 1], pair)
            hi2 = _byte_perm(v[:, 4 * m + 2], v[:, 4 * m + 3], pair)
            q[:, m] = _byte_perm(lo2, hi2, np.full(len(blk), 0x5410))
    elif kind == "u16":
        # The low halves of 8 indices, two a __byte_perm; the row starts on
        # a 2-byte boundary, so the word's first byte is a pixel's first.
        assert np.all(e0 % 2 == 0)
        v = pixel(blk, jb, (e0 // 2 + off)[:, None] + np.arange(8))
        q = np.zeros((len(blk), 4), np.uint32)
        for m in range(4):
            q[:, m] = _byte_perm(v[:, 2 * m], v[:, 2 * m + 1], np.full(len(blk), 0x5410))
    else:
        # The six pixels that hold the word's 16 bytes; word m starts at
        # channel (ph0 + 4m) % 3 of pixel (ph0 + 4m) // 3 of them.
        px0 = e0 // 3
        ph0 = e0 - 3 * px0
        v = pixel(blk, jb, (px0 + off)[:, None] + np.arange(6))
        q = np.zeros((len(blk), 4), np.uint32)
        rows = np.arange(len(blk))
        for m in range(4):
            first = (ph0 + 4 * m) // 3
            q[:, m] = _byte_perm(v[rows, first], v[rows, first + 1],
                                 np.array(NHWC_SELECTORS)[(ph0 + 4 * m) % 3])
    _store_words(dst, gs[blk, item], ge[blk, item], addr[blk, item],
                 q.view(np.uint8).reshape(-1, 16))
    return dst.tensor(*unskew_out(kind, b, h, w))


# ---------------------------------------------------------------------------
# (a) The plans
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(16, 1080, 1920, 2), (16, 1080, 1920, 3), (16, 480, 854, 2),
               (3, 37, 53, 2), (1, 1, 1, 2), (17, 65, 5, 3), (2, 6, 1, 3),
               (1, 2000, 3, 2), (70000, 2, 2, 2)]


def _plans(b, h, w, s):
    for phase in (0, 8, 13):
        yield f"skew u8 phase {phase}", twf.skew_tile_plan(b, h, w, s, torch.uint8, phase)
    for phase in (0, 4, 12):
        yield f"skew f32 phase {phase}", twf.skew_tile_plan(b, h, w, s, torch.float32, phase)
    for kind in ("nhwc", "planar", "select"):
        yield f"unskew {kind}", twf.unskew_tile_plan(b, h, w, s, kind)


@pytest.mark.parametrize("b,h,w,s", PLAN_SHAPES)
def test_tile_plans_cover_the_plane_once(b, h, w, s):
    """K1: every step d lies in one step tile and, of every stream row, the
    row tiles' windows y in [k*TY - ph, (k+1)*TY - ph) (ph the row's sector
    phase, never above ``lead``) hold every y once, each inside the rows
    its block loads. K3: every pixel's (d, y) lies in exactly one launched
    block that does not return at once, and the blocks' frame walks z, z +
    grid[2], ... take every frame once."""
    d_total = twf.stream_length(h, w, s)
    for what, plan in _plans(b, h, w, s):
        gx, gy, gz = plan.grid
        assert gy <= 65535 and gz <= 65535, what
        assert plan.threads == 256 and plan.smem_bytes <= SMEM_STATIC_MAX, what
        if what.startswith("skew"):
            assert gz == min(b, 65535), what
            assert gy * plan.td >= d_total > (gy - 1) * plan.td, what
            assert gx * plan.ty >= h + plan.lead > (gx - 1) * plan.ty, what
            for ph in range(plan.lead + 1):
                cover = np.zeros(h, np.int64)
                for k in range(gx):
                    lo, hi = max(0, k * plan.ty - ph), min(h, (k + 1) * plan.ty - ph)
                    cover[lo:max(lo, hi)] += 1
                    assert lo >= k * plan.ty - plan.lead, what
                assert np.all(cover == 1), what
            continue
        check_unskew_cover(plan, b, h, w, s, 1 if "planar" in what else 3, what)


def check_unskew_cover(plan, b, h, w, s, u, what, phases=(0, 8, 31)):
    """The unskew's plan (``u`` bytes a pixel of an output row) takes every
    frame once, and of every output row starting at each of ``phases``
    (mod 32) the launched blocks' windows hold each byte once, each inside
    the steps its block loads."""
    gx, gy, gz = plan.grid
    assert gz == min(-(-b // 2), 65535), what
    assert gx * plan.ty >= h > (gx - 1) * plan.ty, what
    frames = np.concatenate([np.arange(z, min(b, 1000), gz) for z in range(gz)])
    assert np.array_equal(np.sort(frames), np.arange(min(b, 1000))), what
    for y in range(h):
        x = y // plan.ty
        y_last = min(h, (x + 1) * plan.ty) - 1
        for phase in phases:  # the row's start, mod 32
            cover = np.zeros(u * w, np.int64)
            for t_ in range(gy):
                d0 = ((s * x * plan.ty) // plan.td + t_) * plan.td
                if d0 - plan.lead >= s * y_last + w:
                    continue  # the block returns at once
                win = ((phase + u * (d0 - s * y)) & ~31) - phase
                lo, hi = max(win, 0), min(win + u * plan.td, u * w)
                if lo < hi:
                    cover[lo:hi] += 1
                    assert lo // u >= d0 - plan.lead - s * y, what
                    assert (hi - 1) // u < d0 + plan.td - s * y, what
            assert np.all(cover == 1), (what, y, phase)


@pytest.mark.parametrize("h,itemsize", [(1080, 1), (1080, 4), (1088, 1), (37, 1), (37, 4),
                                        (6, 4), (1, 1)])
def test_lead_rows_are_the_largest_phase(h, itemsize):
    """``skew_lead_rows`` is the largest sector phase of a stream row's
    start, counted over the rows themselves."""
    for phase in range(0, 32, itemsize):
        starts = (phase + np.arange(256) * h * itemsize) % 32
        assert twf.skew_lead_rows(h, itemsize, phase) == starts.max() // itemsize


def test_tile_plans_at_1080p():
    """The plans at the main path's shape: tile counts, lead rows and
    shared memory."""
    b, h, w, s = 16, 1080, 1920, 2
    u8 = twf.skew_tile_plan(b, h, w, s, torch.uint8)
    assert (u8.td, u8.ty, u8.lead, u8.grid, u8.smem_bytes) == (64, 128, 24, (9, 64, 16), 32520)
    f32 = twf.skew_tile_plan(b, h, w, s, torch.float32)
    assert (f32.td, f32.ty, f32.lead, f32.grid, f32.smem_bytes) == (64, 32, 0, (34, 64, 16),
                                                                      32520)
    k3 = twf.unskew_tile_plan(b, h, w, s, "nhwc")
    assert (k3.td, k3.ty, k3.lead, k3.grid, k3.smem_bytes) == (128, 32, 11, (34, 17, 8), 18860)
    k3p = twf.unskew_tile_plan(b, h, w, s, "planar")
    assert (k3p.td, k3p.ty, k3p.lead, k3p.grid, k3p.smem_bytes) == (128, 32, 31, (34, 17, 8), 21500)
    assert twf.unskew_tile_plan(b, h, w, s, "select") == k3  # K9 plans as K3 NHWC


def test_tile_classes_match_the_parallelogram():
    """The kernels' empty and full tests agree with the tile's cells."""
    for h, w, s in ((1080, 1920, 2), (65, 5, 3), (33, 64, 2), (7, 1, 2)):
        d_total = twf.stream_length(h, w, s)
        for td, ty in ((64, 128), (64, 32), (128, 32), (8, 4)):
            ya, d0 = np.meshgrid(np.arange(0, h, ty), np.arange(0, d_total, td))
            ya, d0 = ya.ravel(), d0.ravel()
            yb = np.minimum(h, ya + ty) - 1
            empty, full = _tile_classes(ya, yb, d0, w, s, td)
            for i in range(len(ya)):
                yy = np.arange(ya[i], yb[i] + 1)[:, None]
                dd = np.arange(d0[i], d0[i] + td)[None, :]
                inside = (dd - s * yy >= 0) & (dd - s * yy < w)
                assert empty[i] == (not inside.any())
                assert full[i] == inside.all()


def test_plans_refuse_what_no_grid_holds():
    with pytest.raises(ValueError):
        twf.skew_tile_plan(1, 2, 64 * 65536, 2, torch.uint8)
    with pytest.raises(KeyError):
        twf.skew_tile_plan(1, 2, 2, 2, torch.int32)


# ---------------------------------------------------------------------------
# (b) The models against the plain versions
# ---------------------------------------------------------------------------

HS = (1, 7, 8, 33, 64, 65)
WS = (1, 2, 3, 5, 21, 64, 65)
# (B, base offset of the input, of the output): offsets off the 16-byte
# boundary stand for a contiguous slice such as batch[1:].
LAYOUTS = [(3, 0, 0), (1, 5, 13), (17, 13, 8)]


def _frames(b, h, w, seed, dtype):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    return rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32)


def _hold_skew(b, h, w, s, dtype, in_off, out_off, out_dtype=None):
    """The model == ``skew_plain`` bitwise; with ``out_dtype`` float32 from
    uint8 frames (K7's cast form, the float32 plan), == ``skew_transpose_plain``
    cast to float32."""
    frames = _frames(b, h, w, 7 * h + w, dtype)
    x = torch.from_numpy(frames)
    if out_dtype is None:
        plan = twf.skew_tile_plan(b, h, w, s, x.dtype, out_off % 32)
        want = twf.skew_plain(x, s).numpy()
    else:
        plan = twf.skew_tile_plan(b, h, w, s, torch.float32, out_off % 32)
        want = twf.skew_transpose_plain(x, s, torch.float32).numpy()
    got = skew_model(frames, s, plan, in_off, out_off, out_dtype=out_dtype)
    assert got.dtype == want.dtype
    assert got.shape == want.shape and np.array_equal(got.view(np.uint8), want.view(np.uint8))


# The values of the stream by output kind: packed colours, or indices of a
# palette the stream's type holds.
UNSKEW_VALUES = {"nhwc": 1 << 24, "planar": 1 << 24, "u8": 256, "u16": 1 << 16}


def hold_unskew(b, h, w, s, kind, in_off, out_off, extra_steps=0, palette=None):
    """The model of the unskew's walk of ``kind`` == its plain version
    (K3's ``unskew_unpack_plain``, K5's ``unskew_idx_plain``, K9's
    ``unskew_select_plain`` over ``palette``), bitwise. K9's stream holds
    indices of the palette inside the image and -1 outside, which the
    model refuses to look up."""
    rng = np.random.RandomState(11 * h + w)
    d_total = twf.stream_length(h, w, s) + extra_steps
    top = UNSKEW_VALUES[kind] if palette is None else len(palette)
    col = rng.randint(0, top, (d_total, b, h)).astype(np.int32)
    if kind == "select":
        x = np.arange(d_total)[:, None, None] - s * np.arange(h)[None, None, :]
        col = np.where((x >= 0) & (x < w), col, -1).astype(np.int32)
    plan = twf.unskew_tile_plan(b, h, w, s, kind)
    got = unskew_model(col, s, h, w, plan, kind, in_off, out_off, palette=palette)
    col_t = torch.from_numpy(col)
    if kind in ("nhwc", "planar"):
        want = twf.unskew_unpack_plain(col_t, s, h, w, kind == "planar").numpy()
    elif kind == "select":
        want = twf.unskew_select_plain(col_t, torch.from_numpy(palette), s, h, w).numpy()
    else:
        dtype = torch.uint8 if kind == "u8" else torch.uint16
        want = twf.unskew_idx_plain(col_t, s, h, w, dtype).view(
            torch.uint8 if kind == "u8" else torch.int16).numpy().view(got.dtype)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"b{v[0]}-in{v[1]}-out{v[2]}")
@pytest.mark.parametrize("s", (2, 3))
@pytest.mark.parametrize("h", HS)
def test_skew_model_u8_equals_plain(h, s, layout):
    b, in_off, out_off = layout
    for w in WS:
        _hold_skew(b, h, w, s, np.uint8, in_off, out_off)


@pytest.mark.parametrize("s", (2, 3))
@pytest.mark.parametrize("h", HS)
def test_skew_model_f32_equals_plain(h, s):
    for (b, in_off, out_off), w in zip(LAYOUTS * 3, WS):
        _hold_skew(b, h, w, s, np.float32, in_off - in_off % 4, out_off - out_off % 4)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"b{v[0]}-in{v[1]}-out{v[2]}")
@pytest.mark.parametrize("s", (2, 3))
@pytest.mark.parametrize("h", HS)
def test_skew_model_u8_to_f32_equals_plain(h, s, layout):
    """K7's cast form (uint8 frames at any offset, a float32 stream on a
    4-byte boundary): the walk of the float32 plan with a uint8 load."""
    b, in_off, out_off = layout
    for w in WS:
        _hold_skew(b, h, w, s, np.uint8, in_off, out_off - out_off % 4, np.float32)


@pytest.mark.parametrize("planar", (False, True), ids=("nhwc", "planar"))
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"b{v[0]}-in{v[1]}-out{v[2]}")
@pytest.mark.parametrize("s", (2, 3))
@pytest.mark.parametrize("h", HS)
def test_unskew_model_equals_plain(h, s, layout, planar):
    b, in_off, out_off = layout
    for w in WS:
        hold_unskew(b, h, w, s, "planar" if planar else "nhwc", in_off - in_off % 4, out_off)


@pytest.mark.parametrize("case", [
    (2, 300, 70, 2, np.uint8), (2, 300, 70, 3, np.float32), (1, 129, 200, 2, np.uint8),
    (2, 97, 130, 3, np.float32)], ids=lambda v: f"{v[0]}x{v[1]}x{v[2]}-s{v[3]}")
def test_skew_model_across_row_tiles(case):
    """Frames taller than one tile: tiles full, partial and empty, and the
    last row tile cut short."""
    b, h, w, s, dtype = case
    _hold_skew(b, h, w, s, dtype, 3 if dtype == np.uint8 else 4, 0)


@pytest.mark.parametrize("case", [(2, 300, 70, 2), (1, 97, 130, 3)],
                         ids=lambda v: f"{v[0]}x{v[1]}x{v[2]}-s{v[3]}")
def test_skew_model_u8_to_f32_across_row_tiles(case):
    """K7's cast form over several row and step tiles."""
    b, h, w, s = case
    _hold_skew(b, h, w, s, np.uint8, 5, 4, np.float32)


@pytest.mark.parametrize("planar", (False, True), ids=("nhwc", "planar"))
def test_unskew_model_across_tiles_and_longer_streams(planar):
    """Several row and step tiles, and a stream longer than D (K3 takes
    col.size(0) >= D)."""
    kind = "planar" if planar else "nhwc"
    hold_unskew(2, 97, 300, 2, kind, 4, 7, extra_steps=5)
    hold_unskew(3, 70, 130, 3, kind, 0, 0)
