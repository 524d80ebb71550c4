"""T3's plan (``tools.layout_repro.identity_plan``) and the two walks of
``identity.cu``, held on the CPU.

The CUDA kernel does not run here, so this file holds what it is built
from. The plan cuts n bytes into a head of up to 15 bytes (until the output
is 16-byte aligned), a body of whole 16-byte words, and a tail of up to 15
bytes: every byte lies in exactly one piece. Where input and output agree
mod 16 the body goes through the stride form, a grid-stride loop of 16-byte
words (at most one block a 256 words); where they disagree, through the
shifted form, whose contiguous spans the blocks take in turn (block b spans
b, b + G, ...; 16 KB spans by default). Numpy models of the kernel's two
forms (the grid-stride walk of 16-byte words, the shifted form's funnel
shifts) copy a tensor placed at every pair of offsets mod 16 in a flat byte
buffer with random bytes around it, read only 16-byte words that hold bytes
of the input, write every output byte exactly once and nothing else, and
equal ``identity_plain`` (``clone()``) bit for bit.
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu_torch.tools import layout_repro as lr
from test_torch_skew_tiles import Memory
import torch_workers  # noqa: F401

SIZES = (0, 1, 15, 16, 17, 31, 32, 33, 4095, 65537, 1_000_003, 4 * 2 ** 20 + 7)
OFFSETS = [(a, b) for a in range(16) for b in range(16)]


def _pieces(plan, n):
    """The plan's byte ranges [lo, hi) as two arrays of bounds: head, the
    body (the shifted form's spans in order), tail."""
    if plan.form == "stride" or not plan.body:
        count, step = int(plan.body > 0), plan.body
    else:
        count, step = -(-plan.body // plan.span), plan.span
    lo = plan.head + step * np.arange(count, dtype=np.int64)
    hi = np.minimum(lo + step, plan.head + plan.body)
    return (np.concatenate([[0], lo, [plan.head + plan.body]]),
            np.concatenate([[plan.head], hi, [n]]))


def _block_spans(plan, n, b):
    """The bounds of the spans block b of the shifted form takes, in its
    order: b, b + blocks, ..."""
    lo, hi = _pieces(plan, n)
    return lo[1:-1][b::plan.blocks], hi[1:-1][b::plan.blocks]


@pytest.mark.parametrize("span", (None, 16, 4096, 65_536), ids=lambda v: f"span{v}")
@pytest.mark.parametrize("blocks", (1, 7, 264, 528))
@pytest.mark.parametrize("n", SIZES)
def test_plan_puts_every_byte_in_one_piece(n, blocks, span):
    """For every pair of offsets mod 16: head, body and tail tile [0, n) in
    order; the head brings the output to a 16-byte boundary, head and tail
    are under 16 bytes, the body is whole 16-byte words and the grid is at
    most what was asked for. The form is stride exactly where the offsets
    agree: no spans, at most one block a 256 words. Where they disagree the
    shifted form's spans are whole words, every block has one at least, and
    the blocks' turns take each span once."""
    for in16, out16 in OFFSETS:
        plan = (lr.identity_plan(n, in16, out16, blocks) if span is None else
                lr.identity_plan(n, in16, out16, blocks, span=span))
        assert plan.form == ("shifted" if in16 != out16 else "stride")
        assert plan.threads == lr.IDENTITY_THREADS == 256
        lo, hi = _pieces(plan, n)
        assert lo[0] == 0 and hi[-1] == n
        assert np.array_equal(hi[:-1], lo[1:]) and np.all(lo <= hi)
        assert plan.head < 16 and n - plan.head - plan.body < 16
        assert (out16 + plan.head) % 16 == 0 or plan.head == n
        assert plan.body % 16 == 0 and plan.span % 16 == 0
        assert 1 <= plan.blocks <= blocks
        if not plan.body:
            assert (plan.span, plan.blocks) == (0, 1)
            continue
        assert np.all((out16 + lo[1:-1]) % 16 == 0)
        if plan.form == "stride":
            # Both pointers on the boundary; no block without a first word.
            assert plan.span == 0 and (in16 + plan.head) % 16 == 0
            assert plan.blocks == min(blocks, -(-plan.body // 16 // 256))
            continue
        assert plan.span == (lr.IDENTITY_SPAN if span is None else span)
        size = hi[1:-1] - lo[1:-1]  # the spans' lengths
        assert plan.blocks <= size.size  # no block without work
        # The kernel's count of each block b's turns (struct Spans) is
        # len(spans[b::blocks]).
        b = np.arange(plan.blocks)
        assert np.array_equal((size.size - 1 - b) // plan.blocks + 1,
                              np.bincount(np.arange(size.size) % plan.blocks))
        assert np.all(size > 0)
        assert np.all(size[:-1] == plan.span)


@pytest.mark.parametrize("n", (16, 17, 33, 4095, 65537))
def test_plan_of_one_word_spans(n):
    """Shifted spans of one 16-byte word: as many blocks as words at most;
    the stride form takes at most one block a 256 words whatever the span."""
    for in16, out16 in OFFSETS:
        plan = lr.identity_plan(n, in16, out16, 7, span=16)
        lo, hi = _pieces(plan, n)
        assert np.array_equal(hi[:-1], lo[1:])
        words = plan.body // 16
        want = min(7, words if plan.form == "shifted" else -(-words // 256))
        assert plan.blocks == want or not plan.body


def test_plan_forms_and_refusals():
    """The offsets pick the form; the path's own plan of one 100 x 1080p
    plane on 132 SMs; what no plan takes."""
    plan = lr.identity_plan(1 << 20, 3, 5, 264)
    assert (plan.form, plan.threads, plan.span, plan.blocks) == ("shifted", 256, 16384, 64)
    stride = lr.identity_plan(1 << 20, 3, 3, 264, 32768)
    assert (stride.form, stride.threads, stride.head, stride.span) == ("stride", 256, 13, 0)
    assert stride.body == ((1 << 20) - 13) // 16 * 16 and stride.blocks == 256
    sms = 132
    assert lr.IDENTITY_BLOCKS_PER_SM["stride"] == lr.ALL_STEPS
    full = lr.identity_plan(622_080_000, 0, 0, (1 << 31) - 1)  # a block a step
    assert (full.form, full.head, full.body, full.blocks, full.span) == (
        "stride", 0, 622_080_000, 622_080_000 // 16 // 256, 0)
    looping = lr.identity_plan(622_080_000, 0, 0, 64 * sms)
    assert (looping.blocks, looping.span) == (64 * sms, 0)
    off = lr.identity_plan(622_079_999, 1, 0, lr.IDENTITY_BLOCKS_PER_SM["shifted"] * sms)
    assert (off.form, off.head, off.body, off.blocks, off.span) == (
        "shifted", 0, 622_079_984, 4 * sms, lr.IDENTITY_SPAN)
    for bad in (dict(span=24), dict(span=0), dict(span=8), dict(blocks=0)):
        with pytest.raises(ValueError):
            lr.identity_plan(1 << 20, 0, 0, **{"blocks": 264, **bad})
    for args in ((10, 16, 0, 1), (10, 0, -1, 1), (-1, 0, 0, 1)):
        with pytest.raises(ValueError):
            lr.identity_plan(*args)


def _copy_bytes(src, dst, lo, hi):
    """Bytes [lo, hi) one by one (the head and the tail)."""
    at = np.arange(lo, hi)
    assert np.all((at >= 0) & (at < src.size))
    dst.data[dst.offset + at] = src.data[src.offset + at]
    np.add.at(dst.writes, dst.offset + at, 1)


def _words_at(mem, first, count):
    """``count`` 16-byte words from the aligned address ``first``."""
    return mem.words(first + 16 * np.arange(count))


def _stride_walk(src, dst, plan):
    """The stride form: thread t of block b copies body words b*256 + t,
    then that plus the grid's 256*blocks threads, and so on, one aligned
    16-byte load and store each; the words of each step of the grid are
    replayed together."""
    words = plan.body // 16
    threads = plan.threads * plan.blocks
    a_in, a_out = src.offset + plan.head, dst.offset + plan.head
    assert a_in % 16 == 0 and a_out % 16 == 0
    seen = np.zeros(words, np.int64)
    for step in range(-(-words // threads)):
        for b in range(plan.blocks):
            i = step * threads + b * plan.threads + np.arange(plan.threads)
            i = i[i < words]
            if not i.size:
                continue
            np.add.at(seen, i, 1)
            dst.store(a_out + 16 * i, _words_at(src, a_in + 16 * i[0], len(i)),
                      np.zeros(len(i), np.int64), np.full(len(i), 16))
    assert np.all(seen == 1)  # every word by one thread, once


def _shifted_block(src, dst, plan, spans):
    """The shifted form: output word w of a span is built from the aligned
    input words w and w + 1 around its bytes (r bytes in, r the same for
    the whole copy) by four funnel shifts of 32-bit words."""
    for lo, hi in zip(*spans):
        first = src.offset + lo
        r = first % 16
        assert r != 0 and (dst.offset + lo) % 16 == 0
        n_words = (hi - lo) // 16
        a = _words_at(src, first - r, n_words).view(np.uint32)
        b = _words_at(src, first - r + 16, n_words).view(np.uint32)
        u = np.concatenate([a, b], axis=1).astype(np.uint64)  # (words, 8)
        w4, sh = r // 4, 8 * (r % 4)
        q = np.stack([((u[:, w4 + m + 1] << np.uint64(32) | u[:, w4 + m]) >> np.uint64(sh))
                      & np.uint64(0xFFFFFFFF) for m in range(4)], axis=1).astype(np.uint32)
        addr = dst.offset + lo + 16 * np.arange(n_words)
        dst.store(addr, q.view(np.uint8).reshape(-1, 16), np.zeros(n_words, np.int64),
                  np.full(n_words, 16))


def identity_model(x: np.ndarray, in_off: int, out_off: int, plan, seed=0):
    """The kernel's copy of the uint8 bytes ``x`` placed ``in_off`` bytes into
    a buffer to ``out_off`` bytes into another, as ``plan`` cuts it."""
    rng = np.random.RandomState(seed)
    n = x.size
    src = Memory(rng, x.tobytes(), in_off, n)
    dst = Memory(rng, None, out_off, n)
    _copy_bytes(src, dst, 0, plan.head)
    _copy_bytes(src, dst, plan.head + plan.body, n)
    if plan.form == "stride":
        if plan.body:
            _stride_walk(src, dst, plan)
    else:
        for b in range(plan.blocks if plan.body else 0):
            _shifted_block(src, dst, plan, _block_spans(plan, n, b))
    return dst.tensor(np.uint8, x.shape)


def _hold(n, in_off, out_off, blocks, span=64, seed=0):
    x = np.random.RandomState(n + 17 * in_off + out_off).randint(0, 256, n).astype(np.uint8)
    plan = lr.identity_plan(n, in_off % 16, out_off % 16, blocks, span)
    got = identity_model(x, in_off, out_off, plan, seed)
    want = lr.identity_plain(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("grid", (1, 2, 3), ids=lambda v: f"grid{v}")
@pytest.mark.parametrize("in_off", range(16))
def test_model_copy_equals_clone(in_off, grid):
    """Every pair of offsets mod 16 (each output offset against this input
    offset), at sizes around the word and around a step of a small grid
    (1 to 3 blocks: each thread takes many words in turn), and short
    shifted spans that each block takes many of."""
    for out_off in range(16):
        for n in (0, 1, 15, 16, 17, 47, 1000, 4099):
            _hold(n, in_off + 32, out_off + 48, grid)
        _hold(20_011, in_off, out_off, grid + 2)
        _hold(9_001, in_off, out_off, grid + 1, 160)


@pytest.mark.parametrize("offsets", [(0, 0), (5, 5), (3, 11), (15, 0)],
                         ids=lambda v: f"in{v[0]}-out{v[1]}")
def test_model_copy_of_megabytes_equals_clone(offsets):
    """A few MB with the path's own plan (a block a step in the stride
    form, 4 an SM of 132 and 16 KB spans in the shifted form), and with a
    grid of a few blocks (spans of a few KB) that each take many steps."""
    in_off, out_off = offsets
    form = lr.identity_form(in_off % 16, out_off % 16)
    per_sm = lr.IDENTITY_BLOCKS_PER_SM[form]
    _hold(3 * 2 ** 20 + 5, in_off, out_off,
          (1 << 31) - 1 if per_sm == lr.ALL_STEPS else per_sm * 132, lr.IDENTITY_SPAN)
    _hold(3 * 2 ** 20 + 5, in_off, out_off, 96, 4096)


def test_identity_copy_into_an_offset_output_on_the_cpu():
    """On a CPU tensor the wrapper is ``clone()``, or fills ``out``."""
    x = torch.arange(1000, dtype=torch.int64).to(torch.uint8)
    buf = torch.zeros(1003, dtype=torch.uint8)
    got = lr.identity_copy(x, out=buf[3:])
    assert got.data_ptr() == buf[3:].data_ptr() and torch.equal(got, x)
