"""T3's span plan (``tools.layout_repro.identity_plan``) and the two walks
of ``identity.cu``, held on the CPU.

The CUDA kernel does not run here, so this file holds what it is built
from. The plan cuts n bytes into a head of up to 15 bytes (until the output
is 16-byte aligned), a body of whole 16-byte words in contiguous spans that
the blocks take in turn (block b spans b, b + G, ...; 16 KB spans by
default), and a tail of up to 15 bytes: every byte lies in exactly one
piece, the body's words are 16-byte aligned in both tensors where they
agree mod 16, and the bulk ring fits a block's shared memory. Numpy models
of the kernel's two forms (the bulk ring of TMA copies with its mbarrier
phases and bulk groups, the shifted form's funnel shifts) copy
a tensor placed at every pair of offsets mod 16 in a flat byte buffer with
random bytes around it, read only 16-byte words that hold bytes of the
input, write every output byte exactly once and nothing else, and equal
``identity_plain`` (``clone()``) bit for bit.
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu_torch.tools import layout_repro as lr
from test_torch_skew_tiles import Memory

SIZES = (0, 1, 15, 16, 17, 31, 32, 33, 4095, 65537, 1_000_003, 4 * 2 ** 20 + 7)
OFFSETS = [(a, b) for a in range(16) for b in range(16)]


def _pieces(plan, n):
    """The plan's byte ranges [lo, hi): head, the spans in order, tail."""
    count = -(-plan.body // plan.span) if plan.body else 0
    spans = [(plan.head + i * plan.span, plan.head + min(plan.body, (i + 1) * plan.span))
             for i in range(count)]
    return [(0, plan.head), *spans, (plan.head + plan.body, n)]


def _block_spans(plan, n, b):
    """The spans block b takes, in its order: b, b + blocks, ..."""
    return _pieces(plan, n)[1:-1][b::plan.blocks]


@pytest.mark.parametrize("span", (None, 16, 4096, 65_536), ids=lambda v: f"span{v}")
@pytest.mark.parametrize("blocks", (1, 7, 264, 528))
@pytest.mark.parametrize("n", SIZES)
def test_plan_puts_every_byte_in_one_piece(n, blocks, span):
    """For every pair of offsets mod 16: head, spans and tail tile [0, n) in
    order; the head brings the output to a 16-byte boundary, head and tail
    are under 16 bytes, the spans are whole 16-byte words, every block has
    one at least and the grid is at most what was asked for; the blocks'
    turns take each span once; the form is shifted exactly where the
    offsets disagree."""
    for in16, out16 in OFFSETS:
        plan = (lr.identity_plan(n, in16, out16, blocks) if span is None else
                lr.identity_plan(n, in16, out16, blocks, span=span))
        assert plan.form == ("shifted" if in16 != out16 else "bulk")
        assert plan.threads == lr.IDENTITY_THREADS[plan.form]
        pieces = _pieces(plan, n)
        assert pieces[0][0] == 0 and pieces[-1][1] == n
        assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(pieces, pieces[1:]))
        assert plan.head < 16 and n - plan.head - plan.body < 16
        assert (out16 + plan.head) % 16 == 0 or plan.head == n
        assert plan.body % 16 == 0 and plan.span % 16 == 0
        assert (plan.span > 0) == (plan.body > 0)
        assert 1 <= plan.blocks <= blocks
        if span is None and plan.body:  # the default spans
            assert plan.span == lr.IDENTITY_SPAN
        if plan.body:
            spans = pieces[1:-1]
            assert plan.blocks <= len(spans)  # no block without work
            for b in {0, 1, plan.blocks - 1} & set(range(plan.blocks)):
                # The kernel's count of block b's turns (struct Spans).
                assert (len(spans) - 1 - b) // plan.blocks + 1 == len(spans[b::plan.blocks])
            assert all(hi > lo for lo, hi in spans)
            assert all((hi - lo) == plan.span for lo, hi in spans[:-1])
            assert all((out16 + lo) % 16 == 0 for lo, _ in spans)
            if in16 == out16:  # both pointers on the boundary: the bulk form
                assert all((in16 + lo) % 16 == 0 for lo, _ in spans)


@pytest.mark.parametrize("n", (16, 17, 33, 4095, 65537))
def test_plan_of_one_word_spans(n):
    """Spans of one 16-byte word: as many blocks as words at most."""
    for in16, out16 in OFFSETS:
        plan = lr.identity_plan(n, in16, out16, 7, span=16)
        pieces = _pieces(plan, n)
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        assert plan.blocks == min(7, plan.body // 16) or not plan.body


def test_plan_forms_and_ring():
    """The offsets pick the form, the shifted form has no ring, and the
    ring's shared memory is its stages of one span and their barriers."""
    plan = lr.identity_plan(1 << 20, 3, 5, 264)
    assert (plan.form, plan.threads, plan.stages, plan.smem_bytes) == ("shifted", 256, 0, 0)
    bulk = lr.identity_plan(1 << 20, 3, 3, 264, 6, 32768)
    assert (bulk.form, bulk.threads) == ("bulk", 32)
    assert (bulk.stages, bulk.span, bulk.smem_bytes) == (6, 32768, 6 * (32768 + 8))
    full = lr.identity_plan(622_080_000, 0, 0, 4 * 132)
    assert (full.form, full.head, full.body, full.blocks, full.span, full.stages) == (
        "bulk", 0, 622_080_000, 528, lr.IDENTITY_SPAN, lr.IDENTITY_STAGES)
    for bad in (dict(stages=1), dict(stages=33), dict(span=24), dict(span=0),
                dict(stages=8, span=32768)):
        with pytest.raises(ValueError):
            lr.identity_plan(1 << 20, 0, 0, 264, **bad)
    with pytest.raises(ValueError):
        lr.identity_plan(10, 16, 0, 1)


def _copy_bytes(src, dst, lo, hi):
    """Bytes [lo, hi) one by one (the head and the tail)."""
    at = np.arange(lo, hi)
    assert np.all((at >= 0) & (at < src.size))
    dst.data[dst.offset + at] = src.data[src.offset + at]
    np.add.at(dst.writes, dst.offset + at, 1)


def _words_at(mem, first, count):
    """``count`` 16-byte words from the aligned address ``first``."""
    return mem.words(first + 16 * np.arange(count))


def _bulk_block(src, dst, plan, spans):
    """The ring of one block over its spans in turn: span k goes to stage
    k % S; one thread starts the loads of spans 0 .. S-1, then for each
    span waits for its stage's barrier phase, stores it (one bulk group)
    and, once the group before has read its stage, refills that stage. The
    events are replayed in order: a stage is read back out only after its
    load, and loaded again only after the store of its last span has read
    it."""
    stages = plan.stages
    count = len(spans)
    ring = [None] * stages  # (span, its bytes) a stage holds
    phase = [0] * stages    # completed phases of each stage's barrier
    read = set()            # spans whose store has read their stage

    def load(k):
        st = k % stages
        assert ring[st] is None or ring[st][0] in read, "stage refilled before its store read it"
        lo, hi = spans[k]
        assert k == count - 1 or hi - lo == plan.span  # only the last may be short
        a_in, a_out = src.offset + lo, dst.offset + lo
        assert a_in % 16 == 0 and a_out % 16 == 0 and (hi - lo) % 16 == 0 and hi > lo
        ring[st] = (k, _words_at(src, a_in, (hi - lo) // 16))
        phase[st] += 1  # complete_tx: the bytes arrived

    stored = []
    for k in range(min(count, stages)):
        load(k)
    for k in range(count):
        st = k % stages
        # try_wait.parity (k / S) & 1 returns once phase k / S of the
        # stage's barrier has completed: the load of span k, and no later.
        assert phase[st] == k // stages + 1, "waited on the wrong phase"
        held, words = ring[st]
        assert held == k
        addr = dst.offset + spans[k][0] + 16 * np.arange(len(words))
        dst.store(addr, words, np.zeros(len(addr), np.int64), np.full(len(addr), 16))
        stored.append(k)
        if k >= 1 and k - 1 + stages < count:
            read.update(stored[:-1])  # wait_group.read 1: all but the newest group
            load(k - 1 + stages)
    read.update(stored)  # wait_group 0 before the block ends


def _shifted_block(src, dst, plan, spans):
    """The shifted form: output word w of a span is built from the aligned
    input words w and w + 1 around its bytes (r bytes in, r the same for
    the whole copy) by four funnel shifts of 32-bit words."""
    for lo, hi in spans:
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
    walk = {"bulk": _bulk_block, "shifted": _shifted_block}
    for b in range(plan.blocks if plan.body else 0):
        walk[plan.form](src, dst, plan, _block_spans(plan, n, b))
    return dst.tensor(np.uint8, x.shape)


def _hold(n, in_off, out_off, blocks, stages=3, span=64, seed=0):
    x = np.random.RandomState(n + 17 * in_off + out_off).randint(0, 256, n).astype(np.uint8)
    plan = lr.identity_plan(n, in_off % 16, out_off % 16, blocks, stages, span)
    got = identity_model(x, in_off, out_off, plan, seed)
    want = lr.identity_plain(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("ring", ((3, 64), (2, 160), (4, 96)), ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("in_off", range(16))
def test_model_copy_equals_clone(in_off, ring):
    """Every pair of offsets mod 16 (each output offset against this input
    offset), at sizes around the word and the ring: short spans and few
    stages, so each block takes many spans in turn and its ring wraps many
    times."""
    stages, span = ring
    for out_off in range(16):
        for n in (0, 1, 15, 16, 17, 47, 1000, 4099):
            _hold(n, in_off + 32, out_off + 48, 3, stages, span)
        _hold(20_011, in_off, out_off, 5, stages, span)
        _hold(9_001, in_off, out_off, 4, stages, span)


@pytest.mark.parametrize("offsets", [(0, 0), (5, 5), (3, 11), (15, 0)],
                         ids=lambda v: f"in{v[0]}-out{v[1]}")
def test_model_copy_of_megabytes_equals_clone(offsets):
    """A few MB with the path's own plan (528 blocks, the default ring and
    spans), and with spans of a few KB that each block takes many of."""
    in_off, out_off = offsets
    _hold(3 * 2 ** 20 + 5, in_off, out_off, 528, lr.IDENTITY_STAGES, lr.IDENTITY_SPAN)
    _hold(3 * 2 ** 20 + 5, in_off, out_off, 96, 4, 4096)


def test_identity_copy_into_an_offset_output_on_the_cpu():
    """On a CPU tensor the wrapper is ``clone()``, or fills ``out``."""
    x = torch.arange(1000, dtype=torch.int64).to(torch.uint8)
    buf = torch.zeros(1003, dtype=torch.uint8)
    got = lr.identity_copy(x, out=buf[3:])
    assert got.data_ptr() == buf[3:].data_ptr() and torch.equal(got, x)
