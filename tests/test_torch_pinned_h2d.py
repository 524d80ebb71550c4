"""The video pipeline's send from a page-locked block (``api/transfer.py``,
``pipeline/video.py``), without JAX.

* On a CPU ditherer ``process_frames`` never asks for a pinned block and
  its outputs are those of ``np.stack``-ed batches, interleaved and planar.
* On a CUDA ditherer the batch is stacked into a block of
  ``transfer.pinned_array`` (stubbed here) by a pool of copy threads,
  equal to ``np.stack`` (read-only and reversed frames too), and a frame
  of another shape raises as ``np.stack`` does.
* ``pinned_source`` accepts a C-contiguous view of a pinned tensor in the
  tensor's dtype and refuses anything else; ``to_device`` sends such a view
  to a CUDA device with a non-blocking copy of the block's own tensor and
  counts ``transfer.h2d_pinned_bytes``, and sends every other array as
  ``torch.from_numpy(frames).to(device)``.
* On a card (marked ``cuda``, skipped without one): a pinned stream equals
  the pageable sends bitwise and counts every sent byte as pinned, and a
  block dropped while its copy is queued is not handed out again before
  the copy has run (a planted reuse race on the whole block and on a view
  inside it, which a send that bypasses the allocator's tensor loses). Run
  them where a card is, without the conftest (it imports JAX):

      python -m pytest --noconftest -m cuda tests/test_torch_pinned_h2d.py -q
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import dither_pie_tpu_torch as tdpt
from dither_pie_tpu_torch.api import profiling, transfer
from dither_pie_tpu_torch.pipeline import video
import torch_workers  # noqa: F401

PAL = [(0, 0, 0), (250, 250, 250), (200, 40, 40), (30, 90, 200), (240, 200, 60),
       (20, 160, 70), (120, 60, 160), (255, 140, 0)]


def _frames(n, h, w, seed, planar=False):
    shape = (n, 3, h, w) if planar else (n, h, w, 3)
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


@pytest.fixture
def default_env(monkeypatch):
    """The program's defaults, the index stream off: colours come back."""
    for key in [k for k in os.environ if k.startswith("DITHER_PIE_TPU_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")


@pytest.fixture
def counters():
    profiling.reset()
    yield profiling.counters
    profiling.reset()


@pytest.fixture
def pinned_everywhere(monkeypatch):
    """Every CPU tensor reads as pinned, as a block of the caching host
    allocator does on a card."""
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, device=None: True)


def _block(shape, dtype=torch.uint8):
    """A CPU tensor and its numpy view, standing in for a pinned block."""
    t = torch.arange(int(np.prod(shape)), dtype=torch.int64).remainder(251).to(dtype)
    t = t.reshape(shape)
    return t, t.numpy()


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# The stack.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("planar", [False, True], ids=["nhwc", "planar"])
@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_a_cpu_ditherer_never_asks_for_a_pinned_block(planar, overlap, default_env,
                                                      counters, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU ditherer's stack asked for a pinned block")

    monkeypatch.setattr(transfer, "pinned_array", refuse)
    monkeypatch.setattr(transfer, "_pinned_empty", refuse)
    batch, frames = 3, _frames(8, 10, 14, seed=3, planar=planar)
    d = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.ERROR_DIFFUSION, palette=PAL,
                           device="cpu")
    got = list(video.process_frames(iter(frames), d, batch_size=batch, overlap=overlap,
                                    prefetch=False, planar=planar))
    assert len(got) == len(frames)
    c = counters()
    assert c["transfer.h2d_bytes"] == frames.nbytes
    assert "transfer.h2d_pinned_bytes" not in c
    for b in range(0, len(frames), batch):
        part = list(frames[b:b + batch])
        want = d.apply_dithering_batch(np.stack(part, axis=1 if planar else 0),
                                       planar=planar)
        for i in range(len(part)):
            np.testing.assert_array_equal(got[b + i], want[:, i] if planar else want[i])


@pytest.fixture
def copier():
    with ThreadPoolExecutor(max_workers=3) as ex:
        yield ex


@pytest.mark.parametrize("planar", [False, True], ids=["nhwc", "planar"])
def test_pinned_stack_equals_np_stack(planar, copier, monkeypatch):
    asked = []

    def pinned_array(shape, dtype):
        asked.append((tuple(shape), np.dtype(dtype)))
        return np.full(shape, 77, dtype)  # stale bytes the stack overwrites

    monkeypatch.setattr(transfer, "pinned_array", pinned_array)
    frames = list(_frames(5, 6, 9, seed=4, planar=False))
    if planar:
        frames = [np.ascontiguousarray(f.transpose(2, 0, 1)) for f in frames]
    frames[1] = frames[1][..., ::-1, :] if not planar else frames[1][:, ::-1]  # strides < 0
    frames[2].setflags(write=False)  # a decoder's read-only buffer
    got = video._stack(frames, planar, copier)
    want = np.stack(frames, axis=1 if planar else 0)
    np.testing.assert_array_equal(got, want)
    assert asked == [(want.shape, np.dtype(np.uint8))]
    np.testing.assert_array_equal(video._stack(frames, planar), want)
    assert len(asked) == 1


@pytest.mark.parametrize("copy", [False, True], ids=["np_stack", "pinned"])
def test_a_frame_of_another_shape_raises_as_np_stack_does(copy, copier, monkeypatch):
    monkeypatch.setattr(transfer, "pinned_array", lambda shape, dtype: np.empty(shape, dtype))
    frames = list(_frames(3, 6, 9, seed=8))
    frames[2] = frames[2][:1]  # (1, 9, 3) would broadcast into a (6, 9, 3) slot
    with pytest.raises(ValueError, match="same shape"):
        video._stack(frames, False, copier if copy else None)


class _CardDitherer:
    """A ditherer on a CUDA device that records the batches it is given."""

    device = torch.device("cuda", 0)

    def __init__(self):
        self.batches = []

    def apply_dithering_batch(self, frames, planar=False):
        self.batches.append(frames)
        return frames ^ 0xFF


def test_a_cuda_ditherer_gets_its_batch_in_a_pinned_block(monkeypatch):
    blocks = []

    def pinned_array(shape, dtype):
        t, a = _block(shape, torch.from_numpy(np.empty(0, dtype)).dtype)
        blocks.append(t)
        return a

    monkeypatch.setattr(transfer, "pinned_array", pinned_array)
    frames = _frames(7, 5, 8, seed=5)
    d = _CardDitherer()
    got = list(video.process_frames(iter(frames), d, batch_size=3, overlap=False,
                                     prefetch=False))
    assert [b.shape[0] for b in d.batches] == [3, 3, 1]
    assert len(blocks) == 3
    for batch, block in zip(d.batches, blocks):
        assert np.shares_memory(batch, block.numpy())
    np.testing.assert_array_equal(np.stack(got), frames ^ 0xFF)


def test_pinned_array_views_a_pinned_tensor_of_its_dtype(monkeypatch):
    made = []

    def pinned_empty(shape, dtype):
        t = torch.empty(tuple(shape), dtype=dtype)
        made.append(t)
        return t

    monkeypatch.setattr(transfer, "_pinned_empty", pinned_empty)
    for dtype in (np.uint8, np.float32, np.int16):
        a = transfer.pinned_array((2, 3, 4), dtype)
        assert a.shape == (2, 3, 4) and a.dtype == dtype
        assert np.shares_memory(a, made[-1].numpy())


# ---------------------------------------------------------------------------
# The pinned-backing check and the send.
# ---------------------------------------------------------------------------


def test_the_check_accepts_a_blocks_views(pinned_everywhere):
    block, a = _block((4, 5, 6, 3))
    views = [a, a[1:3], a[2], np.ascontiguousarray(a), a.reshape(20, 18), a[1:2, None]]
    for v in views:
        src = transfer.pinned_source(v)
        assert src is not None and _same_storage(src, block)
        assert tuple(src.shape) == v.shape
        np.testing.assert_array_equal(src.numpy(), v)


def test_the_check_refuses_what_views_no_block(pinned_everywhere):
    block, a = _block((4, 5, 6, 3))
    assert transfer.pinned_source(np.zeros((4, 5, 6, 3), np.uint8)) is None  # plain numpy
    assert transfer.pinned_source(a.copy()) is None
    assert transfer.pinned_source(a[:, 1:]) is None  # not contiguous
    assert transfer.pinned_source(a.view(np.int8)) is None  # not the block's dtype
    assert transfer.pinned_source(a.astype(np.float32)) is None


def test_the_check_refuses_a_pageable_tensors_view():
    t = torch.zeros(4, 5, 3, dtype=torch.uint8)
    assert not t.is_pinned()
    assert transfer.pinned_source(t.numpy()) is None


def _record_to(monkeypatch):
    """Replace ``Tensor.to`` with a recorder that returns the tensor."""
    calls = []

    def to(self, *args, **kwargs):
        calls.append((self, args, kwargs))
        return self

    monkeypatch.setattr(torch.Tensor, "to", to)
    return calls


@pytest.fixture
def no_cuda_runtime(monkeypatch):
    def no_card(*args, **kwargs):
        raise AssertionError("the send asked the CUDA runtime")

    for name in ("host_memory_stats", "current_stream", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_card)


def test_a_pageable_array_is_sent_as_before(no_cuda_runtime, counters, monkeypatch):
    calls = _record_to(monkeypatch)
    frames = _frames(2, 6, 7, seed=6)
    cuda = torch.device("cuda", 0)
    out = transfer.to_device(frames, cuda)
    [(t, args, kwargs)] = calls
    assert args == (cuda,) and kwargs == {"non_blocking": False}  # a blocking copy
    assert out is t and np.shares_memory(t.numpy(), frames)  # torch.from_numpy(frames)
    c = counters()
    assert c["transfer.h2d_bytes"] == frames.nbytes
    assert "transfer.h2d_pinned_bytes" not in c


def test_a_blocks_view_is_sent_non_blocking_from_the_block(pinned_everywhere, no_cuda_runtime,
                                                            counters, monkeypatch):
    block, a = _block((4, 6, 7, 3))
    calls = _record_to(monkeypatch)
    cuda = torch.device("cuda", 0)
    transfer.to_device(a[1:3], cuda)
    [(t, args, kwargs)] = calls
    assert args == (cuda,) and kwargs == {"non_blocking": True}
    assert _same_storage(t, block)  # the allocator's own storage, not a from_numpy copy
    assert t.storage_offset() == 6 * 7 * 3
    np.testing.assert_array_equal(t.numpy(), a[1:3])
    c = counters()
    assert c["transfer.h2d_bytes"] == c["transfer.h2d_pinned_bytes"] == a[1:3].nbytes


@pytest.mark.parametrize("device", [torch.device("cpu"), "cpu"], ids=["device", "name"])
def test_a_blocks_view_to_the_cpu_is_sent_as_before(device, pinned_everywhere, no_cuda_runtime,
                                                      counters):
    block, a = _block((2, 6, 7, 3))
    out = transfer.to_device(a, device)
    np.testing.assert_array_equal(out.numpy(), a)
    c = counters()
    assert c["transfer.h2d_bytes"] == a.nbytes
    assert "transfer.h2d_pinned_bytes" not in c


def test_a_device_by_name_is_a_cuda_device(pinned_everywhere, no_cuda_runtime, monkeypatch):
    block, a = _block((2, 6, 7, 3))
    calls = _record_to(monkeypatch)
    transfer.to_device(a, "cuda:0")
    [(t, args, kwargs)] = calls
    assert args == ("cuda:0",) and kwargs == {"non_blocking": True}
    assert _same_storage(t, block)


# ---------------------------------------------------------------------------
# On a card.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the send from a pinned block runs on a card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("planar", [False, True], ids=["nhwc", "planar"])
def test_a_pinned_stream_equals_the_pageable_sends(planar, card, default_env, counters):
    batch, batches = 4, 6
    rng = np.random.RandomState(2147485003 % (1 << 32))
    frames = _frames(batch * batches, 360, 640, seed=int(rng.randint(1 << 30)), planar=planar)
    pal = [tuple(c) for c in rng.randint(0, 256, (32, 3))]
    d = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.ERROR_DIFFUSION, palette=pal,
                           device=card)
    got = [out.copy() for out in video.process_frames(iter(frames), d, batch_size=batch,
                                                      planar=planar)]
    c = counters()
    assert c["transfer.h2d_pinned_bytes"] == c["transfer.h2d_bytes"] == frames.nbytes
    profiling.reset()
    for b in range(batches):
        part = np.stack(list(frames[b * batch:(b + 1) * batch]), axis=1 if planar else 0)
        want = d.apply_dithering_batch(part, planar=planar)
        for i in range(batch):
            np.testing.assert_array_equal(got[b * batch + i], want[:, i] if planar else want[i])
    c = counters()
    assert c["transfer.h2d_bytes"] == frames.nbytes
    assert "transfer.h2d_pinned_bytes" not in c


def _unguarded_send(frames, device):
    """The send without the guard: a fresh tensor over the block's memory,
    whose storage the allocator does not know. PyTorch's copy still finds
    the block by a pointer at its start, so the race is planted on a view
    that starts inside the block."""
    return torch.from_numpy(frames).to(device, non_blocking=True)


def planted_race(card, send, view):
    """Send ``view`` of a block's batch behind ~0.2 s of queued work, drop
    the block, then stack the next batch into a block of the same size at
    once. Returns (what the sent view reads on the card, the first batch's
    colour, the second batch's colour)."""
    shape = (8, 1080, 1920, 3)  # 49.8 MB: its own size class in these tests
    first_colour, second_colour = _frames(2, 1, 1, seed=7)
    first = transfer.pinned_array(shape, np.uint8)
    first[...] = first_colour
    stream = torch.cuda.Stream(card)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(400_000_000)  # the copy waits behind this
        sent = send(view(first), card)
    del first
    second = transfer.pinned_array(shape, np.uint8)
    second[...] = second_colour  # overwrites the first block if it came back
    stream.synchronize()
    return sent.cpu().numpy(), first_colour, second_colour


VIEWS = {"whole": lambda a: a, "offset": lambda a: a[1:]}


@pytest.mark.cuda
@pytest.mark.parametrize("view", list(VIEWS))
def test_a_queued_copy_keeps_its_block(card, view):
    got, first, second = planted_race(card, transfer.to_device, VIEWS[view])
    assert (got == first).all()
    assert not (first == second).all()


@pytest.mark.cuda
def test_the_planted_race_shows_without_the_guard(card):
    got, first, second = planted_race(card, _unguarded_send, VIEWS["offset"])
    assert not (got == first).all()


@pytest.mark.cuda
def test_a_stack_may_be_the_first_pinned_block_of_a_process(card):
    # Before its first block the allocator's stats are empty.
    code = ("import numpy as np, torch\n"
            "from dither_pie_tpu_torch.api import profiling, transfer\n"
            "a = transfer.pinned_array((4, 5), np.uint8)\n"
            "print(torch.from_numpy(a).is_pinned(), "
            "profiling.counters()['transfer.pinned_blocks_new'])\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "1"]
