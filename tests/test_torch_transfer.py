"""The copy back from the ditherer's device (``api/transfer.py``) and the
batch facade's epilogue, without JAX.

* ``apply_dithering_batch`` returns a uint8 result as the strategy's copy
  back made it, with no second host copy; a gamma ditherer and a non-uint8
  result still get a new, converted array.
* No mode returns its input, or a buffer that the next call writes again.
* ``to_host`` of a CPU tensor is ``t.cpu().numpy()`` and counts no pinned
  bytes; the link probe times ``to_host``'s pinned copy.
* On a card (marked ``cuda``, skipped without one): ``to_host`` returns a
  pinned block equal to the pageable copy, and ``process_frames``'
  frames stay intact while later batches reuse recycled blocks. Run them
  where a card is, without the conftest (it imports JAX):

      python -m pytest --noconftest -m cuda tests/test_torch_transfer.py -q
"""

import os
import types

import numpy as np
import pytest
import torch

import dither_pie_tpu_torch as tdpt
from dither_pie_tpu_torch.api import linkspeed, profiling, transfer
from dither_pie_tpu_torch.pipeline import video
import torch_workers  # noqa: F401

PAL = [(0, 0, 0), (250, 250, 250), (200, 40, 40), (30, 90, 200), (240, 200, 60),
       (20, 160, 70), (120, 60, 160), (255, 140, 0)]
# The strategies whose batch comes back through ``to_host``.
TO_HOST_MODES = ["error_diffusion", "bayer", "blue_noise", "hybrid", "ostromoukhov",
                 "wavelet", "halftone"]


def _frames(b=2, h=12, w=20, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, h, w, 3)).astype(np.uint8)


@pytest.fixture
def default_env(monkeypatch):
    """The program's defaults: no index stream forced, no mesh forced."""
    for key in [k for k in os.environ if k.startswith("DITHER_PIE_TPU_")]:
        monkeypatch.delenv(key)


def _record_to_host(monkeypatch):
    """Wrap ``transfer.to_host``; returns the list of the arrays it returned."""
    seen = []
    real = transfer.to_host

    def record(t):
        out = real(t)
        seen.append(out)
        return out

    monkeypatch.setattr(transfer, "to_host", record)
    return seen


@pytest.mark.parametrize("mode", TO_HOST_MODES)
def test_uint8_batch_is_the_array_the_copy_back_made(mode, default_env, monkeypatch):
    seen = _record_to_host(monkeypatch)
    d = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode(mode), palette=PAL, device="cpu")
    out = d.apply_dithering_batch(_frames())
    assert seen and seen[-1].dtype == np.uint8
    assert np.shares_memory(out, seen[-1])
    assert out.shape == (2, 12, 20, 3) and out.dtype == np.uint8


def test_gamma_batch_is_a_new_converted_array(default_env, monkeypatch):
    seen = _record_to_host(monkeypatch)
    d = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.ERROR_DIFFUSION, palette=PAL,
                           use_gamma=True, device="cpu")
    out = d.apply_dithering_batch(_frames())
    assert not np.shares_memory(out, seen[-1])
    np.testing.assert_array_equal(out, d._from_dither(seen[-1]))
    assert (out != seen[-1]).any()  # the linear-to-sRGB map moved some pixels


def test_a_non_uint8_result_is_still_converted(default_env, monkeypatch):
    made = np.full((2, 12, 20, 3), 7.9, np.float32)
    monkeypatch.setattr(tdpt.ErrorDiffusionDitherStrategy, "dither_batch",
                        lambda self, images, palette_arr: made)
    d = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.ERROR_DIFFUSION, palette=PAL,
                           device="cpu")
    out = d.apply_dithering_batch(_frames())
    assert out.dtype == np.uint8 and not np.shares_memory(out, made)
    assert (out == 7).all()  # truncation, as before


@pytest.mark.parametrize("mode", [m.value for m in tdpt.DitherMode])
def test_no_mode_returns_its_input_or_a_reused_buffer(mode, default_env):
    frames = _frames(seed=1)
    before = frames.copy()
    d = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode(mode), palette=PAL, device="cpu")
    first = d.apply_dithering_batch(frames)
    kept = first.copy()
    second = d.apply_dithering_batch(frames)
    assert first.dtype == np.uint8 and first.shape == frames.shape
    assert not np.shares_memory(first, frames)
    assert not np.shares_memory(first, second)
    np.testing.assert_array_equal(first, kept)  # the second call wrote elsewhere
    np.testing.assert_array_equal(second, kept)
    np.testing.assert_array_equal(frames, before)


def test_to_host_of_a_cpu_tensor_is_unchanged(monkeypatch):
    def no_card(*args, **kwargs):
        raise AssertionError("a CPU tensor's copy back asked the CUDA runtime")

    monkeypatch.setattr(torch.cuda, "host_memory_stats", no_card)
    monkeypatch.setattr(torch.cuda, "current_stream", no_card)
    profiling.reset()
    try:
        t = torch.arange(2 * 3 * 5, dtype=torch.int16).reshape(2, 3, 5)
        out = transfer.to_host(t)
        assert out.dtype == np.int16
        np.testing.assert_array_equal(out, t.numpy())
        assert np.shares_memory(out, t.numpy())  # t.cpu() of a CPU tensor is t
        c = profiling.counters()
        assert c["transfer.d2h_bytes"] == 60
        assert "transfer.d2h_pinned_bytes" not in c
        assert "transfer.pinned_blocks_new" not in c
    finally:
        profiling.reset()


def test_the_probe_times_the_pinned_copy_of_to_host(monkeypatch):
    events = []
    ticks = iter([0.0, 0.010, 1.0, 1.008])

    def pinned_block(t):
        events.append(("alloc", tuple(t.shape), t.dtype))
        return f"block{len(events)}"

    monkeypatch.setattr(linkspeed, "resolve_device", lambda device: torch.device("meta"))
    monkeypatch.setattr(linkspeed, "_cache", {})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: events.append("sync"))
    monkeypatch.setattr(transfer, "pinned_block", pinned_block)
    monkeypatch.setattr(transfer, "copy_back",
                        lambda t, buf: events.append(("copy", tuple(t.shape), buf)))
    monkeypatch.setattr(linkspeed, "time", types.SimpleNamespace(
        perf_counter=lambda: events.append("clock") or next(ticks)))
    mb_s = linkspeed.d2h_bandwidth_mb_s("cuda")
    n = linkspeed._PROBE_BYTES
    one = [("alloc", (n,), torch.uint8), "sync", "clock"]
    assert events == (one + [("copy", (n,), "block1"), "clock"]
                      + one + [("copy", (n,), "block6"), "clock"])
    assert mb_s == pytest.approx(n / 0.008 / 1e6)  # the faster of the two copies


# ---------------------------------------------------------------------------
# On a card.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the copy back into a pinned block runs on a card")
    return torch.device("cuda", 0)


def _pageable(t):
    torch.cuda.current_stream(t.device).synchronize()
    return t.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
def test_to_host_lands_in_a_pinned_block(card, dtype):
    base = (torch.arange(3 * 37 * 41, device=card) * 40503 % 251).to(dtype)
    t = base.reshape(3, 37, 41)[:, 1:, ::2]  # not contiguous
    profiling.reset()
    try:
        out = transfer.to_host(t)
        np.testing.assert_array_equal(out, _pageable(t))
        assert torch.from_numpy(out).is_pinned()
        c = profiling.counters()
        assert c["transfer.d2h_pinned_bytes"] == c["transfer.d2h_bytes"] == t.nbytes
        assert c["transfer.pinned_blocks_new"] >= 0
    finally:
        profiling.reset()


@pytest.mark.cuda
def test_held_frames_survive_recycled_blocks(card, default_env, monkeypatch):
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")  # colours come back
    batch, batches, held_batches = 4, 16, 2
    rng = np.random.RandomState(2147485001 % (1 << 32))
    frames = rng.randint(0, 256, (batch * batches, 1080, 1920, 3)).astype(np.uint8)
    pal = [tuple(c) for c in rng.randint(0, 256, (32, 3))]
    d = tdpt.ImageDitherer(dither_mode=tdpt.DitherMode.ERROR_DIFFUSION, palette=pal,
                           device=card)
    profiling.reset()
    held, at_emit, new_blocks = [], [], []
    for i, out in enumerate(video.process_frames(iter(frames), d, batch_size=batch)):
        assert torch.from_numpy(out).is_pinned()
        at_emit.append(out.copy())
        if i < held_batches * batch:
            held.append(out)
        if i % batch == batch - 1:
            new_blocks.append(profiling.counters()["transfer.pinned_blocks_new"])
    assert len(at_emit) == len(frames)
    for a, want in zip(held, at_emit):
        np.testing.assert_array_equal(a, want)
    # The blocks are recycled: fewer new blocks than batches, none late on.
    assert new_blocks[-1] < batches
    assert new_blocks[-1] == new_blocks[-6]
    profiling.reset()
    monkeypatch.setattr(transfer, "to_host", _pageable)
    for b in range(batches):
        want = d.apply_dithering_batch(frames[b * batch:(b + 1) * batch])
        assert not torch.from_numpy(want).is_pinned()
        np.testing.assert_array_equal(np.stack(at_emit[b * batch:(b + 1) * batch]), want)
