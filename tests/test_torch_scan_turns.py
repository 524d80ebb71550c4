"""The order of scan launches across CUDA streams (``ops.wavefront.ScanTurns``),
without JAX.

* On the CPU, with stand-ins for the CUDA stream, event and capture query:
  a launch waits for the last one of another stream only where the two
  need more clusters than the card holds; a stream's own launches, a
  captured launch and another card's launches never wait.
* On a card (marked ``cuda``, skipped without one): two streams' scans of
  16 1080p frames at 256 colours (2 x 16 clusters of 4, more than an H100
  holds at once) equal one stream's bitwise and never overlap on the card.
  Run them where a card is, without the conftest (it imports JAX):

      python -m pytest --noconftest -m cuda tests/test_torch_scan_turns.py -q
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu_torch.ops import wavefront as twf
import torch_workers  # noqa: F401


class FakeStream:
    def __init__(self, name):
        self.name = name
        self.waited = []

    def wait_event(self, event):
        self.waited.append(event.stream.name)

    def __eq__(self, other):
        return self.name == other.name

    __hash__ = None


class FakeEvent:
    def record(self, stream):
        self.stream = stream


@pytest.fixture
def fake_cuda(monkeypatch):
    """``current`` names the current stream; ``capturing`` the capture flag."""
    state = {"current": "a", "capturing": False}
    streams = {}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: streams.setdefault(
                            (device.index, state["current"]),
                            FakeStream(state["current"])))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["capturing"])
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    state["streams"] = streams
    return state


def _launch(turns, state, stream, clusters, capacity=30, card=0):
    state["current"] = stream
    launched = []
    with turns.turn(torch.device("cuda", card), clusters, capacity):
        launched.append(stream)
    assert launched == [stream]
    return state["streams"].get((card, stream))


def test_a_launch_waits_only_where_two_streams_overflow_the_card(fake_cuda):
    turns = twf.ScanTurns()
    a = _launch(turns, fake_cuda, "a", 16)
    assert a.waited == []                 # the first launch
    _launch(turns, fake_cuda, "a", 16)
    assert a.waited == []                 # its own stream orders it
    b = _launch(turns, fake_cuda, "b", 16)
    assert b.waited == ["a"]              # 16 + 16 > 30
    _launch(turns, fake_cuda, "a", 14)
    assert a.waited == []                 # 16 + 14 fits 30
    _launch(turns, fake_cuda, "b", 17)
    assert b.waited == ["a", "a"]         # 14 + 17 > 30


def test_launches_that_fit_together_still_overlap(fake_cuda):
    turns = twf.ScanTurns()
    _launch(turns, fake_cuda, "a", 16, capacity=264)
    assert _launch(turns, fake_cuda, "b", 16, capacity=264).waited == []
    assert _launch(turns, fake_cuda, "a", 16, capacity=264).waited == []


def test_captured_launches_and_other_cards_take_no_turn(fake_cuda):
    turns = twf.ScanTurns()
    _launch(turns, fake_cuda, "a", 16)
    fake_cuda["capturing"] = True
    assert _launch(turns, fake_cuda, "b", 16) is None  # no stream asked, no wait
    fake_cuda["capturing"] = False
    assert _launch(turns, fake_cuda, "c", 16, card=1).waited == []  # another card
    assert _launch(turns, fake_cuda, "b", 16).waited == ["a"]  # card 0's last is a


# ---------------------------------------------------------------------------
# On a card.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan's turns order launches on a card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_two_streams_scans_match_one_and_take_turns(card):
    rng = np.random.RandomState(2147485003 % (1 << 32))
    frames = [torch.from_numpy(rng.randint(0, 256, (16, 1080, 1920, 3)).astype(np.uint8))
              .to(card) for _ in range(2)]
    pal = torch.from_numpy(rng.randint(0, 256, (256, 3)).astype(np.float32)).to(card)
    want = [twf.ed_batch_wavefront(f, pal) for f in frames]
    torch.cuda.synchronize(card)
    streams = [torch.cuda.Stream(card) for _ in frames]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(card))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = []
        for s, f in zip(streams, frames):
            with torch.cuda.stream(s):
                got.append(twf.ed_batch_wavefront(f, pal))
        torch.cuda.synchronize(card)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    scans = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.device_type() == torch.autograd.DeviceType.CUDA
                   and "ed_scan_kernel" in ev.name())
    assert len(scans) == 2
    assert scans[0][1] <= scans[1][0]  # the second started after the first ended
