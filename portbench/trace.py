"""The traced run: ``torch.profiler`` over the window, read in memory.

The harness starts its own profiler (CPU and CUDA activities) before the
window and stops it after the last frame of the window has come back; in
an untraced run of a cell with an end-to-end metric read from the card's
trace, a profiler of the card alone (no host ranges) spans the window. The
profiler's events are read from its in-memory results, never exported, and
reduced to plain tuples that the metric readers take:

* ``device``: (name, kind, start_ns, end_ns, card) of every kernel, copy
  and memset on a card (kind "kernel", "h2d", "d2h", "copy" or "memset";
  ``card`` the device's index, 0 where a tuple leaves it out);
* ``host``: (name, start_ns, end_ns, thread) of every operator and
  ``record_function`` range on the host, the program's own ``stage`` spans
  (``video.dither_batch``) and the harness's (``portbench.window``,
  ``portbench.image_call``) among them.

Both clocks are the profiler's, so device and host intervals compare.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from portbench import stats

WINDOW_SPAN = "portbench.window"
CALL_SPAN = "portbench.image_call"
# At most this many entries in each list of the result's breakdown.
BREAKDOWN_ENTRIES = 10
_NAME_CHARS = 160


@dataclass
class Trace:
    device: List[Tuple] = field(default_factory=list)
    host: List[Tuple[str, int, int, int]] = field(default_factory=list)
    window: Tuple[int, int] = (0, 0)
    # The cards the run uses: the busy time is their mean.
    cards: int = 1

    def spans(self, name: str) -> List[Tuple[int, int]]:
        """(start_ns, end_ns) of every host range of this name."""
        return [(s, e) for n, s, e, _ in self.host if n == name]

    def device_intervals(self, kinds=None, name_has: Optional[str] = None,
                         within: Optional[Tuple[int, int]] = None,
                         card: Optional[int] = None) -> List[Tuple[int, int]]:
        """Device intervals of the given kinds (all when None), whose name
        holds ``name_has``, on ``card`` (every card when None), clipped to
        ``within`` (the window when None)."""
        lo, hi = within or self.window
        out = []
        for op in self.device:
            name, kind, s, e = op[:4]
            if kinds is not None and kind not in kinds:
                continue
            if name_has is not None and name_has not in name:
                continue
            if card is not None and (op[4] if len(op) > 4 else 0) != card:
                continue
            s, e = max(s, lo), min(e, hi)
            if e > s:
                out.append((s, e))
        return out

    def device_seconds(self, kinds=None, name_has: Optional[str] = None,
                       within: Optional[Tuple[int, int]] = None) -> float:
        """Summed device time (not the union) of the matching intervals."""
        return sum(e - s for s, e in self.device_intervals(kinds, name_has, within)) * 1e-9

    def busy_seconds(self, within: Optional[Tuple[int, int]] = None) -> float:
        """The union of a card's device intervals inside ``within``, in
        seconds, averaged over the cards the run uses."""
        lo, hi = within or self.window
        return sum(stats.covered(self.device_intervals(within=(lo, hi), card=c), lo, hi)
                   for c in range(self.cards)) / self.cards * 1e-9

    @property
    def window_seconds(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9


def _device_kind(name: str) -> str:
    """A device event's kind by its name, as CUPTI names copies and memsets
    ("Memcpy HtoD (Pageable -> Device)", "Memset (Device)"); every other
    device event is a kernel."""
    if name.startswith("Memcpy"):
        if "HtoD" in name:
            return "h2d"
        if "DtoH" in name:
            return "d2h"
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def start(device: torch.device, host: bool = True) -> "torch.profiler.profile":
    """A started profiler of the card on a CUDA device and, with ``host``,
    of every thread's host ranges."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host else []
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # The pipeline's prefetch thread and dither workers are not the thread
    # that starts the profiler: record every thread's ranges.
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True) if host else None
    prof = profile(activities=activities, experimental_config=config)
    prof.start()
    return prof


def collect(prof: "torch.profiler.profile", cards: int = 1, window_span: bool = True) -> Trace:
    """Stop the profiler and reduce its events to a ``Trace`` of ``cards``
    cards; the window is the harness's ``portbench.window`` range, or
    without ``window_span`` (a profiler of the card alone, started just
    before the window and stopped after its last wait) all the card's
    events."""
    prof.stop()
    trace = Trace(cards=cards)
    device = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((name, s, e, ev.device_index()))
        else:
            trace.host.append((name, s, e, ev.start_thread_id()))
    # A record_function range is also drawn on the device's timeline under
    # its own name; it is no device work.
    ranges = {n for n, _, _, _ in trace.host}
    trace.device = [(n, _device_kind(n), s, e, c) for n, s, e, c in device if n not in ranges]
    if not window_span:
        if trace.device:
            trace.window = (min(op[2] for op in trace.device), max(op[3] for op in trace.device))
        return trace
    windows = trace.spans(WINDOW_SPAN)
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {WINDOW_SPAN} ranges, not 1")
    trace.window = windows[0]
    return trace


def breakdown(trace: Trace) -> Dict[str, List[List]]:
    """The device operations that took the most time inside the window, by
    name, and the longest idle gaps of the device, each named by the
    innermost host range that held the gap's middle."""
    by_name: Dict[str, float] = {}
    lo, hi = trace.window
    for op in trace.device:
        name, s, e = op[0], max(op[2], lo), min(op[3], hi)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    idle = sorted(stats.gaps(trace.device_intervals(), lo, hi), key=lambda g: g[0] - g[1])
    host = sorted((s, e, n) for n, s, e, _ in trace.host if n != WINDOW_SPAN)
    starts = [h[0] for h in host]
    gaps = []
    for g0, g1 in idle[:BREAKDOWN_ENTRIES]:
        mid = (g0 + g1) // 2
        inner = None
        for s, e, n in host[:bisect.bisect_right(starts, mid)]:
            if e >= mid and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, n)
        label = inner[2] if inner else "no host range"
        gaps.append([label[:_NAME_CHARS], (g1 - g0) * 1e-9])
    return {"device_ops": [[n[:_NAME_CHARS], t] for n, t in ops], "idle_gaps": gaps}
