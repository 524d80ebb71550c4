"""Per-stage wall clock and device trace hooks of the pipelines.

    from dither_pie_tpu_torch.api.profiling import stage, stage_report

    with stage("video.dither_batch"):
        ...
    print(stage_report())

Each ``stage`` adds its wall time to a per-name total (thread-safe: the
video pipeline's two workers time their batches at once) and marks its
span in a ``torch.profiler`` trace as a ``record_function`` range. With
``DITHER_PIE_TPU_TRACE_DIR`` set, the first stage starts a
``torch.profiler`` trace of the host and the card, and ``stop_trace()``
writes it there as a Chrome trace (``trace_<pid>.json``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_profiler: Optional["torch.profiler.profile"] = None


def _maybe_start_trace() -> None:
    global _profiler
    trace_dir = os.environ.get("DITHER_PIE_TPU_TRACE_DIR")
    if not trace_dir or _profiler is not None:
        return
    with _lock:
        if _profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            _profiler = profile(activities=activities)
            _profiler.start()


def stop_trace() -> Optional[Path]:
    """Stop the trace that ``DITHER_PIE_TPU_TRACE_DIR`` started and write
    it there; returns its path, or None when no trace ran."""
    global _profiler
    with _lock:
        prof, _profiler = _profiler, None
    if prof is None:
        return None
    prof.stop()
    out = Path(os.environ["DITHER_PIE_TPU_TRACE_DIR"]) / f"trace_{os.getpid()}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    return out


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Wall-clock a pipeline stage and mark it in the profiler's trace."""
    _maybe_start_trace()
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    with _lock:
        _totals[name] += dt
        _counts[name] += 1


def stage_report() -> str:
    with _lock:
        lines = ["stage timings:"]
        for name in sorted(_totals, key=_totals.get, reverse=True):
            n = _counts[name]
            tot = _totals[name]
            lines.append(f"  {name:24s} {tot*1000:9.1f} ms total "
                         f"({n}x, {tot/n*1000:.1f} ms avg)")
    return "\n".join(lines)


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()
