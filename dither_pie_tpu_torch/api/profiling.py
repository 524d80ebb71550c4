"""Spans and counters of the pipelines and the facade, and the trace exporter.

    from dither_pie_tpu_torch.api.profiling import count, stage, stage_report

    with stage("video.dither_batch", batch=3):
        ...
    count("transfer.h2d_bytes", tensor.nbytes)
    print(stage_report())

Each ``stage`` adds its wall time to a per-name total (thread-safe: the
video pipeline's two workers time their batches at once). While a
``torch.profiler`` records, the stage is also a ``record_function`` range,
on the profiler's clock, which the card's events share; otherwise it enters
no range, and a span costs one flag check beside its wall total. ``count``
adds to a named counter under a lock; ``counters()`` returns them. Both
are cumulative over the process until ``reset()``.

The names (the benchmark's readers in ``portbench/metrics/`` and PERF.md
use them):

* spans: ``video.prefetch_get`` (the pipeline blocked on decode),
  ``video.stack``, ``video.dither_batch``, ``video.retry`` (a failed
  batch, frame by frame), ``video.wait`` (the emitter blocked on the oldest
  batch), ``facade.host_in`` (host work before the frames go to the
  device), ``transfer.h2d``, ``ops.ed_dispatch`` (enqueueing the
  error-diffusion kernels), ``device.wait`` (CUDA only: the stream's work
  before the copy back), ``transfer.d2h``, ``facade.host_out`` (host work
  after the copy back, up to the facade's return); ``video.pixelize`` (the
  main thread's pixelize stage of a batch) and, inside it,
  ``neural.host_in`` (the neural pixelizer's resize, crop and uint8
  concat), ``neural.forward`` (the host's dispatch of C2PGen and AliasNet),
  ``neural.wait`` (the copy back of the output, the device wait inside it)
  and ``neural.host_out`` (``upsample4_u8`` and the PIL resizes);
* counters: ``video.prefetch_depth`` and ``video.prefetch_gets`` (their
  ratio is the mean depth of the decode queue), ``video.frames`` (frames
  emitted), ``video.batches_retried``, ``video.frames_failed``,
  ``video.frames_patched``, ``facade.frames`` (frames that entered a dither
  path), ``transfer.h2d_bytes`` and ``transfer.d2h_bytes`` (the frames'
  bytes to and from the ditherer's device), ``transfer.h2d_pinned_bytes``
  (those of the send that left from a pinned host block: the video
  pipeline's stacked batches on a CUDA ditherer),
  ``transfer.d2h_pinned_bytes`` (those of the copy back that landed in a
  pinned host block) and ``transfer.pinned_blocks_new`` (pinned blocks the
  caching host allocator page-locked anew for either copy; flat once its
  cache is warm),
  ``neural.frames`` (frames the neural pixelizer pixelized),
  ``neural.batches`` (its batched forwards) and ``neural.gate_forwards``
  (forwards its two first-batch gates ran; flat once they have locked).

With ``DITHER_PIE_TPU_TRACE_DIR`` set when the first stage runs, that stage
starts a ``torch.profiler`` of the host (every thread) and the card, and at
the process's exit ``stop_trace()`` writes ``trace_<pid>.json`` (a Chrome
trace) and ``counters_<pid>.json`` (the counters and the stage totals)
there.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_DIR_ENV = "DITHER_PIE_TPU_TRACE_DIR"

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_counters: Dict[str, int] = defaultdict(int)
_profiler: Optional["torch.profiler.profile"] = None
_trace_dir: Optional[Path] = None
_trace_env_read = False


def _maybe_start_trace() -> None:
    """Read ``DITHER_PIE_TPU_TRACE_DIR`` once; where it is set, start the
    exporter's profiler and register ``stop_trace`` to run at exit."""
    global _profiler, _trace_dir, _trace_env_read
    with _lock:
        if _trace_env_read:
            return
        _trace_env_read = True
        trace_dir = os.environ.get(TRACE_DIR_ENV)
        if not trace_dir:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        # The prefetch thread and the dither workers are not the thread that
        # starts the profiler: record every thread's ranges.
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        _profiler = profile(activities=activities, experimental_config=config)
        _trace_dir = Path(trace_dir)
        _profiler.start()
    atexit.register(stop_trace)


def stop_trace() -> Optional[Path]:
    """Stop the trace that ``DITHER_PIE_TPU_TRACE_DIR`` started and write
    it there with the counters beside it; returns the trace's path, or None
    when no trace ran."""
    global _profiler
    with _lock:
        prof, _profiler = _profiler, None
    if prof is None:
        return None
    prof.stop()
    _trace_dir.mkdir(parents=True, exist_ok=True)
    out = _trace_dir / f"trace_{os.getpid()}.json"
    prof.export_chrome_trace(str(out))
    with _lock:
        record = {"counters": dict(_counters),
                  "stages": {n: {"total_ms": _totals[n] * 1e3, "count": _counts[n]}
                             for n in _totals}}
    (_trace_dir / f"counters_{os.getpid()}.json").write_text(json.dumps(record, indent=1))
    return out


@contextlib.contextmanager
def stage(name: str, batch: Optional[int] = None) -> Iterator[None]:
    """Wall-clock a stage; while a profiler records, mark it in the trace
    as a ``record_function`` range (with ``batch=<n>`` as its argument
    where a batch number is given)."""
    if not _trace_env_read:
        _maybe_start_trace()
    t0 = time.perf_counter()
    # The flag is set while any torch.profiler records; the thread-local
    # torch._C._autograd._profiler_enabled() reads False on every thread
    # under profile_all_threads.
    if _autograd_profiler._is_profiler_enabled:
        with torch.profiler.record_function(name, None if batch is None else f"batch={batch}"):
            yield
    else:
        yield
    dt = time.perf_counter() - t0
    with _lock:
        _totals[name] += dt
        _counts[name] += 1


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] += n


def counters() -> Dict[str, int]:
    """Every counter's value since the process started or the last ``reset()``."""
    with _lock:
        return dict(_counters)


def stage_report() -> str:
    with _lock:
        lines = ["stage timings:"]
        for name in sorted(_totals, key=_totals.get, reverse=True):
            n = _counts[name]
            tot = _totals[name]
            lines.append(f"  {name:24s} {tot*1000:9.1f} ms total "
                         f"({n}x, {tot/n*1000:.1f} ms avg)")
        for name in sorted(_counters):
            lines.append(f"  {name:24s} {_counters[name]:12d} (counter)")
    return "\n".join(lines)


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()
        _counters.clear()
