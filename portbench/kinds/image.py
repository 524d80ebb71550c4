"""Traffic kind "image": one client sending PIL images to ``apply_dithering``.

Closed loop: the next image (the pool's image i mod N) goes out when the
previous call returns, until the window's seconds have passed, as the
GUI's previews and the command line call the facade. A call that raises
counts as failed, and the run goes on.
"""

from __future__ import annotations

import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from PIL import Image

from portbench import trace
from portbench.kinds import (System, Window, build_system, fifths, launch_total,
                             optional_span, profile_line)

# The facade hands the scan one float32 frame.
SCAN_INPUT_BYTES = 4


def setup(config: Dict[str, Any], traffic: Dict[str, Any], pool: np.ndarray,
          device: torch.device, lines: List[str], pieces: Dict[str, float]) -> System:
    t = time.perf_counter()
    system = build_system(config, pool[0], device)
    pieces["palette_s"] = time.perf_counter() - t
    t = time.perf_counter()
    system.inputs = [Image.fromarray(f) for f in pool]
    pieces["images_s"] = time.perf_counter() - t
    lines.append("probe not on this path (apply_dithering never asks it)")
    return system


def warm(system: System, pool: np.ndarray, traffic: Dict[str, Any]) -> None:
    images = system.inputs
    for i in range(int(traffic["warmup_calls"])):
        system.ditherer.apply_dithering(images[i % len(images)])


def window(system: System, pool: np.ndarray, traffic: Dict[str, Any], seconds: float,
           keep: Callable[[int], bool], span: Optional[str] = None) -> Window:
    images = system.inputs
    win = Window(seconds=seconds)
    n = len(images)
    launches0 = launch_total()
    with optional_span(span):
        win.start = time.perf_counter()
        i = 0
        while time.perf_counter() < win.start + seconds:
            win.handed.append(time.perf_counter())
            try:
                with optional_span(trace.CALL_SPAN if span else None):
                    out = system.ditherer.apply_dithering(images[i % n])
            except Exception:  # a call that never answers: counted, and the run goes on
                traceback.print_exc(file=sys.stderr)
                win.failed_calls += 1
                out = None
            win.done.append(time.perf_counter())
            if out is not None and keep(i):
                win.kept[i] = np.asarray(out)
            i += 1
    win.launches = launch_total() - launches0
    return win


def latencies(win: Window) -> List[float]:
    """The wall of every call started inside the window."""
    end = win.start + win.seconds
    return [d - h for d, h in zip(win.done, win.handed) if h < end]


def end_to_end(win: Window, setup_s: float) -> Dict[str, float]:
    return {"setup_s": setup_s}


def failed(win: Window) -> int:
    return win.failed_calls


def counters(win: Window, traffic: Dict[str, Any]) -> Dict[str, int]:
    return {"launches": win.launches, "frames": len(win.handed), "batches": 0,
            "calls": len(win.handed)}


def profile(win: Window) -> str:
    per = []
    for lo, hi in fifths(win):
        lat = [d - h for d, h in zip(win.done, win.handed) if lo <= h < hi]
        per.append(sum(lat) / len(lat) * 1e3 if lat else float("nan"))
    return profile_line("ms a call", per, latencies(win), win.seconds)


def scan_launch(traffic: Dict[str, Any]):
    return 1, SCAN_INPUT_BYTES
