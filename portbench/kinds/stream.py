"""Traffic kind "stream": a decoded clip through ``process_frames``.

The source hands frame i (the pool's frame i mod N) the moment the
pipeline asks for it, as a decoder that is always ready would, and stops
on the first batch boundary once the window's seconds have passed. The
pipeline runs at its defaults but for the traffic's ``batch``: overlap on,
prefetch on, no pixelize stage, no final resize. A frame counts when
``process_frames`` emits it; a frame patched from a neighbour, or never
emitted, counts as failed.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import stats
from portbench.kinds import (System, Window, build_system, fifths, launch_total,
                             optional_span, profile_line, sync)

# The scan reads the batch's uint8 frames as they come.
SCAN_INPUT_BYTES = 1


def setup(config: Dict[str, Any], traffic: Dict[str, Any], pool: np.ndarray,
          device: torch.device, lines: List[str], pieces: Dict[str, float]) -> System:
    from dither_pie_tpu_torch.api import linkspeed

    t = time.perf_counter()
    system = build_system(config, pool[0], device)
    pieces["palette_s"] = time.perf_counter() - t
    t = time.perf_counter()
    wins = linkspeed.index_transfer_wins(device)
    pieces["probe_s"] = time.perf_counter() - t
    lines.append(f"probe d2h_mb_s={linkspeed.d2h_bandwidth_mb_s(device)} "
                 f"break_even_mb_s={linkspeed.break_even_mb_s():.1f} "
                 f"index_stream={'on' if wins else 'off'}")
    return system


def warm(system: System, pool: np.ndarray, traffic: Dict[str, Any]) -> None:
    from dither_pie_tpu_torch.pipeline.video import process_frames

    batch = int(traffic["batch"])
    warm_frames = pool[:batch * int(traffic["warmup_batches"])]
    for _ in process_frames(iter(warm_frames), system.ditherer, batch_size=batch):
        pass


def window(system: System, pool: np.ndarray, traffic: Dict[str, Any], seconds: float,
           keep: Callable[[int], bool], span: Optional[str] = None) -> Window:
    from dither_pie_tpu_torch.pipeline.video import process_frames

    batch = int(traffic["batch"])
    win = Window(seconds=seconds)
    n = pool.shape[0]

    def source():
        i = 0
        while not (i % batch == 0 and time.perf_counter() >= win.start + seconds):
            win.handed.append(time.perf_counter())
            yield pool[i % n]
            i += 1

    launches0 = launch_total()
    with optional_span(span):
        win.start = time.perf_counter()
        for j, out in enumerate(process_frames(source(), system.ditherer, batch_size=batch)):
            win.done.append(time.perf_counter())
            if keep(j):
                win.kept[j] = np.array(out)
        sync(system.ditherer.device)
    win.launches = launch_total() - launches0
    return win


def latencies(win: Window) -> List[float]:
    """Seconds from hand-over to emit of every frame emitted inside the window."""
    end = win.start + win.seconds
    return [d - h for d, h in zip(win.done, win.handed) if d <= end]


def end_to_end(win: Window, setup_s: float) -> Dict[str, float]:
    return {"fps": stats.rate(len(latencies(win)), win.seconds), "setup_s": setup_s}


def failed(win: Window) -> int:
    return len(win.handed) - len(win.done) + win.patched


def counters(win: Window, traffic: Dict[str, Any]) -> Dict[str, int]:
    return {"launches": win.launches, "frames": len(win.handed),
            "batches": len(win.handed) // int(traffic["batch"]), "calls": 0}


def profile(win: Window) -> str:
    per = [sum(lo < d <= hi for d in win.done) / (hi - lo) for lo, hi in fifths(win)]
    return profile_line("fps", per, latencies(win), win.seconds)


def scan_launch(traffic: Dict[str, Any]):
    return int(traffic["batch"]), SCAN_INPUT_BYTES
