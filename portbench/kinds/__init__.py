"""Traffic kinds: how a mix drives the system under test.

A traffic file's ``kind`` names its module here, ``kinds/<kind>.py``. The
module gives:

* ``setup(config, traffic, pool, device, lines, pieces) -> System``: the
  system under test built as its users build it (pieces of set-up go into
  ``pieces`` by name, in seconds; lines to print into ``lines``);
* ``warm(system, pool, traffic)``: every shape the window will use, once;
* ``window(system, pool, traffic, seconds, keep, span) -> Window``: the
  measured window, closed loop; ``keep(j)`` says which outputs to keep for
  the check, ``span`` names a profiler range around it (None untraced);
* ``end_to_end(win, setup_s)``: the end-to-end metrics it takes from the
  host clock, by name (the harness reads the others with their readers);
* ``latencies(win)``, ``failed(win)``, ``counters(win, traffic)`` and
  ``profile(win)``: the samples the tails are taken over, the work that
  failed, the counts the per-layer readers divide by, a line on the
  window's drift;
* ``scan_launch(traffic) -> (frames, input_bytes)``: the shape of one
  launch of the configuration's main kernel on this path;
* optionally ``check(config, ref, pool, system, win, device)``: the numbers
  compared, where the harness's comparison of kept outputs does not fit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench import stats


@dataclass
class System:
    """The system under test: the program's ditherer, its palette as
    (P, 3) integers, and the inputs as the kind hands them over (None
    where it hands over the pool's frames as they are)."""

    ditherer: Any
    palette: np.ndarray
    inputs: Any = None


@dataclass
class Window:
    """What the measured window left: per frame (stream) or call (image)
    the host times, and the outputs kept for the check, by position."""

    seconds: float
    start: float = 0.0
    handed: List[float] = field(default_factory=list)
    done: List[float] = field(default_factory=list)
    kept: Dict[int, np.ndarray] = field(default_factory=dict)
    failed_calls: int = 0
    patched: int = 0
    retried: int = 0
    launches: int = 0


def build_system(config: Dict[str, Any], frame0: np.ndarray, device: torch.device) -> System:
    """The ditherer and palette as the command line builds them, from the
    configuration's ``dithering`` and ``palette`` settings and frame 0."""
    from PIL import Image

    from dither_pie_tpu_torch.pipeline.image import build_ditherer

    ditherer = build_ditherer({"dithering": config["dithering"], "palette": config["palette"]},
                              Image.fromarray(frame0), device)
    return System(ditherer=ditherer, palette=np.asarray(ditherer.palette, dtype=np.int64))


def launch_total() -> int:
    """The program's count of hand-written kernel launches so far."""
    from dither_pie_tpu_torch.kernels import build
    return sum(build.LAUNCHES.values())


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_line(unit: str, per_fifth: List[float], lat: List[float], seconds: float) -> str:
    """A line with the window's rate or mean by fifth, and its whole-window
    p50, p95 and rate."""
    whole = (f"p50_ms={stats.percentile(lat, 50) * 1e3:.3f} "
             f"p95_ms={stats.percentile(lat, 95) * 1e3:.3f} "
             f"per_s={stats.rate(len(lat), seconds):.4f}") if lat else "no samples"
    return f"window {unit} by fifth: " + " ".join(f"{v:.2f}" for v in per_fifth) + f"; {whole}"


def fifths(win: Window, parts: int = 5) -> List[tuple]:
    edges = [win.start + win.seconds * k / parts for k in range(parts + 1)]
    return list(zip(edges, edges[1:]))


def optional_span(name: Optional[str]):
    """A profiler range of this name, or nothing when ``name`` is None."""
    import contextlib
    return torch.profiler.record_function(name) if name else contextlib.nullcontext()
