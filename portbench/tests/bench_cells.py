"""Cells of BENCHMARK.json cut to a size a CPU test run holds."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cells  # noqa: E402


def tiny_cell(name: str, colors: int = 16) -> cells.Cell:
    """The cell ``name`` at 24x40 frames, a pool of 7, batches of 4 and at
    most ``colors`` colours: the plain versions of the kernels run it on
    the CPU in about a second."""
    cell = cells.find_cell(cells.load_benchmark(), name)
    cell.traffic.update(height=24, width=40, pool=7)
    if cell.traffic["kind"] == "stream":
        cell.traffic.update(batch=4, warmup_batches=1, sample_stride=3)
    else:
        cell.traffic.update(warmup_calls=1, sample_stride=2)
    cell.config["palette"]["num_colors"] = min(cell.config["palette"]["num_colors"], colors)
    return cell
