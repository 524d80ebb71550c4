"""The arithmetic of the end-to-end metrics and of the spreads.

Every rate and tail is taken over the whole window: a rate is the work done
in the window over its length, a tail the percentile of every sample the
window holds, never a median of chunks.
"""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

import numpy as np


def rate(count: int, seconds: float) -> float:
    """Work done in a window over the window's length."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of all values, linear between the two nearest
    ranks (numpy's default); raises on an empty sample."""
    if len(values) == 0:
        raise ValueError("no samples: the window held no completed work")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of the
    median, with Python's ``statistics.quantiles(values, n=4)``."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals that cover the same points as the input."""
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def covered(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of [lo, hi] that the union of the intervals covers."""
    total = 0.0
    for start, end in union(intervals):
        s, e = max(start, lo), min(end, hi)
        if e > s:
            total += e - s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out: List[Tuple[float, float]] = []
    at = lo
    for start, end in union(intervals):
        if end <= lo:
            continue
        if start >= hi:
            break
        if start > at:
            out.append((at, start))
        at = max(at, end)
    if at < hi:
        out.append((at, hi))
    return out
