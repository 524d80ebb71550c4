"""Multi-host video and folder sharding over a shared filesystem.

A copy of the pure-Python part of ``dither_pie_tpu/parallel/multihost.py``
(the port imports nothing of the JAX package).

Frames are embarrassingly parallel, so scaling over hosts is frame-range
partitioning over the segment grid of the checkpoint/resume machinery
(``pipeline/resume.py``): host k owns segments
``{i : i % host_count == host_index}``. Each host decodes the whole source
once, but dithers and encodes only its own segments, written atomically
(tmp + rename) and recorded in a manifest of its own, so hosts never race on
a file. Once every segment is covered by a manifest that matches the job's
settings fingerprint and its part exists, exactly one host (an O_EXCL lock
arbitrates) concatenates them with the source's audio and subtitles.

Every host drives its own card and needs no collective: each derives the
same palette from the same first frame, and the shared filesystem carries
everything else. So the JAX package's ``initialize`` (a wrapper of
``jax.distributed``) has no counterpart here.
"""

from __future__ import annotations

from typing import Set, Tuple

__all__ = ["host_segments", "parse_shard"]


def host_segments(n_segments: int, host_index: int,
                  host_count: int) -> Set[int]:
    """Segments owned by this host: strided assignment (i % count == index)
    so early-finishing hosts do not all sit behind the video's tail."""
    if not 0 <= host_index < host_count:
        raise ValueError(f"host_index {host_index} not in [0, {host_count})")
    return set(range(host_index, n_segments, host_count))


def parse_shard(spec: str) -> Tuple[int, int]:
    """Parse a CLI ``INDEX:COUNT`` shard spec (e.g. ``"2:8"``)."""
    try:
        idx_s, cnt_s = spec.split(":")
        idx, cnt = int(idx_s), int(cnt_s)
    except ValueError:
        raise ValueError(
            f"shard spec must be INDEX:COUNT (e.g. '0:4'), got {spec!r}")
    if cnt < 1 or not 0 <= idx < cnt:
        raise ValueError(f"shard spec out of range: {spec!r}")
    return idx, cnt
