"""Segmented checkpoint/resume for long video jobs.

A copy of ``dither_pie_tpu/pipeline/resume.py`` (the port imports nothing of
the JAX package). A job can run in fixed-size segments: each segment is
encoded to ``<output>.segNNNN.mp4`` and recorded in a ``.resume.json``
manifest; an interrupted job restarted with ``resume=True`` re-processes
only the missing segments, then the parts are concatenated (stream copy)
and the original audio/subtitles mapped in.

Segment planning is pure (unit-tested); the encode/concat legs need ffmpeg.
"""

from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple


def manifest_path(output_path: str, host_index: int = 0) -> str:
    """Per-host manifests (``.resume.json`` for host 0, ``.resume.hK.json``
    otherwise) — multi-host jobs write disjoint files, so there are no
    cross-host races; part-file existence remains the source of truth."""
    if host_index == 0:
        return output_path + ".resume.json"
    return f"{output_path}.resume.h{host_index}.json"


def segment_part_path(output_path: str, seg_idx: int) -> str:
    return f"{output_path}.seg{seg_idx:04d}.mp4"


def segment_tmp_path(output_path: str, seg_idx: int) -> str:
    """Encode target before the atomic rename to the part path — a part
    file must never be visible half-written (other hosts gate the concat
    on part existence)."""
    return f"{output_path}.seg{seg_idx:04d}.tmp.mp4"


def plan_segments(total_frames: int, segment_size: int,
                  completed: Set[int]) -> List[Tuple[int, int, int]]:
    """[(seg_idx, start_frame, end_frame)] for segments still to process."""
    if segment_size <= 0:
        raise ValueError("segment_size must be positive")
    out = []
    seg = 0
    start = 0
    while start < total_frames:
        end = min(start + segment_size, total_frames)
        if seg not in completed:
            out.append((seg, start, end))
        seg += 1
        start = end
    return out


def n_segments(total_frames: int, segment_size: int) -> int:
    return (total_frames + segment_size - 1) // segment_size


def load_manifest(output_path: str, expect: Dict,
                  host_index: int = 0) -> Set[int]:
    """Completed segment indices recorded by ONE host, if its manifest
    matches this job's parameters (otherwise start fresh)."""
    p = manifest_path(output_path, host_index)
    if not os.path.exists(p):
        return set()
    try:
        data = json.loads(Path(p).read_text())
    except Exception:
        return set()
    for k, v in expect.items():
        if data.get(k) != v:
            return set()
    done = set(int(i) for i in data.get("completed", []))
    # Only trust segments whose part files still exist.
    return {i for i in done if os.path.exists(segment_part_path(output_path, i))}


def load_all_manifests(output_path: str, expect: Dict,
                       host_count: int = 1) -> Set[int]:
    """Union of every host's completed segments (part files verified)."""
    done: Set[int] = set()
    for k in range(max(host_count, 1)):
        done |= load_manifest(output_path, expect, host_index=k)
    return done


def save_manifest(output_path: str, expect: Dict, completed: Set[int],
                  host_index: int = 0):
    data = dict(expect)
    data["completed"] = sorted(completed)
    p = manifest_path(output_path, host_index)
    tmp = p + ".tmp"
    Path(tmp).write_text(json.dumps(data, indent=2))
    os.replace(tmp, p)


def all_parts_present(output_path: str, total_segments: int) -> bool:
    return all(os.path.exists(segment_part_path(output_path, i))
               for i in range(total_segments))


def concat_segments(output_path: str, total_segments: int,
                    source_path: Optional[str] = None) -> bool:
    """Concatenate part files (stream copy) and map the original audio and
    subtitles; removes parts + manifest on success."""
    from dither_pie_tpu_torch.pipeline.ffio import FFMPEG

    parts = [segment_part_path(output_path, i) for i in range(total_segments)]
    if not all(os.path.exists(p) for p in parts):
        return False
    list_path = output_path + ".concat.txt"
    Path(list_path).write_text(
        "".join(f"file '{os.path.abspath(p)}'\n" for p in parts))
    cmd = [FFMPEG, "-y", "-f", "concat", "-safe", "0", "-i", list_path]
    if source_path:
        cmd += ["-i", source_path, "-map", "0:v:0", "-map", "1:a?",
                "-map", "1:s?", "-c:v", "copy", "-c:a", "copy", "-c:s", "copy"]
    else:
        cmd += ["-c", "copy"]
    cmd += ["-v", "error", output_path]
    ok = subprocess.run(cmd).returncode == 0
    if ok:
        for p in parts:
            try:
                os.remove(p)
            except OSError:
                pass
        import glob

        # All hosts' manifests (multi-host jobs write .resume.hK.json).
        # glob.escape: output names may contain glob metacharacters.
        for p in [list_path] + glob.glob(glob.escape(output_path)
                                         + ".resume*.json"):
            try:
                os.remove(p)
            except OSError:
                pass
    return ok
