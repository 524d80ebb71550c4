"""Side-by-side video compositor (the original application's
misc/vid_conc.py; a copy of ``dither_pie_tpu/tools/vid_conc.py`` over the
port's ``pipeline/ffio.py``).

Two-stage ffmpeg flow: sanitize each input (re-encode to a common fps /
pixel format), then hstack/vstack with neighbor scaling and optional audio
amerge. Run:
``python -m dither_pie_tpu_torch.tools.vid_conc a.mp4 b.mp4 out.mp4``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

from dither_pie_tpu_torch.pipeline.ffio import FFMPEG, ffmpeg_available, probe_video


def sanitize_cmd(src: str, dst: str, fps: float, height: int):
    """Stage-1 sanitize: re-encode to a common fps / even height. NEIGHBOR
    scaling preserves pixel-art sharpness (the original application's
    explicit goal)."""
    # -ac 2: normalize to stereo so the stage-2 pan downmix (which addresses
    # channels c0..c3) is valid even for mono sources.
    return [FFMPEG or "ffmpeg", "-y", "-i", src,
            "-vf", f"scale=-2:{height}:flags=neighbor,fps={fps:.5f}",
            "-c:v", "libx264", "-preset", "fast", "-crf", "18",
            "-pix_fmt", "yuv420p", "-c:a", "aac", "-ac", "2",
            "-v", "error", dst]


def combine_cmd(clean, output: str, vertical: bool, merge_audio: bool):
    """Stage-2 combine: hstack/vstack; for two inputs, the original
    application's exact stereo downmix (`amerge,pan=stereo|c0<c0+c2|c1<c1+c3`);
    for more, amerge + -ac 2."""
    n = len(clean)
    stack = "vstack" if vertical else "hstack"
    fc = "".join(f"[{i}:v]" for i in range(n)) + f"{stack}=inputs={n}[v]"
    maps = ["-map", "[v]"]
    if merge_audio:
        fc += ";" + "".join(f"[{i}:a]" for i in range(n)) + \
              f"amerge=inputs={n}"
        if n == 2:
            fc += ",pan=stereo|c0<c0+c2|c1<c1+c3[a]"
            maps += ["-map", "[a]"]
        else:
            fc += "[a]"
            maps += ["-map", "[a]", "-ac", "2"]
    cmd = [FFMPEG or "ffmpeg", "-y"]
    for c in clean:
        cmd += ["-i", c]
    cmd += ["-filter_complex", fc, *maps,
            "-c:v", "libx264", "-crf", "18", "-pix_fmt", "yuv420p",
            "-v", "error", output]
    return cmd


def concat_side_by_side(inputs, output: str, vertical: bool = False,
                        merge_audio: bool = True) -> bool:
    if not ffmpeg_available():
        print("ffmpeg not found on PATH", file=sys.stderr)
        return False
    infos = [probe_video(p) for p in inputs]
    fps = max(i["fps"] for i in infos)
    height = min(i["height"] for i in infos)
    height -= height % 2
    with tempfile.TemporaryDirectory() as td:
        clean = []
        for i, src in enumerate(inputs):
            dst = str(Path(td) / f"clean_{i}.mp4")
            subprocess.run(sanitize_cmd(src, dst, fps, height), check=True)
            clean.append(dst)
        try:
            subprocess.run(combine_cmd(clean, output, vertical, merge_audio),
                           check=True)
        except subprocess.CalledProcessError:
            # Retry without audio (inputs may be silent).
            subprocess.run(combine_cmd(clean, output, vertical, False),
                           check=True)
    return True


def main():
    ap = argparse.ArgumentParser(description="Stack videos side by side")
    ap.add_argument("inputs", nargs="+", help="input videos (last arg = output)")
    ap.add_argument("--vertical", action="store_true")
    ap.add_argument("--no-audio", action="store_true")
    args = ap.parse_args()
    if len(args.inputs) < 3:
        ap.error("need at least two inputs and one output")
    *ins, out = args.inputs
    ok = concat_side_by_side(ins, out, vertical=args.vertical,
                             merge_audio=not args.no_audio)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
