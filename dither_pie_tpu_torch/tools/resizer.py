"""Aspect-preserving NEAREST resizer for images and videos (the original
application's misc/resizer.py; a copy of ``dither_pie_tpu/tools/resizer.py``
over the port's ``pipeline/ffio.py`` and ``utils.py``). Even output
dimensions; video audio/subtitles stream-copied. Run:
``python -m dither_pie_tpu_torch.tools.resizer in out size``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from PIL import Image

from dither_pie_tpu_torch.pipeline.ffio import FFMPEG, ffmpeg_available
from dither_pie_tpu_torch.utils import (compute_even_dimensions,
                                        validate_image_file, validate_video_file)


def resize_image(in_path: str, out_path: str, max_size: int):
    img = Image.open(in_path).convert("RGB")
    w, h = compute_even_dimensions(img.size[0], img.size[1], max_size)
    img.resize((w, h), Image.Resampling.NEAREST).save(out_path)


def resize_video(in_path: str, out_path: str, max_size: int) -> bool:
    if not ffmpeg_available():
        print("ffmpeg not found on PATH", file=sys.stderr)
        return False
    # neighbor flag = NEAREST scaling; even dims enforced by -2 rounding.
    vf = (f"scale='if(gt(iw,ih),-2,{max_size})':'if(gt(iw,ih),{max_size},-2)'"
          f":flags=neighbor")
    cmd = [FFMPEG, "-y", "-i", in_path, "-vf", vf,
           "-c:v", "libx264", "-crf", "18", "-pix_fmt", "yuv420p",
           "-c:a", "copy", "-c:s", "copy", "-v", "error", out_path]
    return subprocess.run(cmd).returncode == 0


def main():
    ap = argparse.ArgumentParser(description="NEAREST resize (even dims)")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("max_size", type=int)
    args = ap.parse_args()
    if validate_image_file(args.input):
        resize_image(args.input, args.output, args.max_size)
    elif validate_video_file(args.input):
        if not resize_video(args.input, args.output, args.max_size):
            sys.exit(1)
    else:
        print(f"Unsupported or missing input: {args.input}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
