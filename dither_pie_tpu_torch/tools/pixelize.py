"""Standalone neural-pixelization command (the original application's
pixelize_cli; the port of ``dither_pie_tpu/tools/pixelize.py`` over
``models/inference.PixelizationModel``):

    python -m dither_pie_tpu_torch.tools.pixelize --input img.png [--output out.png]
        [--target_size N] [--ckpt_dir DIR] [--device cuda|cpu]

The nets run on ``--device`` (``cuda``, the default: a machine without a
card raises; ``cpu`` for the CPU), the one argument the JAX tool lacks.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Neural pixelization (C2PGen on PyTorch)")
    ap.add_argument("--input", required=True, help="image or directory")
    ap.add_argument("--output", help="output image or directory")
    ap.add_argument("--target_size", type=int, default=0,
                    help="target size for the smaller side (0 = native x4 flow)")
    ap.add_argument("--ckpt_dir", help="checkpoint directory "
                                       "(default: $DITHER_PIE_TPU_CKPT_DIR or cwd)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device the nets run on (default cuda; a machine "
                         "without a card raises)")
    args = ap.parse_args(argv)

    from PIL import Image

    from dither_pie_tpu_torch.models.inference import (PixelizationModel, deprocess,
                                                       process, resize_image_nearest)

    pairs = []
    if os.path.isdir(args.input):
        images = sorted(glob.glob(os.path.join(args.input, "*.png"))
                        + glob.glob(os.path.join(args.input, "*.jpg")))
        out_dir = args.output or os.path.join(args.input, "outputs")
        os.makedirs(out_dir, exist_ok=True)
        pairs = [(p, os.path.join(out_dir, os.path.basename(p))) for p in images]
    elif os.path.isfile(args.input):
        if args.output:
            out = args.output
            if os.path.isdir(out):
                out = os.path.join(out, os.path.basename(args.input))
        else:
            base, ext = os.path.splitext(args.input)
            out = f"{base}_pixelized{ext}"
        pairs = [(args.input, out)]
    else:
        print(f"input not found: {args.input}", file=sys.stderr)
        return 1

    model = PixelizationModel(checkpoint_dir=args.ckpt_dir, device=args.device)
    model.load()

    for src, dst in pairs:
        print(f"PROCESSING {src} -> {dst}")
        img = Image.open(src).convert("RGB")
        if args.target_size > 0:
            img = resize_image_nearest(img, args.target_size * 4)
            result = deprocess(model.forward_array(process(img)))
            result = resize_image_nearest(result, args.target_size)
        else:
            result = deprocess(model.forward_array(process(img)))
        result.save(dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
