"""The controls of the neural stream's check, and the readings its limits
are set from.

    python3 portbench/neural_control.py --seeds 1,2,3 [--frames 16] [--out FILE]

For each seed, on the first ``--frames`` frames of the cell's pool (the
frames a run hands over first), against the reference's float32
pixelization of the same frames (``references/pixelization.py``):

* ``program``: the program's pixelizer as a run installs it, through its
  first-batch gates, in batches of the traffic's size (the lower reading);
* ``program_float32``: the same with ``DITHER_PIE_TPU_NEURAL_PRECISION``
  set to float32 (the configuration one precision up: it must pass with
  margin);
* ``reference_float8``: the reference with every conv's and linear's
  operands rounded through float8_e4m3fn, the precision below the
  configuration's bfloat16 (the upper reading: it must fail);
* ``reference_no_aliasnet``: the reference without AliasNet (must fail).

Each prints the worst frame's mean |u8 delta|, the largest delta, and the
worst frame's share of pixels with a channel more than 1, 2, 3, 4, 8 and 16
steps off. Then ``mismatch_share`` of the program's dither of its own
pixelized frames with one palette colour (the one the reference's dither
uses most) altered by 8, against the
reference's dither with the reference's palette (must fail), and with the
palette as the program builds it (must pass). The benchmark's own runs run
none of this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import frames as frame_gen  # noqa: E402
from portbench.cells import find_cell, load_benchmark  # noqa: E402
from portbench.references import pixelization as ref  # noqa: E402

WORKLOAD = "pix128-atk-km16.neural-stream-1080p"
STEPS = (1, 2, 3, 4, 8, 16)


def deltas(got: np.ndarray, want: np.ndarray) -> dict:
    """The worst frame's mean |delta| and far shares, and the largest delta."""
    if got.shape != want.shape:
        return {"shape": [list(got.shape), list(want.shape)]}
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    far = d.max(-1).reshape(len(d), -1)
    return {"mean": float(d.reshape(len(d), -1).mean(1).max()), "max": int(d.max()),
            **{f"far{s}": float((far > s).mean(1).max()) for s in STEPS}}


def program_pixelized(config: dict, frames: np.ndarray, batch: int, device: torch.device,
                      precision: str = None) -> tuple:
    """The program's pixelized frames through a fresh model's gates, and
    the gates' verdicts."""
    from PIL import Image

    from dither_pie_tpu_torch.models.inference import PixelizationModel
    from dither_pie_tpu_torch.models.pixelizer import NeuralPixelizer

    if precision:
        os.environ["DITHER_PIE_TPU_NEURAL_PRECISION"] = precision
    try:
        model = PixelizationModel(device=device)
        model.load_random(int(config["neural"]["weights_seed"]))
        pix = NeuralPixelizer.from_model(model)
        max_size = int(config["pixelization"]["max_size"])
        out = []
        for lo in range(0, len(frames), batch):
            images = [Image.fromarray(f) for f in frames[lo:lo + batch]]
            out += [np.array(o.convert("RGB")) for o in pix.pixelize_batch(images, max_size)]
    finally:
        os.environ.pop("DITHER_PIE_TPU_NEURAL_PRECISION", None)
    return np.stack(out), {"precision": model._video_prec, "ds4_stride": model._ds4_stride}


def readings(cell, seed: int, n_frames: int, device: torch.device) -> dict:
    from PIL import Image

    from dither_pie_tpu_torch.api.ditherer import ImageDitherer
    from dither_pie_tpu_torch.pipeline.image import build_ditherer

    config, traffic = cell.config, cell.traffic
    pool = frame_gen.make_pool(traffic, seed, device)
    frames = pool[:n_frames]
    batch = int(traffic["batch"])
    want = ref.pixelize(frames, config, device)
    out = {"workload": cell.name, "seed": seed, "frames": len(frames)}
    port, gates = program_pixelized(config, frames, batch, device)
    out["gates"] = gates
    out["program"] = deltas(port, want)
    port32, gates32 = program_pixelized(config, frames, batch, device, "float32")
    out["program_float32"] = {**deltas(port32, want), "gates": gates32}
    out["reference_float8"] = deltas(ref.pixelize(frames, config, device,
                                                  torch.float8_e4m3fn), want)
    out["reference_no_aliasnet"] = deltas(ref.pixelize(frames, config, device, alias=False),
                                          want)

    ref_pal = ref.palette(pool[0], config, device)
    expected = ref.dither(port, ref_pal, config, device)
    program = build_ditherer(config, Image.fromarray(pool[0]), device)
    altered = np.asarray(program.palette, dtype=np.int64)
    # The colour the reference's dither uses most: the pixelized frames lie
    # near one grey, so most colours of the palette go unused.
    used = (expected.reshape(-1, 1, 3) == ref_pal[None].astype(np.uint8)).all(-1).sum(0)
    k = int(used.argmax())
    altered[k, 0] += 8 if altered[k, 0] < 128 else -8
    for name, pal in (("palette_program", program.palette),
                      ("palette_altered", [tuple(map(int, c)) for c in altered])):
        ditherer = ImageDitherer(num_colors=len(pal), dither_mode=program.dither_mode,
                                 palette=pal, dither_params=program.dither_params,
                                 device=device)
        got = ditherer.apply_dithering_batch(port)
        out[f"mismatch_share_{name}"] = float(
            np.any(got != expected, axis=-1).reshape(len(got), -1).mean(1).max())
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = find_cell(load_benchmark(), WORKLOAD)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(cell, seed, args.frames, dev))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
