"""The control of the check, and the readings its limits are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--frames N]
    python3 portbench/control.py --palette --workload <cell> --seeds 1,2,...

Without ``--palette``, for each seed: the cell's frame pool and palette as
a run makes them, the float32 reference of the first ``--frames`` pool
frames (all by default, as many distinct inputs as a full run compares),
and the same reference computed in bfloat16, the nearest precision below
the configuration's float32. It prints, a line a seed, the worst share of
pixels that differ from the float32 reference, beside the configuration's
limit: the upper reading of ``mismatch_share``.

With ``--palette``, for each seed, the numbers the check compares about a
palette (``palette_diff`` against the float32 reference's palette, and
``palette_lloyd_gap``) for: the program's own palette (the lower reading),
the reference's k-means in bfloat16 (the control), the reference with its
Lloyd steps returning their state unchanged (the kmeans++ seeds alone),
and the reference's palette with one colour altered by 8 in one channel.
The benchmark's own runs run neither.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import frames as frame_gen  # noqa: E402
from portbench.cells import Cell, find_cell, load_benchmark, load_module  # noqa: E402


def control_readings(cell: Cell, seed: int, device: torch.device,
                     n_frames: int = 0) -> dict:
    """The control's ``mismatch_share`` (worst frame) against the float32
    reference on ``n_frames`` of the seed's pool (all when 0)."""
    config = cell.config
    ref = load_module("references", config["reference"])
    pool = frame_gen.make_pool(cell.traffic, seed, device)
    pal = ref.palette(pool[0], config, device)
    frames = pool[:n_frames or len(pool)]
    t = time.perf_counter()
    exact = ref.outputs(frames, pal, config, device, torch.float32)
    ref_s = time.perf_counter() - t
    low = ref.outputs(frames, pal, config, device, torch.bfloat16)
    shares = np.any(low != exact, axis=-1).reshape(len(frames), -1).mean(axis=1)
    return {"workload": cell.name, "seed": seed, "frames": len(frames),
            "mismatch_share": float(shares.max()), "mismatch_share_min": float(shares.min()),
            "limit": float(config["limits"]["mismatch_share"]), "reference_s": ref_s}


def palette_readings(cell: Cell, seed: int, device: torch.device,
                     with_program: bool = True) -> dict:
    """``palette_checks`` of the program's palette, of the bfloat16 control
    and of two planted faults, on the seed's frame 0."""
    from portbench.references import error_diffusion as ed

    config = cell.config
    ref = load_module("references", config["reference"])
    frame0 = frame_gen.make_pool(cell.traffic, seed, device)[0]
    ref_pal = ref.palette(frame0, config, device)
    km = config["kmeans"]
    k = int(config["palette"]["num_colors"])
    altered = ref_pal.copy()
    altered[k // 2, 0] = altered[k // 2, 0] + 8 if altered[k // 2, 0] < 128 else \
        altered[k // 2, 0] - 8
    palettes = {
        "reference": ref_pal,
        "control_bf16": ed.kmeans_palette(frame0, k, km["random_state"], km["sample_cap"],
                                          km["iters"], device, torch.bfloat16),
        "fault_state_unchanged": ed.kmeans_palette(frame0, k, km["random_state"],
                                                   km["sample_cap"], 0, device),
        "fault_colour_altered": altered,
    }
    if with_program:
        from portbench.kinds import build_system
        palettes["program"] = build_system(config, frame0, device).palette
    out = {"workload": cell.name, "seed": seed}
    for name, pal in palettes.items():
        out[name] = ref.palette_checks(frame0, pal, ref_pal, config)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--palette", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    bench = load_benchmark()
    dev = torch.device("cuda", 0)
    for name in args.workload:
        cell = find_cell(bench, name)
        for seed in (int(s) for s in args.seeds.split(",")):
            r = (palette_readings(cell, seed, dev) if args.palette
                 else control_readings(cell, seed, dev, args.frames))
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
