#!/usr/bin/env python3
"""Device time of the error-diffusion path of one checkout, for comparing
two checkouts on one card.

    python3 dither_pie_tpu_torch/tools/time_ed_path.py [TREE]

TREE is the root of a checkout that holds ``dither_pie_tpu_torch`` (default:
the checkout this script lies in). It builds that tree's kernels, then times
Floyd-Steinberg error diffusion to 32 colours on 16 distinct 1080p uint8
frames already on the card: the whole device path
(``ops.wavefront.ed_batch_wavefront``: skew, scan, unskew) and the scan
kernel alone, each as (median, min, max) milliseconds of 9 runs between
CUDA events after one warm-up, twice. It prints the card's name and power
limit first. To compare a parent commit with a change, run parent, change,
change, parent one after another on one card: two cards with the same
power limit have differed by more than a quarter.

It needs a CUDA device and fails without one. The frames and the palette
are random (seeded): the scan's time does not depend on the data.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def main() -> int:
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parents[2]).resolve()
    sys.path.insert(0, str(tree))
    import torch

    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.ops import wavefront as twf

    if not torch.cuda.is_available():
        print("time_ed_path: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    build.extension()
    print(f"{tree}: kernels built in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        rng.randint(0, 256, (16, 1080, 1920, 3)).astype(np.uint8)).to(dev)
    pal = torch.from_numpy(rng.randint(0, 256, (32, 3)).astype(np.float32)).to(dev)
    geom = twf.scan_geometry("floyd_steinberg")
    stream = twf.skew(frames, geom.s)

    def ms(fn, reps=9):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return tuple(round(t, 3) for t in (statistics.median(times), min(times), max(times)))

    for _ in range(2):
        path = ms(lambda: twf.ed_batch_wavefront(frames, pal))
        scan = ms(lambda: twf.scan(stream, pal, geom, 1920))
        print(f"{tree}: FS 32 colours, 16 x 1080p u8: device path ms (median, min, max) "
              f"{path}; scan kernel {scan} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
