#!/usr/bin/env python3
"""R1 of this checkout against R1 of another (a parent), in turns on one card.

    python3 dither_pie_tpu_torch/tools/riemersma_turns.py --parent DIR

DIR is another checkout of the repository (for instance ``git archive`` of
the parent commit unpacked into a directory that ``.gitignore`` lists). The
tool runs, in the order parent, this checkout, this checkout, parent, each
checkout's own ``tools/riemersma_ab.py`` (with ``--latency`` where that
checkout's tool has it) and then this file with ``--tree`` on that checkout:
R1 (``ops.riemersma_scan.riemersma_scan`` of that checkout, its kernels
built there) timed by CUDA events at

* phase 23's batch: 16 ``chip_smoke.synth_image(1080, 1920, 10 + i)``
  frames, u8, the k-means-32 palette of ``synth_image(1080, 1920, 0)``;
* 16 random u8 1080p frames at 256 distinct random colours, and 4 at 300
  and at 1024 (the register forms and the shared-memory form);
* 132 and 264 random u8 1080p frames a launch at k-means-32;

each line with ms, microseconds a curve step and an md5 prefix of the
output, which must agree between the checkouts. Every process builds (or
finds built) its checkout's kernels first; the card's name and power limit
end each line.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
H, W = 1080, 1920


def time_tree(tree: Path, label: str) -> None:
    """The timings above with ``tree``'s package and ``chip_smoke``."""
    sys.path[:] = [str(tree)] + [q for q in sys.path if Path(q or ".").resolve() != HERE.parent]
    import numpy as np
    import torch
    from PIL import Image

    import chip_smoke as cs
    import dither_pie_tpu_torch as dpt
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.ops import riemersma_scan as rs

    if not Path(rs.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"{rs.__file__} is not in {tree}")
    dev = torch.device("cuda")
    card = cs.card_line()
    t0 = time.perf_counter()
    build.extension()
    print(f"[{label}] kernels built in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    def timed(what, frames, pal, reps):
        ms, out = cs.cuda_ms(torch, lambda: rs.riemersma_scan(frames, pal), reps)
        digest = hashlib.md5(out.cpu().numpy().tobytes()).hexdigest()[:12]
        print(f"[{label}] {what}: {ms:.3f} ms, {ms * 1e3 / (H * W):.5f} us a step, "
              f"out {digest} [{card}]", flush=True)

    frames16 = torch.from_numpy(
        np.stack([cs.synth_image(H, W, 10 + i) for i in range(16)])).to(dev)
    pal32 = torch.from_numpy(np.asarray(dpt.ColorReducer.generate_kmeans_palette(
        Image.fromarray(cs.synth_image(H, W, 0)), 32, device=dev), np.float32)).to(dev)
    rs.device_maps(H, W, dev)
    timed("16x1080p u8 k-means-32 (phase 23's batch)", frames16, pal32, 3)
    del frames16
    rng = np.random.RandomState(21)
    colours = np.unique(rng.randint(0, 256, (4096, 3)), axis=0)
    for p, b, reps in ((256, 16, 3), (300, 4, 3), (1024, 4, 1)):
        pal = torch.from_numpy(colours[rng.permutation(len(colours))[:p]].astype(np.float32))
        frames = torch.from_numpy(rng.randint(0, 256, (b, H, W, 3)).astype(np.uint8))
        timed(f"{b}x1080p u8 random, {p} colours", frames.to(dev), pal.to(dev), reps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    for b in (132, 264):
        frames = torch.randint(0, 256, (b, H, W, 3), dtype=torch.uint8, device=dev,
                               generator=gen)
        timed(f"{b} frames a launch, u8 k-means-32", frames, pal32, 2)
        del frames


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="the other checkout")
    parser.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--label", default="change", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.tree is not None:
        time_tree(args.tree.resolve(), args.label)
        return 0
    if args.parent is None:
        parser.error("--parent DIR is required")
    change = HERE.parents[2]
    for tree, label in ((args.parent.resolve(), "parent"), (change, "change"),
                        (change, "change"), (args.parent.resolve(), "parent")):
        tool = tree / "dither_pie_tpu_torch" / "tools" / "riemersma_ab.py"
        extra = ["--latency"] if "--latency" in tool.read_text() else []
        print(f"=== {label}: tools/riemersma_ab.py {' '.join(extra)}", flush=True)
        subprocess.run([sys.executable, "-m", "dither_pie_tpu_torch.tools.riemersma_ab",
                        *extra], cwd=tree, check=True)
        print(f"=== {label}: R1 timings", flush=True)
        subprocess.run([sys.executable, str(HERE), "--tree", str(tree), "--label", label],
                       cwd=tree, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
