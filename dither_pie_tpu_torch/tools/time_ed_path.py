#!/usr/bin/env python3
"""Device time of the error-diffusion path of one checkout, for comparing
two checkouts on one card, and the scan's cluster-size sweep.

    python3 dither_pie_tpu_torch/tools/time_ed_path.py [TREE] [--sweep]

TREE is the root of a checkout that holds ``dither_pie_tpu_torch`` (default:
the checkout this script lies in). It builds that tree's kernels, then times
on 16 distinct random uint8 frames already on the card, each as (median,
min, max) milliseconds of CUDA events after one warm-up:

* Floyd-Steinberg to 32 colours at 1080p: the whole device path
  (``ops.wavefront.ed_batch_wavefront``: skew, scan, unskew), 9 runs;
* the scan K2 alone at 32, 64, 256 and 1024 colours (1080p; Floyd-Steinberg,
  and at 32 colours also ostromoukhov, hybrid, perceptual and adaptive with
  random gates; at 256 and 1024 colours also the score search) and K8 at
  2048 colours (480p), 3 runs each, with the microseconds a wavefront step;
* K2 at 32 colours on 1024 and on 1080 rows (1920 wide), the microseconds a
  step of each: whether the rows a block of 1024 threads takes in a second
  pass cost anything;
* the ends of the path alone at 1080p, 9 runs each: the skew K1
  (``skew_gather``) of the uint8 frames beside K7 (``skew_transpose``) and
  K6 (``skew_planar_gather``, on the frames' planes) on the same frames, K1
  on the frames as float32, and the unskew K3 (``unskew_unpack``) of the
  32-colour scan's output in both layouts; K1's stream is held to K7's and
  K6's bitwise.

Every line carries the cluster size the launch ran with ("n"; "-" for a
tree whose scan has no clusters). It prints the card's name and power
limit first. To compare a parent commit with a change, run parent, change,
change, parent one after another in one call on one card: two cards with
the same power limit have differed by more than a quarter.

``--sweep`` (a tree with clusters only) also times the scan at every
cluster size n in (1, 2, 4, 8) at P in (32, 64, 256, 1024) (K2, 1080p) and
P = 2048 (K8, 480p), 3 runs each, on 8 of the frames (8 clusters of 8
blocks are resident together, 16 are not), holds each output to the n = 1
output bitwise, and fits t(P, n) / D = c_n + k_n * P / n by least squares
per n: c_n - c_1 is what the cluster barrier and the merge add to a step.

It needs a CUDA device and fails without one. Frames and palettes are
random (seeded): the scan's time does not depend on the data.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SIZES = (32, 64, 256, 1024)
MODES = ("ostromoukhov", "hybrid", "perceptual", "adaptive")
SWEEP_SIZES = (32, 64, 256, 1024, 2048)
CLUSTER_SIZES = (1, 2, 4, 8)


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    sweep = "--sweep" in sys.argv[1:]
    tree = Path(args[0] if args else Path(__file__).parents[2]).resolve()
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
    clusters = hasattr(twf, "launch_plan")

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        rng.randint(0, 256, (16, 1080, 1920, 3)).astype(np.uint8)).to(dev)
    sd = torch.from_numpy(rng.randint(0, 256, (16, 480, 854, 3)).astype(np.uint8)).to(dev)
    pals = {p: torch.from_numpy(rng.randint(0, 256, (p, 3)).astype(np.float32)).to(dev)
            for p in sorted(set(SWEEP_SIZES + SIZES))}
    geom = twf.scan_geometry("floyd_steinberg")
    stream = twf.skew(frames, geom.s)
    sd_stream = twf.skew(sd, geom.s)

    def ms(fn, reps):
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

    def scan_line(label, s, pal, emit_idx, width, g=geom, aux=None, search="exact"):
        fn = twf.scan_idx if emit_idx else twf.scan
        t = ms(lambda: fn(s, pal, g, width, aux, search), 3)
        us = t[0] * 1e3 / s.shape[0]
        n = twf.launch_plan(s, pal, g, emit_idx, search).n if clusters else "-"
        print(f"{tree}: {label}, 16 frames: ms {t}, {us:.4f} us a step, n {n} [{card}]",
              flush=True)

    gates = torch.from_numpy((rng.rand(16, 1080, 1920) < 0.5).astype(np.float32)).to(dev)
    auxes = {"perceptual": twf.perceptual_sensitivity(frames), "adaptive": gates}

    for _ in range(2):
        path = ms(lambda: twf.ed_batch_wavefront(frames, pals[32]), 9)
        print(f"{tree}: FS 32 colours, 16 x 1080p u8: device path ms (median, min, max) "
              f"{path} [{card}]", flush=True)
        for p in SIZES:
            scan_line(f"K2 FS P={p} 1080p", stream, pals[p], False, 1920)
        scan_line("K8 FS P=2048 480p", sd_stream, pals[2048], True, 854)
        for mode in MODES:
            g = twf.scan_geometry("", mode)
            scan_line(f"K2 {mode} P=32 1080p", twf.skew(frames, g.s), pals[32], False, 1920,
                      g, auxes.get(mode))
        for p in (256, 1024):
            scan_line(f"K2 FS P={p} 1080p score search", stream, pals[p], False, 1920,
                      search="mxu")
    for h in (1024, 1080):
        s = stream if h == 1080 else twf.skew(frames[:, :h].contiguous(), geom.s)
        scan_line(f"K2 FS P=32 {h} rows x 1920", s, pals[32], False, 1920)

    planes = frames.permute(3, 0, 1, 2).contiguous().view(48, 1080, 1920)
    col = twf.scan(stream, pals[32], geom, 1920)
    ends = {"K1 skew u8": lambda: twf.skew_gather(frames, geom.s),
            "K7 skew_transpose u8": lambda: twf.skew_transpose(frames, geom.s),
            "K6 skew_planar u8": lambda: twf.skew_planar_gather(planes, geom.s),
            "K3 unskew_unpack NHWC": lambda: twf.unskew_unpack(col, geom.s, 1080, 1920),
            "K3 unskew_unpack planar": lambda: twf.unskew_unpack(col, geom.s, 1080, 1920, True)}
    for label, fn in ends.items():
        print(f"{tree}: {label}, 16 x 1080p FS: ms {ms(fn, 9)} [{card}]", flush=True)
    k1 = twf.skew_gather(frames, geom.s)
    for other in ("K7 skew_transpose u8", "K6 skew_planar u8"):
        if not torch.equal(k1, ends[other]()):
            print(f"{tree}: K1's stream != {other}'s", file=sys.stderr)
            return 1
    del k1, planes, col
    frames_f32 = frames.to(torch.float32)
    print(f"{tree}: K1 skew float32, 16 x 1080p FS: ms "
          f"{ms(lambda: twf.skew_gather(frames_f32, geom.s), 9)} [{card}]", flush=True)
    del frames_f32

    if sweep:
        if not clusters:
            print(f"{tree}: --sweep needs a scan with clusters", file=sys.stderr)
            return 2
        rows = []
        stream8 = twf.skew(frames[:8].contiguous(), geom.s)
        sd_stream8 = twf.skew(sd[:8].contiguous(), geom.s)
        for p in SWEEP_SIZES:
            emit_idx = p > twf.PACKED_PALETTE_MAX
            s, width = (sd_stream8, 854) if emit_idx else (stream8, 1920)
            ref = None
            for n in CLUSTER_SIZES:
                plan = twf.launch_plan(s, pals[p], geom, emit_idx, n=n)
                run = lambda: twf.launch_scan(s, pals[p], geom, width, None, emit_idx,
                                              "exact", n)
                t = ms(run, 3)
                out = run()
                if ref is None:
                    ref = out
                same = bool(torch.equal(out, ref))
                del out
                us = t[0] * 1e3 / s.shape[0]
                rows.append((p, n, us, s is stream8))
                print(f"{tree}: sweep {'K8' if emit_idx else 'K2'} P={p} n={n}, 8 frames: ms {t}, "
                      f"{us:.4f} us a step, hist in shared memory {plan.hist_smem}, "
                      f"== n=1 {same} [{card}]", flush=True)
                if not same:
                    print(f"{tree}: n={n} output differs from n=1 at P={p}", file=sys.stderr)
                    return 1
        for n in CLUSTER_SIZES:
            pts = [(p / n, us) for p, m, us, k2 in rows if m == n and k2]
            x = np.array([a for a, _ in pts])
            y = np.array([b for _, b in pts])
            k, c = np.polyfit(x, y, 1)
            print(f"{tree}: fit K2 1080p n={n}: {c:.4f} us + {k:.5f} us x P/n a step "
                  f"(max residual {np.abs(c + k * x - y).max():.4f} us) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
