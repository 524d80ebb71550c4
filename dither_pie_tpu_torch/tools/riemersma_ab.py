#!/usr/bin/env python3
"""A/B: the Riemersma scan R1 on the card against the host engine.

    python -m dither_pie_tpu_torch.tools.riemersma_ab [--device cuda] [--quick] [--seed S]

The port's counterpart of the JAX package's ``tools/riemersma_ab.py``: the
same shapes, (240, 320) x 8, (480, 640) x 8 and (1080, 1920) x 4 frames,
and the same palette, 16 distinct colours from ``RandomState(seed)`` (the
frames follow from the same generator), plus (1080, 1920) x 16, the video
batch; ``--quick`` keeps the first shape. For each shape it prints:

* the scan's fps (``ops.riemersma_scan.riemersma_scan`` on the frames
  already on the device; median of 3 after a warm-up, CUDA events on a
  CUDA device, the host clock around the plain version on the CPU);
* the host engine's fps, wall time of the facade's batch path without the
  switch (``api.ditherer._host_batch`` of ``ed_host.ed_riemersma_fast``:
  the float32 twin, one thread a frame, ``DITHER_PIE_TPU_NATIVE_THREADS``
  at most), median of 3;
* the scan's identity against the host engine, per frame (its minimum);
* the scan's microseconds a curve step: its time over the N steps of one
  frame's chain (the frames run side by side).

Then, on a CUDA device and without ``--quick``: 16 frames at 1080p against
256 distinct random colours (a GIF palette; R1's register search), and the
frames-a-launch sweep of the scan alone at 1080p: B = 4, 16, 66, 132 and
264 random uint8 frames made on the card (264: two chains an SM), fps and
microseconds a step, the first and last frame held to the host engine. The
maps of each shape are built before any timing (their time is printed
apart). The card's name and power limit head the output.

``--latency`` runs R1's latency probe first (``latency``: clock64 cycles of
each kind of instruction on the step's dependent path, and the SM clock
under load from ``%globaltimer``) and prints the chain estimate
``chain_us`` built from them.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":  # run as a script: find the package beside it
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from dither_pie_tpu_torch.api.ditherer import _host_batch, _native_thread_cap  # noqa: E402
from dither_pie_tpu_torch.api.runtime import resolve_device  # noqa: E402
from dither_pie_tpu_torch.ops import ed_host  # noqa: E402
from dither_pie_tpu_torch.ops import riemersma_scan as rs  # noqa: E402
from dither_pie_tpu_torch.tools.proto_mxu_search import card_line  # noqa: E402

SHAPES = ((240, 320, 8), (480, 640, 8), (1080, 1920, 4), (1080, 1920, 16))
SWEEP = (4, 16, 66, 132, 264)  # frames a launch at 1080p; 264: two chains an SM
REPS = 3


WIDE_COLOURS = 256  # the 256-colour shape's palette
LATENCY_ITERS = 2048
# The dependent path of one step of R1 at <= 32 colours on uint8 frames, by
# kind of instruction, as its SASS shows it (riemersma_scan.cu, NPL = 1):
# FADD, FMUL, FADD, FADD of the distance; REDUX.MIN of its bits and the move
# out of the uniform register; ISETP, VOTE and FLO of the lanes at the
# minimum; SHFL.IDX of the winning lane's candidate, which is the next
# step's working value.
STEP_PATH = {"fadd": 4, "redux": 1, "vote_flo": 1, "shfl": 1}
LATENCY_KINDS = ("fadd", "receive", "redux", "vote_flo", "shfl", "lds")


def latency(dev: torch.device, iters: int = LATENCY_ITERS) -> dict:
    """R1's latency probe on the card: cycles of one instruction (or
    group: ``receive`` is FADD, FMNMX, FMNMX; ``vote_flo`` ISETP, VOTE and
    FLO, the highest lane of a ballot; ``redux`` REDUX.MIN and the move of
    its uniform result) in a dependent chain of one warp, by kind, and the
    SM clock in GHz under the probe (clock64 cycles over %globaltimer
    nanoseconds). Counted in ``build.LAUNCHES["riemersma_latency"]``."""
    from dither_pie_tpu_torch.kernels import build

    if dev.type != "cuda":
        raise ValueError("the latency probe runs on the card only")
    out = torch.zeros(10, dtype=torch.int64, device=dev)
    build.extension().riemersma_latency(out, iters)
    build.count_launch("riemersma_latency")
    vals = out.cpu().tolist()
    n = vals[9]
    lat = {k: vals[i] / n for i, k in enumerate(LATENCY_KINDS)}
    lat["ghz"] = vals[6] / vals[7]
    return lat


def chain_us(lat: dict) -> float:
    """Microseconds of one step's dependent path (``STEP_PATH``) at the
    probe's latencies and clock."""
    return sum(lat[k] * n for k, n in STEP_PATH.items()) / lat["ghz"] * 1e-3


def palette16(rng: np.random.RandomState) -> np.ndarray:
    """The JAX tool's palette: the first 16 distinct of 40 random colours."""
    return np.unique(rng.randint(0, 256, (40, 3)), axis=0)[:16].astype(np.float32)


def scan_ms(frames: torch.Tensor, pal: torch.Tensor):
    """(median ms of ``riemersma_scan`` over REPS runs after a warm-up, the
    last output): CUDA events on the card, the host clock on the CPU."""
    rs.riemersma_scan(frames, pal)
    times = []
    out = None
    for _ in range(REPS):
        if frames.device.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = rs.riemersma_scan(frames, pal)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            out = rs.riemersma_scan(frames, pal)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def host_ms(images: np.ndarray, pal: np.ndarray):
    """(median wall ms of the facade's host-engine batch path, its uint8
    output)."""
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = _host_batch(ed_host.ed_riemersma_fast, images, pal)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out.astype(np.uint8)


def identity(a: np.ndarray, b: np.ndarray) -> float:
    """The smallest per-frame share of pixels equal in all 3 channels."""
    return float(min(np.all(x == y, axis=-1).mean() for x, y in zip(a, b)))


def maps_s(h: int, w: int, dev: torch.device) -> float:
    """Seconds to build the curve's maps for (h, w) and put them on dev."""
    t0 = time.perf_counter()
    rs.path_maps(h, w)
    if dev.type == "cuda":
        rs.device_maps(h, w, dev)
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (R1) or cpu (plain version)")
    parser.add_argument("--quick", action="store_true", help="only 240x320 x 8")
    parser.add_argument("--seed", type=int, default=0, help="seed of palette and frames")
    parser.add_argument("--latency", action="store_true",
                        help="run R1's latency probe first (card only)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu: plain version, host clock"
    print(f"riemersma_ab on {dev}: [{card}]; host engine on {_native_thread_cap()} "
          f"threads (os.cpu_count() {os.cpu_count()})", flush=True)
    if dev.type == "cuda":
        from dither_pie_tpu_torch.kernels import build

        t0 = time.perf_counter()
        build.extension()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
        if args.latency:
            lat = latency(dev)
            print("latency (cycles): " + ", ".join(f"{k} {lat[k]:.2f}" for k in LATENCY_KINDS)
                  + f"; SM clock {lat['ghz']:.4f} GHz; step path {STEP_PATH} -> "
                  f"{chain_us(lat):.5f} us a step [{card}]", flush=True)

    rng = np.random.RandomState(args.seed)
    pal = palette16(rng)
    pal_t = torch.from_numpy(pal).to(dev)
    for h, w, b in SHAPES[:1] if args.quick else SHAPES:
        images = rng.randint(0, 256, (b, h, w, 3)).astype(np.float32)
        built = maps_s(h, w, dev)
        n = h * w
        ms, out = scan_ms(torch.from_numpy(images).to(dev), pal_t)
        ref_ms, ref = host_ms(images, pal)
        ident = identity(out.cpu().numpy(), ref)
        print(f"{h}x{w} batch {b}: scan {b / ms * 1e3:.3f} fps ({ms:.3f} ms, "
              f"{ms * 1e3 / n:.5f} us a step), host engine {b / ref_ms * 1e3:.3f} fps "
              f"({ref_ms:.3f} ms) -> the scan is {ref_ms / ms:.3f}x the host; identity "
              f"{ident}; maps {built:.3f} s [{card}]", flush=True)
    if dev.type != "cuda" or args.quick:
        return 0
    h, w = 1080, 1920
    wide = np.unique(rng.randint(0, 256, (4 * WIDE_COLOURS, 3)), axis=0)
    wide = wide[rng.permutation(len(wide))[:WIDE_COLOURS]].astype(np.float32)
    images = rng.randint(0, 256, (16, h, w, 3)).astype(np.uint8)
    ms, out = scan_ms(torch.from_numpy(images).to(dev), torch.from_numpy(wide).to(dev))
    ref_ms, ref = host_ms(images, wide)
    print(f"{h}x{w} batch 16 uint8, {WIDE_COLOURS} colours: scan {16 / ms * 1e3:.3f} fps "
          f"({ms:.3f} ms, {ms * 1e3 / (h * w):.5f} us a step), host engine "
          f"{16 / ref_ms * 1e3:.3f} fps ({ref_ms:.3f} ms) -> the scan is {ref_ms / ms:.3f}x "
          f"the host; identity {identity(out.cpu().numpy(), ref)} [{card}]", flush=True)
    del images, out, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    for b in SWEEP:
        frames = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device=dev,
                               generator=gen)
        ms, out = scan_ms(frames, pal_t)
        ends = frames[[0, b - 1]].cpu().numpy()
        _, ref = host_ms(ends, pal)
        ident = identity(out[[0, b - 1]].cpu().numpy(), ref)
        print(f"sweep {h}x{w} uint8, {b} frames a launch: scan {b / ms * 1e3:.3f} fps "
              f"({ms:.3f} ms, {ms * 1e3 / (h * w):.5f} us a step); first and last frame "
              f"identity {ident} [{card}]", flush=True)
        del frames, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
