#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dither_pie_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device (an H100: the kernels are built for sm_90a), nvcc
and a host C++ compiler, and no network. It imports nothing of JAX and
nothing of the JAX package. Phases, in order; any failure ends the run with
a non-zero exit code and no result line:

1. identify the card (name and power limit, torch and CUDA versions);
2. build the kernels from kernels/csrc (timed);
3. hold each kernel to its plain PyTorch version on the card, bitwise:
   K1 skew, K2 scan (all 8 variants, u8 and non-integer f32 frames, and a
   flat frame of exact palette ties) and K3 unskew at B=3 37x53 P=32, then
   all 8 variants at 1080p B=2 P=32, then Floyd-Steinberg on one float32
   1080p frame (B=1, the shape apply_dithering gives the kernels);
4. hold the CUDA path to the golden engine (dither_pie_tpu/native/
   ed_scan.cpp compiled by path with g++, ed_fixed_f32) on 2 synthetic
   1080p frames with the k-means-32 palette, Floyd-Steinberg first and
   then the other 7 variants: identity must be 1.0;
5. drive the main path: k-means-32 palette on the card, then
   ImageDitherer(...ERROR_DIFFUSION, device="cuda").apply_dithering_batch
   on 16 distinct 1080p frames and apply_dithering on one PIL 1080p image;
   check shape, dtype, palette-only colours, identity with the golden
   engine on all 16 frames and on the PIL image, and that every kernel of
   the path was launched;
6. time it: wall time per batch of 16 (numpy in and out), device time of
   the three kernels and of their plain versions on the batch of 16 (CUDA
   events; each kernel's output must equal its plain version's, bitwise),
   and one apply_dithering_batch call traced with torch.profiler for the
   device's busy and idle shares (read only from a trace that holds the
   frames' host-to-device copy); each number is printed beside the card's
   name and power limit;
7. the ordered path on the pico8 palette: K4 held to its plain version
   bitwise (colours, and indices where P <= 256) at B=3 37x53 with
   P in {2, 16, 33, 300}, on flat frames of exact ties, at 16 x 1080p
   with Bayer 8x8 and at 100 x 1080p with blue noise (64, seed 42) and
   IGN (seed 42); K4's output on 2 synthetic 1080p frames held to a numpy
   twin of the ordered pick (identity 1.0, Bayer 8x8 and IGN); then the
   main path ImageDitherer(BAYER 8x8).apply_dithering_batch on the 16
   frames of phase 5 and apply_dithering on one 512x512 PIL image, and one
   batch each through NONE, BLUE_NOISE, IGN and POLKA_DOT, each checked
   for shape, dtype, palette-only colours and equality with the plain
   version, with K4 launched, and NONE's single image held to the numpy
   twin; then one traced Bayer batch, the batch wall, K4's and its plain
   version's device times (16 x 1080p Bayer, 100 x 1080p blue noise and
   IGN) and the 512x512 latency.

The lines before the last are a JSON object {"kernels": [...]} and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN_SRC = ROOT / "dither_pie_tpu" / "native" / "ed_scan.cpp"
GOLDEN_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared",
                "-ffp-contract=off", "-fno-fast-math"]

FULL_H, FULL_W = 1080, 1920
BATCH = 16
BIG_BATCH = 100  # BASELINE.md config 3: 100 x 1080p blue noise and IGN
LATENCY_HW = 512  # BASELINE.md config 1: one 512x512 image, Bayer 8x8
SMALL = (3, 37, 53)  # odd batch and odd sizes
N_COLORS = 32

KERNELS = [  # (launch-count key, source, replaced TPU kernel)
    ("skew", "dither_pie_tpu_torch/kernels/csrc/skew.cu",
     "dither_pie_tpu/ops/wavefront.py:1445"),
    ("ed_scan_fixed", "dither_pie_tpu_torch/kernels/csrc/ed_scan.cu",
     "dither_pie_tpu/ops/wavefront.py:890"),
    ("unskew_unpack", "dither_pie_tpu_torch/kernels/csrc/unskew_unpack.cu",
     "dither_pie_tpu/ops/wavefront.py:1772"),
]
ORDERED_KERNEL = ("ordered_fused", "dither_pie_tpu_torch/kernels/csrc/ordered.cu",
                  "dither_pie_tpu/ops/ordered_pallas.py:96")


def synth_image(h, w, seed=0):
    """Photo-like synthetic frame: smooth gradients + blobs + noise (k-means
    on pure noise is meaningless; this has real color structure). The same
    function as bench.py's."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        128 + 110 * np.sin(2 * np.pi * (x / w + 0.1 * np.sin(y / 97.0))),
        128 + 90 * np.cos(2 * np.pi * (y / h + 0.2)),
        128 + 100 * np.sin(2 * np.pi * ((x + y) / (h + w))),
    ], axis=-1)
    for _ in range(6):
        cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.randint(30, 200)
        mask = ((y - cy) ** 2 + (x - cx) ** 2) < r * r
        img[mask] = img[mask] * 0.5 + rng.randint(0, 256, 3) * 0.5
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def log(*a):
    print(*a, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Phase 1: the card
# ---------------------------------------------------------------------------


def card_line() -> str:
    """`name, power.limit` exactly as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def compare_kernels(torch, twf, dev, frames, pal, variants, errs):
    """Run K1, K2, K3 and their plain versions on the same inputs on ``dev``
    and require bitwise equality; record the max abs error per kernel."""
    h, w = frames.shape[1:3]
    for variant in variants:
        geom = twf.scan_geometry(variant)
        stream = twf.skew(frames, geom.s)
        stream_ref = twf.skew_plain(frames, geom.s)
        col = twf.scan(stream, pal, geom, w)
        col_ref = twf.scan_plain(stream, pal, geom, w)
        out = twf.unskew_unpack(col, geom.s, h, w)
        out_ref = twf.unskew_unpack_plain(col, geom.s, h, w)
        sync(torch, dev)
        for key, a, b in (("skew", stream, stream_ref),
                          ("ed_scan_fixed", col, col_ref),
                          ("unskew_unpack", out, out_ref)):
            err = (a.to(torch.float64) - b.to(torch.float64)).abs().max().item()
            errs[key] = max(errs.get(key, 0.0), err)
            check(torch.equal(a, b),
                  f"{key} kernel != plain version ({variant}, "
                  f"{tuple(frames.shape)} {frames.dtype}, max abs err {err})")


# ---------------------------------------------------------------------------
# Phase 4: the golden engine, compiled by path
# ---------------------------------------------------------------------------


def golden_engine(build_dir: Path):
    """ed_fixed_f32 from dither_pie_tpu/native/ed_scan.cpp, compiled with
    the JAX package's own flags (no FMA contraction) and loaded by ctypes."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    check(cxx is not None, "no C++ compiler for the golden engine")
    build_dir.mkdir(parents=True, exist_ok=True)
    so = build_dir / "libed_scan_golden.so"
    subprocess.run([cxx, *GOLDEN_FLAGS, str(GOLDEN_SRC), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    c_i = ctypes.c_int
    lib.ed_fixed_f32.argtypes = [f32p, c_i, c_i, f32p, c_i, i32p, f32p, c_i, c_i]
    lib.ed_fixed_f32.restype = None
    return lib


def golden_frame(lib, kernel_arrays, frame, pal, variant):
    work = np.ascontiguousarray(frame, dtype=np.float32).copy()
    offs, wts = kernel_arrays(variant)
    h, w, _ = work.shape
    lib.ed_fixed_f32(work, h, w, np.ascontiguousarray(pal, np.float32),
                     pal.shape[0], offs, wts, len(wts), 0)
    return work.astype(np.uint8)


def identity(a, b) -> float:
    return float(np.all(a == b, axis=-1).mean())


# ---------------------------------------------------------------------------
# Phase 6: timing
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps):
    """(median device milliseconds of fn() over reps runs after one
    warm-up, from CUDA events around each run; the last run's result)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def traced_call(torch, fn, trace_path: Path):
    """Run fn() once under torch.profiler (CPU and CUDA activities) and
    read the device events of its chrome trace, written to trace_path (the
    trace carries each copy's size). Returns (wall ms of the call, device
    busy ms as the union of all device intervals, {device event name:
    summed ms}, bytes of the host-to-device copies, host copy calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    trace = json.loads(trace_path.read_text())["traceEvents"]
    events = [e for e in trace if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    copy_calls = sum(e.get("cat") == "cuda_runtime" and "Memcpy" in e.get("name", "")
                     for e in trace)
    by_name, h2d_bytes = {}, 0
    busy_us, edge = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: float(e["ts"])):
        start, dur = float(e["ts"]), float(e["dur"])
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + dur / 1e3
        if "HtoD" in e["name"]:
            h2d_bytes += int(e.get("args", {}).get("bytes", 0))
        if start + dur > edge:
            busy_us += start + dur - max(start, edge)
            edge = start + dur
    return wall_ms, busy_us / 1e3, by_name, h2d_bytes, copy_calls


def report_trace(torch, tag, what, fn, frame_bytes, card):
    """Trace fn() once and log its device busy time and idle share. The
    idle share is read only from a trace that holds the frames'
    host-to-device copy (frame_bytes or more); otherwise it is reported as
    not measured. A measurement only: a profiler fault fails nothing."""
    from dither_pie_tpu_torch.kernels import build

    try:
        t_wall, t_busy, by_name, h2d_bytes, copy_calls = traced_call(
            torch, fn, build.BUILD_DIR / "traces" / f"phase{tag}.json")
    except (RuntimeError, OSError, KeyError, ValueError) as e:
        log(f"[{tag}] torch.profiler trace failed ({e}); idle share not measured")
        return
    # Every device event, its name cut to 48 characters.
    events = "; ".join(f"{n[:48]} {v:.3f} ms" for n, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1]))
    if h2d_bytes < frame_bytes:
        log(f"[{tag}] traced {what} (torch.profiler): wall {t_wall:.3f} ms; the trace "
            f"holds {h2d_bytes} H2D bytes of the frames' {frame_bytes} ({copy_calls} host "
            f"copy calls): idle share not measured (no H2D event); device time by name: "
            f"{events} [{card}]")
        return
    log(f"[{tag}] traced {what} (torch.profiler): wall {t_wall:.3f} ms, device busy "
        f"{t_busy:.3f} ms (union of kernel and copy intervals), idle share "
        f"{1 - t_busy / t_wall:.4f}, H2D {h2d_bytes} bytes; device time by name: "
        f"{events} [{card}]")


# ---------------------------------------------------------------------------
# Phase 7: the ordered path
# ---------------------------------------------------------------------------


def pico8_palette():
    """pico8 as RGB tuples, from the port's copy of the built-in palettes."""
    from dither_pie_tpu_torch.core.builtin_palettes import BUILTIN_PALETTES

    return [tuple(int(c[i:i + 2], 16) for i in (0, 2, 4))
            for c in BUILTIN_PALETTES["pico8_palette"]]


def ordered_twin(frames, pal, screen):
    """numpy twin of the ordered pick: direct float32 differences, first
    minimum wins (then the first of the rest), d1/(d1+d2) <= screen."""
    out = np.empty(frames.shape, np.uint8)
    thr = screen.reshape(-1)
    for k, frame in enumerate(frames):
        px = frame.reshape(-1, 3).astype(np.float32)
        dr = px[:, 0:1] - pal[None, :, 0]
        dg = px[:, 1:2] - pal[None, :, 1]
        db = px[:, 2:3] - pal[None, :, 2]
        d = (dr * dr + dg * dg) + db * db
        rows = np.arange(len(d))
        i1 = d.argmin(1)
        d1 = d[rows, i1]
        d[rows, i1] = np.inf
        i2 = d.argmin(1)
        d2 = d[rows, i2]
        tot = d1 + d2
        with np.errstate(divide="ignore", invalid="ignore"):
            factor = np.where(tot == 0, np.float32(0), d1 / tot)
        idx = np.where(factor <= thr, i1, i2)
        out[k] = pal[idx].astype(np.int32).astype(np.uint8).reshape(frame.shape)
    return out


def palette_only(arr, pal_np) -> bool:
    keys = np.array([1 << 16, 1 << 8, 1])
    pal_keys = pal_np.astype(np.int64) @ keys
    return bool(np.isin(np.unique(arr.reshape(-1, 3).astype(np.int64) @ keys),
                        pal_keys).all())


def compare_ordered(torch, tof, frames, pal, screen, errs, what, indices=(False, True)):
    """K4 against its plain version on the same inputs, bitwise."""
    for ind in indices:
        got = tof.ordered_dither_fused(frames, pal, screen, return_indices=ind)
        want = tof.ordered_dither_fused_plain(frames, pal, screen, return_indices=ind)
        same = torch.equal(got, want)
        err = 0.0 if same else float(
            (got.to(torch.int16) - want.to(torch.int16)).abs().max())
        errs["ordered_fused"] = max(errs.get("ordered_fused", 0.0), err)
        check(same, f"ordered_fused kernel != plain version ({what}, "
                    f"indices={ind}, max abs err {err})")


def ordered_phase(torch, dev, card, frames16, anchor_frames):
    """Phase 7; returns the kernels-line row of K4."""
    from PIL import Image

    import dither_pie_tpu_torch as dpt
    from dither_pie_tpu_torch.core import thresholds as thr
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.ops import ordered as tord
    from dither_pie_tpu_torch.ops import ordered_fused as tof

    errs = {}
    pico8 = pico8_palette()
    pal_np = np.asarray(pico8, np.float32)
    pal_t = torch.from_numpy(pal_np).to(dev)
    bayer = tord.screen_for_matrix(thr.bayer_matrix("8x8"), FULL_H, FULL_W, dev)
    blue = tord.screen_for_matrix(thr.blue_noise_cached(64, 42), FULL_H, FULL_W, dev)
    ign = thr.ign_thresholds(FULL_H, FULL_W, 1.0, 42, dev)

    # Kernel against plain version, bitwise: small odd shapes.
    t0 = time.perf_counter()
    rng = np.random.RandomState(7)
    b, h, w = SMALL
    small = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)).to(dev)
    small_screens = {"bayer8x8": tord.screen_for_matrix(thr.bayer_matrix("8x8"), h, w, dev),
                     "ign": thr.ign_thresholds(h, w, 1.7, 5, dev)}
    for p in (2, 16, 33, 300):
        pal = torch.from_numpy(rng.randint(0, 256, (p, 3)).astype(np.float32)).to(dev)
        for name, screen in small_screens.items():
            compare_ordered(torch, tof, small, pal, screen, errs, f"B={b} {h}x{w} P={p} {name}",
                            (False, True) if p <= 256 else (False,))
    compare_ordered(torch, tof, small.to(torch.float32), pal_t,
                    small_screens["bayer8x8"], errs, "float32 frames, pico8")
    # Exact ties: a flat frame midway between two colours, and one on a
    # duplicated colour (d1 + d2 == 0), against flat screens 0, 0.5, 1.
    for colour, pal_rows in (((101, 100, 100), [[100, 100, 100], [102, 100, 100], [0, 0, 0]]),
                             ((40, 50, 60), [[0, 0, 0], [40, 50, 60], [40, 50, 60]])):
        flat = torch.tensor(colour, dtype=torch.uint8, device=dev).expand(b, h, w, 3).contiguous()
        pal = torch.tensor(pal_rows, dtype=torch.float32, device=dev)
        for level in (0.0, 0.5, 1.0):
            compare_ordered(torch, tof, flat, pal,
                            torch.full((h, w), level, dtype=torch.float32, device=dev),
                            errs, f"exact ties {colour} screen {level}")
    log(f"[7] ordered_fused == plain, bitwise: B={b} {h}x{w} P in (2, 16, 33, 300) "
        f"x (Bayer 8x8, IGN), colours and indices (P <= 256), float32 frames, "
        f"exact ties ({time.perf_counter() - t0:.1f} s)")

    # Full size: the main path's batch of 16 (Bayer 8x8), and BASELINE
    # config 3's 100 x 1080p (blue noise, IGN), made on the card from the
    # 16 frames rolled along x so that every frame differs.
    t0 = time.perf_counter()
    batch_t = torch.from_numpy(frames16).to(dev)
    compare_ordered(torch, tof, batch_t, pal_t, bayer, errs,
                    f"{BATCH}x{FULL_H}x{FULL_W} pico8 Bayer 8x8")
    reps = -(-BIG_BATCH // len(frames16))
    big = torch.cat([batch_t.roll(37 * k, dims=2) for k in range(reps)])[:BIG_BATCH]
    for name, screen in (("blue noise 64/42", blue), ("IGN seed 42", ign)):
        compare_ordered(torch, tof, big, pal_t, screen, errs,
                        f"{BIG_BATCH}x{FULL_H}x{FULL_W} pico8 {name}", (False,))
    log(f"[7] ordered_fused == plain, bitwise: {BATCH}x{FULL_H}x{FULL_W} pico8 "
        f"Bayer 8x8 (colours, indices), {BIG_BATCH}x{FULL_H}x{FULL_W} pico8 blue "
        f"noise and IGN ({time.perf_counter() - t0:.1f} s)")

    # Host anchor: K4 against a numpy twin on 2 synthetic 1080p frames.
    ign_np = thr.ign_thresholds_np(FULL_H, FULL_W, 1.0, 42)
    check(torch.equal(ign.cpu(), torch.from_numpy(ign_np)),
          "IGN screen on the card != ign_thresholds_np")
    anchor_t = torch.from_numpy(np.stack(anchor_frames)).to(dev)
    for name, screen, screen_np in (
            ("Bayer 8x8", bayer, thr.tile_threshold_map(thr.bayer_matrix("8x8"), FULL_H, FULL_W)),
            ("IGN seed 42", ign, ign_np)):
        got = tof.ordered_dither_fused(anchor_t, pal_t, screen).cpu().numpy()
        twin = ordered_twin(np.stack(anchor_frames), pal_np, screen_np)
        idents = [identity(g, t) for g, t in zip(got, twin)]
        log(f"[7] numpy anchor (pico8, {name}, 2 x {FULL_H}x{FULL_W}): identity {idents}")
        check(all(v == 1.0 for v in idents), f"ordered anchor identity {idents} ({name})")

    # The main path through the public entry points.
    ditherer = dpt.ImageDitherer(dither_mode=dpt.DitherMode.BAYER, palette=pico8,
                                 dither_params={"size": "8x8"}, device=dev)
    lat_img = synth_image(LATENCY_HW, LATENCY_HW, 7)
    pil = Image.fromarray(lat_img)
    others = [(dpt.DitherMode.NONE, {}, torch.ones((FULL_H, FULL_W), device=dev)),
              (dpt.DitherMode.BLUE_NOISE, {"size": 64, "seed": 42}, blue),
              (dpt.DitherMode.INTERLEAVED_GRADIENT_NOISE, {"seed": 42}, ign),
              (dpt.DitherMode.POLKA_DOT, {}, tord.screen_for_matrix(
                  thr.polka_dot_matrix(8, 1.5), FULL_H, FULL_W, dev))]
    other_ditherers = [dpt.ImageDitherer(dither_mode=m, palette=pico8, dither_params=prm,
                                         device=dev) for m, prm, _ in others]
    build.reset_launch_counts()
    out16 = ditherer.apply_dithering_batch(frames16)
    out_pil = np.asarray(ditherer.apply_dithering(pil))
    outs = [d.apply_dithering_batch(frames16) for d in other_ditherers]
    sync(torch, dev)
    launches = build.LAUNCHES["ordered_fused"]
    log(f"[7] main path launches: ordered_fused {launches}")
    check(launches >= 1, "kernel ordered_fused not launched on the main path")
    results = [("BAYER 8x8", out16, bayer)] + [
        (m.name, o, screen) for (m, _, screen), o in zip(others, outs)]
    for name, out, screen in results:
        check(out.shape == frames16.shape and out.dtype == np.uint8,
              f"{name} batch output {out.shape} {out.dtype}")
        check(palette_only(out, pal_np), f"{name} batch holds colours outside pico8")
        want = tof.ordered_dither_fused_plain(batch_t, pal_t, screen).cpu().numpy()
        check(np.array_equal(out, want), f"{name} batch != plain version")
    check(out_pil.shape == lat_img.shape and out_pil.dtype == np.uint8,
          f"apply_dithering output {out_pil.shape}")
    # NONE's single image runs K4 with a screen of ones: the nearest
    # colour, the twin with a screen of ones.
    near = np.asarray(other_ditherers[0].apply_dithering(pil))
    ident_near = identity(near, ordered_twin(lat_img[None], pal_np,
                                             np.ones(lat_img.shape[:2], np.float32))[0])
    check(ident_near == 1.0, f"NONE apply_dithering: numpy anchor identity {ident_near}")
    lat_screen = thr.tile_threshold_map(thr.bayer_matrix("8x8"), LATENCY_HW, LATENCY_HW)
    ident_pil = identity(out_pil, ordered_twin(lat_img[None], pal_np, lat_screen)[0])
    check(palette_only(out_pil, pal_np) and ident_pil == 1.0,
          f"apply_dithering {LATENCY_HW}x{LATENCY_HW}: numpy anchor identity {ident_pil}")
    log(f"[7] apply_dithering_batch (BAYER 8x8, NONE, BLUE_NOISE, IGN, POLKA_DOT): "
        f"{out16.shape} uint8, palette-only, equal to the plain version; "
        f"apply_dithering(PIL {LATENCY_HW}x{LATENCY_HW}): numpy anchor identity "
        f"{ident_pil} (BAYER 8x8), {ident_near} (NONE)")

    # Times, each beside the card; the trace first, right after the main
    # path.
    report_trace(torch, 7, "apply_dithering_batch BAYER 8x8",
                 lambda: ditherer.apply_dithering_batch(frames16), frames16.nbytes, card)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ditherer.apply_dithering_batch(frames16)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    log(f"[7] apply_dithering_batch wall, BAYER 8x8 pico8 (numpy u8 in/out): median "
        f"{wall * 1e3:.3f} ms/batch{BATCH} -> {BATCH / wall:.2f} fps (5 runs: "
        f"{', '.join(f'{t * 1e3:.3f}' for t in walls)}) [{card}]")
    lats = []
    for _ in range(11):
        t0 = time.perf_counter()
        ditherer.apply_dithering(pil)
        lats.append(time.perf_counter() - t0)
    log(f"[7] apply_dithering latency, {LATENCY_HW}x{LATENCY_HW} Bayer 8x8 pico8 (PIL "
        f"in/out): median {statistics.median(lats) * 1e3:.3f} ms of 11 (min "
        f"{min(lats) * 1e3:.3f}) [{card}]")
    row = {"name": ORDERED_KERNEL[0], "route": "cuda", "source": ORDERED_KERNEL[1],
           "replaces": ORDERED_KERNEL[2], "launches": launches}
    for name, frames, screen in ((f"{BATCH}x{FULL_H}x{FULL_W} Bayer 8x8", batch_t, bayer),
                                 (f"{BIG_BATCH}x{FULL_H}x{FULL_W} blue noise", big, blue),
                                 (f"{BIG_BATCH}x{FULL_H}x{FULL_W} IGN", big, ign)):
        ms, got = cuda_ms(torch, lambda: tof.ordered_dither_fused(frames, pal_t, screen), 5)
        plain_ms, want = cuda_ms(
            torch, lambda: tof.ordered_dither_fused_plain(frames, pal_t, screen),
            3 if frames is batch_t else 1)
        check(torch.equal(got, want), f"ordered_fused != plain on the timed {name} run")
        gpix = frames.shape[0] * FULL_H * FULL_W / 1e9
        log(f"[7] ordered_fused, {name} pico8: kernel {ms:.3f} ms = {gpix / ms * 1e3:.2f} "
            f"GPix/s, plain PyTorch {plain_ms:.3f} ms = {gpix / plain_ms * 1e3:.2f} "
            f"GPix/s, outputs equal bitwise [{card}]")
        if frames is batch_t:
            row.update(ms=ms, plain_ms=plain_ms)
    row["max_abs_err"] = errs["ordered_fused"]

    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 2
    # The port uses no matmul or convolution; pin both TF32 switches off
    # all the same, so no reduced-precision path can enter a comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(torch, torch.device("cuda"), card_line())


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(torch, dev, card) -> int:
    """Phases 1-7 on ``dev``; prints the result lines and returns 0, or
    raises on the first failure."""
    from PIL import Image

    import dither_pie_tpu_torch as dpt
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.ops import ed_kernels, wavefront as twf

    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    check("dither_pie_tpu" not in sys.modules, "dither_pie_tpu was imported")
    variants = ed_kernels.KERNEL_NAMES

    # 1. The card.
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")

    # 2. Build.
    t0 = time.perf_counter()
    build.extension()
    log(f"[2] build: kernels built from {build.CSRC.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(build.NVCC_FLAGS)})")

    # 3. Kernels against their plain versions, bitwise.
    errs = {}
    rng = np.random.RandomState(0)
    b, h, w = SMALL
    pal_small = rng.randint(0, 256, (N_COLORS, 3)).astype(np.float32)
    pal_small_t = torch.from_numpy(pal_small).to(dev)
    small_u8 = torch.from_numpy(
        rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)).to(dev)
    small_f32 = torch.from_numpy(
        rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    compare_kernels(torch, twf, dev, small_u8, pal_small_t, variants, errs)
    compare_kernels(torch, twf, dev, small_f32, pal_small_t, variants, errs)
    # Exact ties: a flat frame midway between two palette colours.
    ties = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=dev)
    ties[...] = torch.tensor([101, 100, 100], dtype=torch.uint8)
    pal_ties = torch.tensor([[100, 100, 100], [102, 100, 100], [0, 0, 0]],
                            dtype=torch.float32, device=dev)
    compare_kernels(torch, twf, dev, ties, pal_ties, variants, errs)
    log(f"[3] kernel == plain, bitwise: 8 variants x (u8, f32) at B={b} "
        f"{h}x{w} P={N_COLORS}, and on exact ties "
        f"({time.perf_counter() - t0:.1f} s)")

    frame0 = synth_image(FULL_H, FULL_W, 0)
    t0 = time.perf_counter()
    palette = dpt.ColorReducer.generate_kmeans_palette(
        Image.fromarray(frame0), N_COLORS, device=dev)
    sync(torch, dev)
    kmeans_s = time.perf_counter() - t0
    pal_np = np.asarray(palette, np.float32)
    pal_t = torch.from_numpy(pal_np).to(dev)
    check(pal_np.shape == (N_COLORS, 3) and np.all((pal_np >= 0) & (pal_np <= 255)),
          f"k-means palette malformed: {pal_np.shape}")
    full2 = torch.from_numpy(np.stack(
        [synth_image(FULL_H, FULL_W, 1 + i) for i in range(2)])).to(dev)
    t0 = time.perf_counter()
    compare_kernels(torch, twf, dev, full2, pal_t, variants, errs)
    log(f"[3] kernel == plain, bitwise: 8 variants at B=2 {FULL_H}x{FULL_W} "
        f"P={N_COLORS} k-means ({time.perf_counter() - t0:.1f} s)")
    # apply_dithering hands the kernels one float32 frame (B=1).
    t0 = time.perf_counter()
    compare_kernels(torch, twf, dev,
                    torch.from_numpy(frame0[None].astype(np.float32)).to(dev),
                    pal_t, ["floyd_steinberg"], errs)
    log(f"[3] kernel == plain, bitwise: floyd_steinberg on one float32 "
        f"{FULL_H}x{FULL_W} frame (B=1) P={N_COLORS} k-means "
        f"({time.perf_counter() - t0:.1f} s)")

    # 4. Golden anchor: FS (the main path) first, then the other variants
    # at the same size.
    lib = golden_engine(build.BUILD_DIR / "golden")
    gold_frames = [synth_image(FULL_H, FULL_W, 100 + i) for i in range(2)]
    gold_t = torch.from_numpy(np.stack(gold_frames)).to(dev)
    for variant in variants:
        cuda_out = twf.ed_batch_wavefront(gold_t, pal_t, "fixed",
                                          variant).cpu().numpy()
        idents = [identity(cuda_out[i], golden_frame(
            lib, ed_kernels.kernel_arrays, f, pal_np, variant))
            for i, f in enumerate(gold_frames)]
        log(f"[4] golden anchor (ed_fixed_f32, {variant}, k-means-32, 2 x "
            f"{FULL_H}x{FULL_W}): identity {idents}")
        check(all(v == 1.0 for v in idents),
              f"golden identity {idents} != 1.0 ({variant})")

    # 5. Main path through the public entry points.
    frames16 = np.stack([synth_image(FULL_H, FULL_W, 10 + i)
                         for i in range(BATCH)])
    ditherer = dpt.ImageDitherer(
        num_colors=N_COLORS, dither_mode=dpt.DitherMode.ERROR_DIFFUSION,
        palette=palette, dither_params={"variant": "floyd_steinberg"},
        device=dev)
    pil = Image.fromarray(frame0)
    build.reset_launch_counts()
    out16 = ditherer.apply_dithering_batch(frames16)
    out_pil = ditherer.apply_dithering(pil)
    sync(torch, dev)
    launches = dict(build.LAUNCHES)
    log(f"[5] main path launches: {launches}")
    for key, _, _ in KERNELS:
        check(launches.get(key, 0) >= 1, f"kernel {key} not launched")
    check(out16.shape == frames16.shape and out16.dtype == np.uint8,
          f"batch output {out16.shape} {out16.dtype}")
    pal_keys = (pal_np.astype(np.int64) @ np.array([1 << 16, 1 << 8, 1]))
    out_keys = out16.reshape(-1, 3).astype(np.int64) @ np.array([1 << 16, 1 << 8, 1])
    check(np.isin(np.unique(out_keys), pal_keys).all(),
          "batch output holds colours outside the palette")
    with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        golds = list(ex.map(
            lambda f: golden_frame(lib, ed_kernels.kernel_arrays, f, pal_np,
                                   "floyd_steinberg"),
            [*frames16, frame0]))
    idents16 = [identity(o, g) for o, g in zip(out16, golds)]
    check(all(v == 1.0 for v in idents16),
          f"main-path golden identity {idents16}")
    arr_pil = np.asarray(out_pil)
    check(arr_pil.shape == frame0.shape and arr_pil.dtype == np.uint8,
          f"apply_dithering output {arr_pil.shape}")
    pil_keys = arr_pil.reshape(-1, 3).astype(np.int64) @ np.array([1 << 16, 1 << 8, 1])
    check(np.isin(np.unique(pil_keys), pal_keys).all(),
          "apply_dithering output holds colours outside the palette")
    ident_pil = identity(arr_pil, golds[-1])
    check(ident_pil == 1.0, f"apply_dithering golden identity {ident_pil}")
    log(f"[5] apply_dithering_batch: {out16.shape} uint8, palette-only, "
        f"golden identity of the {BATCH} frames {idents16}; apply_dithering(PIL "
        f"{FULL_W}x{FULL_H}): palette-only, golden identity {ident_pil}")

    # 6. Times, each beside the card.
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ditherer.apply_dithering_batch(frames16)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    log(f"[6] apply_dithering_batch wall (numpy u8 in/out, H2D+D2H incl.): "
        f"median {wall * 1e3:.3f} ms/batch{BATCH} -> {BATCH / wall:.2f} fps "
        f"(5 runs: {', '.join(f'{t * 1e3:.3f}' for t in walls)}) [{card}]")
    log(f"[6] k-means-32 palette on the card (first call): "
        f"{kmeans_s * 1e3:.3f} ms [{card}]")

    def host_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync(torch, dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    batch_t = torch.from_numpy(frames16).to(dev)
    pinned = torch.from_numpy(frames16).pin_memory()
    h2d = host_ms(lambda: torch.from_numpy(frames16).to(dev))
    h2d_pinned = host_ms(lambda: pinned.to(dev, non_blocking=True))
    d2h = host_ms(lambda: batch_t.cpu().numpy())
    log(f"[6] host transfer of one {BATCH}x{FULL_H}x{FULL_W}x3 u8 batch "
        f"({frames16.nbytes / 1e6:.1f} MB): H2D pageable {h2d:.3f} ms, H2D "
        f"pinned {h2d_pinned:.3f} ms, D2H pageable {d2h:.3f} ms [{card}]")
    geom = twf.scan_geometry("floyd_steinberg")
    stream = twf.skew(batch_t, geom.s)
    col = twf.scan(stream, pal_t, geom, FULL_W)
    path_ms, _ = cuda_ms(torch, lambda: twf.ed_batch_wavefront(batch_t, pal_t), 5)
    log(f"[6] device path K1+K2+K3 (tensors on the card): {path_ms:.3f} "
        f"ms/batch{BATCH} -> {BATCH / path_ms * 1e3:.2f} fps [{card}]")
    timed = {
        "skew": (lambda: twf.skew(batch_t, geom.s),
                 lambda: twf.skew_plain(batch_t, geom.s)),
        "ed_scan_fixed": (lambda: twf.scan(stream, pal_t, geom, FULL_W),
                          lambda: twf.scan_plain(stream, pal_t, geom, FULL_W)),
        "unskew_unpack": (lambda: twf.unskew_unpack(col, geom.s, FULL_H, FULL_W),
                          lambda: twf.unskew_unpack_plain(col, geom.s, FULL_H,
                                                          FULL_W)),
    }
    rows = []
    for key, source, replaces in KERNELS:
        kern, plain = timed[key]
        ms, got = cuda_ms(torch, kern, 5)
        plain_ms, want = cuda_ms(torch, plain, 1 if key == "ed_scan_fixed" else 3)
        # The timed runs are the main path's kernels at its own shapes (the
        # batch of 16): their outputs are held to the plain versions too.
        err = (got.to(torch.float64) - want.to(torch.float64)).abs().max().item()
        errs[key] = max(errs[key], err)
        check(torch.equal(got, want),
              f"{key} kernel != plain version on the {BATCH}x{FULL_H}x{FULL_W} "
              f"batch (max abs err {err})")
        log(f"[6] {key}: kernel {ms:.3f} ms, plain PyTorch {plain_ms:.3f} ms "
            f"per {BATCH}x{FULL_H}x{FULL_W} FS batch, outputs equal bitwise "
            f"[{card}]")
        rows.append({"name": key, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches.get(key, 0),
                     "max_abs_err": errs[key], "ms": ms,
                     "plain_ms": plain_ms})

    # One traced call: how much of the wall time the device is busy.
    report_trace(torch, 6, "apply_dithering_batch FS",
                 lambda: ditherer.apply_dithering_batch(frames16), frames16.nbytes, card)

    # 7. The ordered path.
    rows.append(ordered_phase(torch, dev, card, frames16, gold_frames))

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
