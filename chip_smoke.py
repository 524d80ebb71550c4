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
   4 variants (one per skew and ring size) at 1080p B=2 P=32, then
   Floyd-Steinberg on one float32 1080p frame (B=1, the shape
   apply_dithering gives the kernels);
4. hold the CUDA path to the golden engine (dither_pie_tpu/native/
   ed_scan.cpp compiled by path with g++, ed_fixed_f32) on 2 synthetic
   1080p frames with the k-means-32 palette, Floyd-Steinberg first and
   then 3 other variants: identity must be 1.0;
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
   frames' host-to-device copy), then the same call with the k-means-256
   palette of phase 8 traced likewise; each number is printed beside the
   card's name and power limit;
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
   IGN) and the 512x512 latency;
8. the rest of the error-diffusion family: K2 (ostromoukhov, hybrid,
   perceptual, adaptive; palettes of up to 1024 colours), K8 (the index
   scan, any palette) and K9 (unskew + palette select) held to their plain
   versions bitwise at B=3 37x53 (4 modes x (u8, f32) at P=32; fixed at
   P in {65, 256, 1024} through K2; fixed and ostromoukhov at P=2048 and
   ostromoukhov at P=16384, the largest palette K8 takes, through K8 ->
   K9; planted duplicate colours at P=600 and 2048, whose later index must
   never be emitted), at 1080p B=2 P=32 for the 4 modes, at 1080p B=1
   P=256 and at 480p B=2 P=2048; the
   sensitivity map on the card held to numpy bitwise; golden identity 1.0
   (ed_ostromoukhov_f32, ed_hybrid_f32, ed_perceptual_f32,
   ed_adaptive_f32 on 2 synthetic 1080p frames at k-means-32;
   Floyd-Steinberg at k-means-256 on 2 1080p frames and at k-means-2048 on
   2 480p frames); the main paths ImageDitherer(ERROR_DIFFUSION, FS,
   k-means-256) and the 4 modes at k-means-32 on the 16 frames of phase 5
   plus one apply_dithering each, and ERROR_DIFFUSION at k-means-2048 on
   16 480p frames (K1 -> K8 -> K9), each with the launch counts set to 0
   before it and read after it, checked for shape, dtype, palette-only
   colours and golden identity 1.0 on all 16 frames and on the single
   image; then the times, each timed kernel's output held bitwise to its
   plain version's on the same batch of 16: K2 per mode at 16 x 1080p
   P=32, K2 at P = 64, 256, 1024 (FS), K8 and K9 at 16 x 480p P=2048, and
   the k-means-256 batch wall (its traced call is phase 6's second trace).

Every row of the kernels line carries the kernel's bound: the larger of its
bytes (inputs read once, outputs written once) over 3.35 TB/s and its
float32 operations over 67 TFLOP/s, the card's published peaks. The rows of
the scans K2 and K8, and each entry of K2's ``modes_ms`` and ``palette_ms``,
carry ``chain_bound_ms`` beside it: the serial chain of D wavefront steps
at 0.1 us a step, the least latency one step is taken to have (a
block-wide barrier, one trip through shared memory or L1, and about 25
dependent float instructions).

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
SD_H, SD_W = 480, 854  # 480p: the size of the 2048-colour path's runs
DEEP_VARIANTS = ["floyd_steinberg", "jjn", "atkinson", "sierra_lite"]  # at 1080p
ED_MODES = ["ostromoukhov", "hybrid", "perceptual", "adaptive"]

# The card's published peaks (NVIDIA's data sheet, H100 SXM, 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Least latency of one wavefront step of the scans: a block-wide barrier
# (~30 cycles), one trip through L1 or shared memory (~35 cycles) and ~25
# dependent float instructions at 4 cycles, ~175 cycles at 1.755 GHz.
CHAIN_STEP_US = 0.1


def bound(n_bytes, n_flops):
    """{"bound_ms", "bound_by"}: the least time the card could take, the
    larger of bytes over the memory rate and float32 operations over the
    peak rate outside the tensor cores."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def scan_bound(b, h, w, s, p, n_entries, in_bytes=1, aux=False):
    """Bound of K2 / K8: the stream and the palette (and the aux map) read
    once, the (D, B, H) int32 output written once; per pixel the fold (a
    multiply and an add per channel and entry), the search (3 subtracts, 3
    multiplies, 2 adds per colour) and the error (3 subtracts). Beside it
    ``chain_bound_ms``: the D steps follow one another, each at least
    CHAIN_STEP_US long."""
    d = w + s * (h - 1)
    n_bytes = d * 3 * b * h * in_bytes + p * 12 + d * b * h * 4 + (b * h * w * 4 if aux else 0)
    return {**bound(n_bytes, b * h * w * (6 * n_entries + 8 * p + 3)),
            "chain_bound_ms": d * CHAIN_STEP_US * 1e-3}


KERNELS = [  # (launch-count key, source, replaced TPU kernel)
    ("skew", "dither_pie_tpu_torch/kernels/csrc/skew.cu",
     "dither_pie_tpu/ops/wavefront.py:1445"),
    ("ed_scan", "dither_pie_tpu_torch/kernels/csrc/ed_scan.cu",
     "dither_pie_tpu/ops/wavefront.py:890"),
    ("unskew_unpack", "dither_pie_tpu_torch/kernels/csrc/unskew_unpack.cu",
     "dither_pie_tpu/ops/wavefront.py:1772"),
]
IDX_KERNELS = [  # the path of palettes above 1024 colours, with K1
    ("ed_scan_idx", "dither_pie_tpu_torch/kernels/csrc/ed_scan.cu",
     "dither_pie_tpu/ops/wavefront.py:144"),
    ("unskew_select", "dither_pie_tpu_torch/kernels/csrc/unskew_select.cu",
     "dither_pie_tpu/ops/wavefront.py:1709"),
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
                          ("ed_scan", col, col_ref),
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
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    c_f = ctypes.c_float
    head = [f32p, c_i, c_i, f32p, c_i]  # work, h, w, palette, p
    lib.ed_fixed_f32.argtypes = head + [i32p, f32p, c_i, c_i]
    lib.ed_ostromoukhov_f32.argtypes = head + [i32p, c_i]
    lib.ed_hybrid_f32.argtypes = head + [c_f, c_f, c_i]
    lib.ed_perceptual_f32.argtypes = head + [f32p]
    lib.ed_adaptive_f32.argtypes = head + [u8p]
    for fn in (lib.ed_fixed_f32, lib.ed_ostromoukhov_f32, lib.ed_hybrid_f32,
               lib.ed_perceptual_f32, lib.ed_adaptive_f32):
        fn.restype = None
    return lib


def golden_frame(lib, kernel_arrays, frame, pal, variant):
    work = np.ascontiguousarray(frame, dtype=np.float32).copy()
    offs, wts = kernel_arrays(variant)
    h, w, _ = work.shape
    lib.ed_fixed_f32(work, h, w, np.ascontiguousarray(pal, np.float32),
                     pal.shape[0], offs, wts, len(wts), 0)
    return work.astype(np.uint8)


def sensitivity_np(frames):
    """numpy twin of the perceptual sensitivity map, as the JAX package
    computes it: 0.5 + 0.5 * (gray / 255), gray = (0.299 r + 0.587 g) +
    0.114 b, float32."""
    gray = (np.float32(0.299) * frames[..., 0] + np.float32(0.587) * frames[..., 1]
            + np.float32(0.114) * frames[..., 2])
    return np.float32(0.5) + np.float32(0.5) * (gray / np.float32(255.0))


def golden_mode_frame(lib, frame, pal, mode, lum_factor=1.0, col_factor=0.2, gate=None):
    """One frame through the golden engine's f32 twin of a non-fixed mode."""
    from dither_pie_tpu_torch.ops.ed_kernels import OSTROMOUKHOV_ARRAY

    work = np.ascontiguousarray(frame, dtype=np.float32).copy()
    h, w, _ = work.shape
    head = (work, h, w, np.ascontiguousarray(pal, np.float32), pal.shape[0])
    if mode == "ostromoukhov":
        lib.ed_ostromoukhov_f32(*head, np.ascontiguousarray(OSTROMOUKHOV_ARRAY), 0)
    elif mode == "hybrid":
        lib.ed_hybrid_f32(*head, lum_factor, col_factor, 1)
    elif mode == "perceptual":
        lib.ed_perceptual_f32(*head, np.ascontiguousarray(sensitivity_np(work)))
    elif mode == "adaptive":
        lib.ed_adaptive_f32(*head, np.ascontiguousarray(gate.astype(np.uint8)))
    else:
        raise ValueError(mode)
    return work.astype(np.uint8)


def identity(a, b) -> float:
    return float(np.all(a == b, axis=-1).mean())


# ---------------------------------------------------------------------------
# Phase 6: timing
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps, warmup=True):
    """(median device milliseconds of fn() over reps runs after one
    warm-up, from CUDA events around each run; the last run's result).
    ``warmup=False`` for runs of seconds, where a warm-up changes nothing."""
    if warmup:
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
            # Per pixel and colour: 3 subtracts, 3 multiplies, 2 adds.
            n = BATCH * FULL_H * FULL_W
            row.update(ms=ms, plain_ms=plain_ms,
                       **bound(6 * n + FULL_H * FULL_W * 4 + len(pico8) * 12,
                               n * 8 * len(pico8)))
    row["max_abs_err"] = errs["ordered_fused"]

    return row


# ---------------------------------------------------------------------------
# Phase 8: the rest of the error-diffusion family
# ---------------------------------------------------------------------------


def unique_palette(rng, p):
    """p distinct random colours, float32."""
    pal = np.unique(rng.randint(0, 256, (8 * p + 64, 3)), axis=0)
    check(len(pal) >= p, f"could not draw {p} distinct colours")
    return pal[rng.permutation(len(pal))[:p]].astype(np.float32)


def compare_scan(torch, twf, frames, pal, geom, aux, errs, what, indexed=False):
    """K2 (or, ``indexed``, K8 and K9) against the plain versions on the
    same inputs, bitwise. Returns the scan kernel's (D, B, H) output."""
    h, w = frames.shape[1:3]
    stream = twf.skew(frames, geom.s)
    if indexed:
        got = twf.scan_idx(stream, pal, geom, w, aux)
        want = twf.scan_idx_plain(stream, pal, geom, w, aux)
        pairs = [("ed_scan_idx", got, want),
                 ("unskew_select", twf.unskew_select(got, pal, geom.s, h, w),
                  twf.unskew_select_plain(got, pal, geom.s, h, w))]
    else:
        pairs = [("ed_scan", twf.scan(stream, pal, geom, w, aux),
                  twf.scan_plain(stream, pal, geom, w, aux))]
    sync(torch, frames.device)
    for key, a, b in pairs:
        err = (a.to(torch.float64) - b.to(torch.float64)).abs().max().item()
        errs[key] = max(errs.get(key, 0.0), err)
        check(torch.equal(a, b), f"{key} kernel != plain version ({what}, "
                                 f"{tuple(frames.shape)} {frames.dtype}, max abs err {err})")
    return pairs[0][1]


def ed_modes_phase(torch, dev, card, lib, frames16, frame0, palette32, palette256,
                   gold_frames, rows, errs):
    """Phase 8; adds its main paths' launches to the rows of K1-K3 (``rows``)
    and returns the kernels-line rows of K8 and K9."""
    from PIL import Image

    import dither_pie_tpu_torch as dpt
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.ops import ed_kernels, wavefront as twf

    adaptive = dpt.AdaptiveVarianceDitherStrategy(device=dev)  # the default gates

    def on_card(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def gates_t(frames_np):
        return on_card(adaptive._gates(frames_np).astype(np.float32))

    def mode_setup(mode, frames_t, frames_np, hybrid=(1.0, 0.2)):
        """(geometry, aux map on the card) of a mode for these frames."""
        lum, col = hybrid if mode == "hybrid" else (1.0, 0.2)
        geom = twf.scan_geometry("floyd_steinberg" if mode == "fixed" else "", mode, lum, col)
        aux = None
        if mode == "perceptual":
            aux = twf.perceptual_sensitivity(frames_t)
        elif mode == "adaptive":
            aux = gates_t(frames_np)
        return geom, aux

    # --- kernel == plain, bitwise, small odd shapes ---------------------
    t0 = time.perf_counter()
    rng = np.random.RandomState(8)
    b, h, w = SMALL
    small = {"u8": rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
             "f32": rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32)}
    pal32 = on_card(rng.randint(0, 256, (N_COLORS, 3)).astype(np.float32))
    for mode, hybrid in (("ostromoukhov", None), ("hybrid", (1.0, 0.2)), ("hybrid", (0.7, 0.45)),
                         ("perceptual", None), ("adaptive", None)):
        for name, arr in small.items():
            frames_t = on_card(arr)
            geom, aux = mode_setup(mode, frames_t, arr, hybrid or (1.0, 0.2))
            if mode == "adaptive":  # about half the pixels gated off
                aux = on_card((rng.rand(b, h, w) < 0.5).astype(np.float32))
            compare_scan(torch, twf, frames_t, pal32, geom, aux, errs,
                         f"{mode} {hybrid or ''} {name} P={N_COLORS}")
    # The sensitivity map: the card's eager float32 ops against numpy's.
    for name, arr in small.items():
        sens = twf.perceptual_sensitivity(on_card(arr)).cpu().numpy()
        check(np.array_equal(sens.view(np.uint32), sensitivity_np(arr).view(np.uint32)),
              f"sensitivity map on the card != numpy ({name})")
    fs = twf.scan_geometry("floyd_steinberg")
    ostro = twf.scan_geometry("", "ostromoukhov")
    small_u8 = on_card(small["u8"])
    for p in (65, 256, 1024):
        compare_scan(torch, twf, small_u8, on_card(unique_palette(rng, p)), fs, None, errs,
                     f"fixed FS P={p}")
    pal2048 = on_card(unique_palette(rng, 2048))
    compare_scan(torch, twf, small_u8, pal2048, fs, None, errs, "fixed FS P=2048", indexed=True)
    compare_scan(torch, twf, on_card(small["f32"]), pal2048, ostro, None, errs,
                 "ostromoukhov P=2048", indexed=True)
    # The largest palette K8 takes: with ostromoukhov's weight table it
    # asks for the most shared memory the kernel ever does (195 KB).
    p_max = twf.INDEX_PALETTE_MAX
    compare_scan(torch, twf, small_u8, on_card(unique_palette(rng, p_max)), ostro, None, errs,
                 f"ostromoukhov P={p_max}", indexed=True)
    try:
        twf.scan_idx(twf.skew(small_u8, fs.s), on_card(unique_palette(rng, p_max + 1)), fs, w)
    except ValueError:
        pass
    else:
        raise SmokeFailure(f"scan_idx took a palette of {p_max + 1} colours")
    # Planted duplicates: a later copy of a colour must never be chosen.
    for p, dups in ((600, ((3, 100), (3, 550), (7, 299))),
                    (2048, ((3, 100), (3, 1500), (7, 2047), (40, 1025)))):
        pal_np = unique_palette(rng, p)
        for src, dst in dups:
            pal_np[dst] = pal_np[src]
        ties = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
        ties[0] = pal_np[3].astype(np.uint8)  # flat frames: exact d2 = 0 ties
        ties[1] = pal_np[7].astype(np.uint8)
        ties[2, :, : w // 2] = pal_np[dups[-1][0]].astype(np.uint8)
        ties_t, pal_t = on_card(ties), on_card(pal_np)
        if p <= twf.PACKED_PALETTE_MAX:
            compare_scan(torch, twf, ties_t, pal_t, fs, None, errs, f"planted ties P={p}")
        idx = compare_scan(torch, twf, ties_t, pal_t, fs, None, errs, f"planted ties P={p}",
                           indexed=True).cpu().numpy()
        check(not np.isin(idx, [dst for _, dst in dups]).any(),
              f"a later duplicate's index was emitted (P={p})")
        # Frames 0 and 1 are flat on palette colours 3 and 7: each of their
        # pixels is an exact hit (the stream is 0 outside the image, and so
        # is the index there).
        check(np.isin(idx[:, 0], [0, 3]).all() and np.isin(idx[:, 1], [0, 7]).all(),
              f"flat frames did not resolve to the first copy (P={p})")
    log(f"[8] kernel == plain, bitwise, B={b} {h}x{w}: K2 in 4 modes (hybrid at 2 factor "
        f"pairs) x (u8, f32) at P={N_COLORS}, fixed at P in (65, 256, 1024); K8 and K9: fixed "
        f"and ostromoukhov at P=2048, ostromoukhov at P={p_max} (the largest K8 takes; "
        f"{p_max + 1} colours refused); planted "
        f"duplicates at P=600 (K2, K8) and P=2048 (K8): no later index emitted; sensitivity "
        f"map == numpy bitwise ({time.perf_counter() - t0:.1f} s)")

    # --- kernel == plain at full size ------------------------------------
    pal32_np = np.asarray(palette32, np.float32)
    pal32_t = on_card(pal32_np)
    full2_np = np.stack(gold_frames)
    full2 = on_card(full2_np)
    t0 = time.perf_counter()
    for mode in ED_MODES:
        geom, aux = mode_setup(mode, full2, full2_np)
        compare_scan(torch, twf, full2, pal32_t, geom, aux, errs,
                     f"{mode} P={N_COLORS} k-means")
    log(f"[8] kernel == plain, bitwise: K2 in {', '.join(ED_MODES)} at B=2 "
        f"{FULL_H}x{FULL_W} P={N_COLORS} k-means ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    palettes = {p: dpt.ColorReducer.generate_kmeans_palette(Image.fromarray(frame0), p, device=dev)
                for p in (64, 1024)}
    palettes[256] = palette256
    sd16 = np.stack([synth_image(SD_H, SD_W, 200 + i) for i in range(BATCH)])
    palettes[2048] = dpt.ColorReducer.generate_kmeans_palette(
        Image.fromarray(sd16[0]), 2048, device=dev)
    sync(torch, dev)
    pals_np = {p: np.asarray(v, np.float32) for p, v in palettes.items()}
    pals_t = {p: on_card(v) for p, v in pals_np.items()}
    log(f"[8] k-means palettes of 64, 1024 and 2048 colours on the card: "
        f"{time.perf_counter() - t0:.1f} s; distinct colours "
        f"{ {p: len(np.unique(v, axis=0)) for p, v in pals_np.items()} }")
    t0 = time.perf_counter()
    compare_scan(torch, twf, full2[:1], pals_t[256], fs, None, errs, "fixed FS P=256 k-means")
    sd2 = on_card(sd16[:2])
    compare_scan(torch, twf, sd2, pals_t[2048], fs, None, errs, "fixed FS P=2048 k-means",
                 indexed=True)
    log(f"[8] kernel == plain, bitwise: K2 FS at B=1 {FULL_H}x{FULL_W} P=256 k-means; K8 and "
        f"K9 FS at B=2 {SD_H}x{SD_W} P=2048 k-means ({time.perf_counter() - t0:.1f} s)")

    # --- golden anchor ---------------------------------------------------
    def golden_all(jobs):
        with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
            return list(ex.map(lambda job: job(), jobs))

    def gold_fixed(frame, pal_np):
        return lambda: golden_frame(lib, ed_kernels.kernel_arrays, frame, pal_np,
                                    "floyd_steinberg")

    def gold_mode(frame, pal_np, mode):
        gate = adaptive._gates(frame[None])[0] if mode == "adaptive" else None
        return lambda: golden_mode_frame(lib, frame, pal_np, mode, gate=gate)

    for mode in ED_MODES:
        _, aux = mode_setup(mode, full2, full2_np)
        out = twf.ed_batch_wavefront(full2, pal32_t, mode, aux=aux).cpu().numpy()
        golds = golden_all([gold_mode(f, pal32_np, mode) for f in gold_frames])
        idents = [identity(o, g) for o, g in zip(out, golds)]
        log(f"[8] golden anchor (ed_{mode}_f32, k-means-32, 2 x {FULL_H}x{FULL_W}): "
            f"identity {idents}")
        check(all(v == 1.0 for v in idents), f"golden identity {idents} != 1.0 ({mode})")
    for p, frames_t, frames_np in ((256, full2, full2_np), (2048, sd2, sd16[:2])):
        out = twf.ed_batch_wavefront(frames_t, pals_t[p]).cpu().numpy()
        golds = golden_all([gold_fixed(f, pals_np[p]) for f in frames_np])
        idents = [identity(o, g) for o, g in zip(out, golds)]
        log(f"[8] golden anchor (ed_fixed_f32, floyd_steinberg, k-means-{p}, 2 x "
            f"{frames_np.shape[1]}x{frames_np.shape[2]}): identity {idents}")
        check(all(v == 1.0 for v in idents), f"golden identity {idents} != 1.0 (P={p})")

    # --- the main paths, each with its own launch counts -----------------
    ed = dpt.DitherMode.ERROR_DIFFUSION
    fs_params = {"variant": "floyd_steinberg"}
    paths = [  # (name, mode enum, wavefront mode, palette, params, frames, kernels)
        ("FS k-means-256", ed, "fixed", 256, fs_params, frames16, KERNELS),
        ("OSTROMOUKHOV k-means-32", dpt.DitherMode.OSTROMOUKHOV, "ostromoukhov", 32, {},
         frames16, KERNELS),
        ("HYBRID k-means-32", dpt.DitherMode.HYBRID, "hybrid", 32, {}, frames16, KERNELS),
        ("PERCEPTUAL k-means-32", dpt.DitherMode.PERCEPTUAL, "perceptual", 32, {}, frames16,
         KERNELS),
        ("ADAPTIVE_VARIANCE k-means-32", dpt.DitherMode.ADAPTIVE_VARIANCE, "adaptive", 32, {},
         frames16, KERNELS),
        ("FS k-means-2048 480p", ed, "fixed", 2048, fs_params, sd16, [KERNELS[0]] + IDX_KERNELS),
    ]
    palettes[32], pals_np[32] = palette32, pal32_np
    totals = {}
    ditherer256 = out256 = None
    for name, dmode, wmode, p, params, frames, kernels in paths:
        ditherer = dpt.ImageDitherer(num_colors=p, dither_mode=dmode, palette=palettes[p],
                                     dither_params=params, device=dev)
        if p == 256:
            ditherer256 = ditherer  # timed below
        single = frames[0] if p == 2048 else frame0
        build.reset_launch_counts()
        out = ditherer.apply_dithering_batch(frames)
        out_pil = np.asarray(ditherer.apply_dithering(Image.fromarray(single)))
        sync(torch, dev)
        launches = dict(build.LAUNCHES)
        if p == 256:
            out256 = out  # held to the golden engine below; the timed path's reference
        for key, _, _ in kernels:
            check(launches.get(key, 0) >= 1, f"kernel {key} not launched on the {name} path")
            totals[key] = totals.get(key, 0) + launches[key]
        check(set(launches) == {k for k, _, _ in kernels},
              f"{name} path launched {launches}")
        check(out.shape == frames.shape and out.dtype == np.uint8,
              f"{name} batch output {out.shape} {out.dtype}")
        check(out_pil.shape == single.shape and out_pil.dtype == np.uint8,
              f"{name} apply_dithering output {out_pil.shape}")
        check(palette_only(out, pals_np[p]) and palette_only(out_pil, pals_np[p]),
              f"{name} output holds colours outside the palette")
        make = ((lambda f: gold_fixed(f, pals_np[p])) if wmode == "fixed"
                else (lambda f: gold_mode(f, pals_np[p], wmode)))
        t0 = time.perf_counter()
        golds = golden_all([make(f) for f in [*frames, single]])
        idents = [identity(o, g) for o, g in zip(out, golds)]
        ident_s = identity(out_pil, golds[-1])
        log(f"[8] main path {name}: launches {launches}; apply_dithering_batch {out.shape} "
            f"uint8, palette-only, golden identity of the {len(idents)} frames {idents}; "
            f"apply_dithering(PIL {single.shape[1]}x{single.shape[0]}) golden identity "
            f"{ident_s} (golden engine {time.perf_counter() - t0:.1f} s)")
        check(all(v == 1.0 for v in idents) and ident_s == 1.0,
              f"{name} golden identity {idents}, {ident_s}")
    for row in rows:
        row["launches"] += totals.get(row["name"], 0)
    scan_row = next(row for row in rows if row["name"] == "ed_scan")

    # --- times, each beside the card --------------------------------------
    # Every timed launch runs the main paths' own shapes (the batch of 16),
    # so its output is held to the plain version's on the same stream.
    batch_t = on_card(frames16)

    def timed_scan(what, stream, pal_t, geom, aux, reps):
        ms, got = cuda_ms(torch, lambda: twf.scan(stream, pal_t, geom, FULL_W, aux), reps)
        plain_ms, want = cuda_ms(
            torch, lambda: twf.scan_plain(stream, pal_t, geom, FULL_W, aux), 1, warmup=False)
        err = (got.to(torch.float64) - want.to(torch.float64)).abs().max().item()
        errs["ed_scan"] = max(errs["ed_scan"], err)
        check(torch.equal(got, want), f"ed_scan kernel != plain version ({what}, "
                                      f"{BATCH}x{FULL_H}x{FULL_W}, max abs err {err})")
        return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                **scan_bound(BATCH, FULL_H, FULL_W, geom.s, pal_t.shape[0],
                             len(geom.weights), aux=aux is not None)}

    def timed_line(entries, prefix=""):
        return ", ".join(f"{prefix}{k} {v['ms']:.3f} ms (plain {v['plain_ms']:.0f} ms)"
                         for k, v in entries.items())

    mode_ms = {}
    for mode in ["fixed"] + ED_MODES:
        geom, aux = mode_setup(mode, batch_t, frames16)
        mode_ms[mode] = timed_scan(f"{mode} P={N_COLORS}", twf.skew(batch_t, geom.s),
                                   pal32_t, geom, aux, 5)
    log(f"[8] ed_scan (K2) per mode, {BATCH}x{FULL_H}x{FULL_W} k-means-32 (fixed = "
        f"floyd_steinberg), each equal to its plain version bitwise: {timed_line(mode_ms)} "
        f"[{card}]")
    stream = twf.skew(batch_t, fs.s)
    size_ms = {str(p): timed_scan(f"FS P={p}", stream, pals_t[p], fs, None, 3)
               for p in (64, 256, 1024)}
    log(f"[8] ed_scan (K2) by palette size, {BATCH}x{FULL_H}x{FULL_W} floyd_steinberg "
        f"k-means, each equal to its plain version bitwise: {timed_line(size_ms, 'P=')} "
        f"[{card}]")
    scan_row["modes_ms"] = mode_ms
    scan_row["palette_ms"] = size_ms
    path_ms, path_out = cuda_ms(
        torch, lambda: twf.ed_batch_wavefront(batch_t, pals_t[256]), 3)
    check(np.array_equal(path_out.cpu().numpy(), out256),
          "the timed FS k-means-256 device path != the main path's output")
    log(f"[8] device path K1+K2+K3, FS k-means-256 (tensors on the card): {path_ms:.3f} "
        f"ms/batch{BATCH} -> {BATCH / path_ms * 1e3:.2f} fps, output equal to the main "
        f"path's [{card}]")

    sd_t = on_card(sd16)
    sd_stream = twf.skew(sd_t, fs.s)
    sd_idx = twf.scan_idx(sd_stream, pals_t[2048], fs, SD_W)
    timed = {
        "ed_scan_idx": (lambda: twf.scan_idx(sd_stream, pals_t[2048], fs, SD_W),
                        lambda: twf.scan_idx_plain(sd_stream, pals_t[2048], fs, SD_W)),
        "unskew_select": (lambda: twf.unskew_select(sd_idx, pals_t[2048], fs.s, SD_H, SD_W),
                          lambda: twf.unskew_select_plain(sd_idx, pals_t[2048], fs.s, SD_H,
                                                          SD_W)),
    }
    d_sd = twf.stream_length(SD_H, SD_W, fs.s)
    n_sd = BATCH * SD_H * SD_W
    bounds = {"ed_scan_idx": scan_bound(BATCH, SD_H, SD_W, fs.s, 2048, len(fs.weights)),
              "unskew_select": bound(d_sd * BATCH * SD_H * 4 + 2048 * 12 + n_sd * 3, 0)}
    new_rows = []
    for key, source, replaces in IDX_KERNELS:
        kern, plain = timed[key]
        ms, got = cuda_ms(torch, kern, 3)
        slow = key == "ed_scan_idx"  # its plain version runs for seconds
        plain_ms, want = cuda_ms(torch, plain, 1 if slow else 3, warmup=not slow)
        err = (got.to(torch.float64) - want.to(torch.float64)).abs().max().item()
        errs[key] = max(errs[key], err)
        check(torch.equal(got, want), f"{key} kernel != plain version on the "
                                      f"{BATCH}x{SD_H}x{SD_W} batch (max abs err {err})")
        log(f"[8] {key}: kernel {ms:.3f} ms, plain PyTorch {plain_ms:.3f} ms per "
            f"{BATCH}x{SD_H}x{SD_W} FS k-means-2048 batch, outputs equal bitwise [{card}]")
        new_rows.append({"name": key, "route": "cuda", "source": source, "replaces": replaces,
                         "launches": totals[key], "max_abs_err": errs[key], "ms": ms,
                         "plain_ms": plain_ms, **bounds[key]})
    scan_row["max_abs_err"] = errs["ed_scan"]

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ditherer256.apply_dithering_batch(frames16)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    log(f"[8] apply_dithering_batch wall, FS k-means-256 (numpy u8 in/out): median "
        f"{wall * 1e3:.3f} ms/batch{BATCH} -> {BATCH / wall:.2f} fps (5 runs: "
        f"{', '.join(f'{t * 1e3:.3f}' for t in walls)}) [{card}]")
    return new_rows


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
    """Phases 1-8 on ``dev``; prints the result lines and returns 0, or
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
    compare_kernels(torch, twf, dev, full2, pal_t, DEEP_VARIANTS, errs)
    log(f"[3] kernel == plain, bitwise: {', '.join(DEEP_VARIANTS)} at B=2 "
        f"{FULL_H}x{FULL_W} P={N_COLORS} k-means ({time.perf_counter() - t0:.1f} s)")
    # apply_dithering hands the kernels one float32 frame (B=1).
    t0 = time.perf_counter()
    compare_kernels(torch, twf, dev,
                    torch.from_numpy(frame0[None].astype(np.float32)).to(dev),
                    pal_t, ["floyd_steinberg"], errs)
    log(f"[3] kernel == plain, bitwise: floyd_steinberg on one float32 "
        f"{FULL_H}x{FULL_W} frame (B=1) P={N_COLORS} k-means "
        f"({time.perf_counter() - t0:.1f} s)")

    # 4. Golden anchor: FS (the main path) first, then three other variants
    # at the same size.
    lib = golden_engine(build.BUILD_DIR / "golden")
    gold_frames = [synth_image(FULL_H, FULL_W, 100 + i) for i in range(2)]
    gold_t = torch.from_numpy(np.stack(gold_frames)).to(dev)
    for variant in DEEP_VARIANTS:
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
    path_ms, path_out = cuda_ms(torch, lambda: twf.ed_batch_wavefront(batch_t, pal_t), 5)
    check(np.array_equal(path_out.cpu().numpy(), out16),
          "the timed device path != the main path's output")
    log(f"[6] device path K1+K2+K3 (tensors on the card): {path_ms:.3f} "
        f"ms/batch{BATCH} -> {BATCH / path_ms * 1e3:.2f} fps, output equal to the main "
        f"path's [{card}]")
    timed = {
        "skew": (lambda: twf.skew(batch_t, geom.s),
                 lambda: twf.skew_plain(batch_t, geom.s)),
        "ed_scan": (lambda: twf.scan(stream, pal_t, geom, FULL_W),
                          lambda: twf.scan_plain(stream, pal_t, geom, FULL_W)),
        "unskew_unpack": (lambda: twf.unskew_unpack(col, geom.s, FULL_H, FULL_W),
                          lambda: twf.unskew_unpack_plain(col, geom.s, FULL_H,
                                                          FULL_W)),
    }
    d_fs = twf.stream_length(FULL_H, FULL_W, geom.s)
    n_px = BATCH * FULL_H * FULL_W
    bounds = {  # bytes: inputs read once, outputs written once
        "skew": bound(n_px * 3 + d_fs * 3 * BATCH * FULL_H, 0),
        "ed_scan": scan_bound(BATCH, FULL_H, FULL_W, geom.s, N_COLORS,
                              len(geom.weights)),
        "unskew_unpack": bound(d_fs * BATCH * FULL_H * 4 + n_px * 3, 0),
    }
    rows = []
    for key, source, replaces in KERNELS:
        kern, plain = timed[key]
        ms, got = cuda_ms(torch, kern, 5)
        plain_ms, want = cuda_ms(torch, plain, 1 if key == "ed_scan" else 3)
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
                     "plain_ms": plain_ms, **bounds[key]})

    # One traced call: how much of the wall time the device is busy.
    report_trace(torch, 6, "apply_dithering_batch FS",
                 lambda: ditherer.apply_dithering_batch(frames16), frames16.nbytes, card)
    # The k-means-256 path of phase 8 is traced here too: a trace taken
    # right after another keeps its device records, one taken after the
    # long untraced stretches of phases 7 and 8 loses them.
    palette256 = dpt.ColorReducer.generate_kmeans_palette(
        Image.fromarray(frame0), 256, device=dev)
    ditherer256 = dpt.ImageDitherer(
        num_colors=256, dither_mode=dpt.DitherMode.ERROR_DIFFUSION,
        palette=palette256, dither_params={"variant": "floyd_steinberg"}, device=dev)
    ditherer256.apply_dithering_batch(frames16)
    report_trace(torch, "6-256", "apply_dithering_batch FS k-means-256",
                 lambda: ditherer256.apply_dithering_batch(frames16), frames16.nbytes, card)

    # 7. The ordered path.
    rows.append(ordered_phase(torch, dev, card, frames16, gold_frames))

    # 8. The rest of the error-diffusion family.
    rows.extend(ed_modes_phase(torch, dev, card, lib, frames16, frame0, palette,
                               palette256, gold_frames, rows, errs))

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
