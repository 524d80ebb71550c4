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
   P=32, K2 at P = 64, 256, 1024 (FS), K8 and K9 at 16 x 480p P=2048 (K9
   also beside the one PyTorch call that computes it, pal_u8[idx.as_strided
   (...)] over the truncated u8 palette table, its library_ms), and the
   k-means-256 batch wall (its traced call is phase 6's second trace);
   then K9 (``select_phase``: the "select" kind of unskew_unpack.cu's tile
   kernel after its palette-packing kernel) == plain bitwise at P in
   (1025, 2048, 4096, 16384) on palettes with fractional entries and
   planted duplicates, at phase 13's odd shapes (widths W <= s among them),
   s = 2 and 3, streams whole and off the 16-byte boundary, into outputs
   1-15 bytes off the boundary with random bytes around them (untouched),
   and on the index scan's 480p streams at 2048 and 16384 colours; K9's
   row times (kernel and library call in CUDA graphs of 100, the kernel
   also by CUDA events) at 2048 and 16384 colours beside the bound, and in
   the same run K3's NHWC kind and K5's u8 and u16 kinds of the same tile
   kernel at 16 x 1080p FS k-means-32 (each == plain, in CUDA graphs of
   100);
9. the video pipeline's two transfer shapes, the index stream and planar
   batches: K5 (unskew of the index stream, u8 and u16), K6 (skew of
   compact planes) and K3's planar layout held to their plain versions
   bitwise at B=3 37x53 (s = 2 and 3; P in {32, 256, 257, 1024}; random
   indices and the scan's own; u8 and f32 planes) and at 16 x 1080p, K6's
   stream held to K1's for the same frames, K3's planes to its NHWC output
   transposed, and the index pack on the card to its CPU result (1, 2 and
   4 bits, W = 1920 and 53); then the main paths, each with the launch
   counts set to 0 before it and read after it and each checked for shape,
   dtype and palette-only colours: FS k-means-32 with the index stream
   forced on (== phase 5's output on all 16 frames; skew, ed_scan_idx and
   unskew_idx launched, unskew_unpack not), k-means-16 (the 4-bit packed
   stream, pack on and off, 2 frames held to the golden engine),
   k-means-256 at 1080p (u8) and k-means-300 at 480p (u16), Bayer 8x8 pico8
   through K4's indices (== phase 7's output), perceptual k-means-32, and
   apply_dithering_batch(planes, planar=True) without and with the index
   stream (== the NHWC result transposed; skew_planar launched, skew not);
   supports_planar_batch for ED, Bayer and 2048 colours; with
   DITHER_PIE_TPU_INDEX_TRANSFER unset, the link probe's MB/s, the host
   gather's ns a pixel, the verdict and the path the facade then takes; then
   the times: K5, K6 and K3's planar layout beside their plain versions (K5
   also beside the one PyTorch call that computes it, its library_ms, and
   that call's uint16 form where this torch casts to uint16 on CUDA), the
   batch walls of the index
   and planar paths beside their RGB and NHWC walls, and inside the index
   walls the device-to-host copy, the host unpack and the host palette
   gather. Two index-stream calls (k-means-32, k-means-16 packed) are
   traced in phase 6, right after its other traces;
10. the dense-search path and the transposing skew: K7 (skew_transpose,
   skew.cu's tile kernel in the type pairs u8 -> u8, f32 -> f32 and u8 ->
   f32) held to its plain version and to K1's and K6's streams bitwise and
   everywhere (B=3 37x53, s = 2 and 3, u8 and f32, NHWC and planes, R = 5,
   widths W <= s, u8 -> f32, one float32 1080p frame, the u8, u8 -> f32
   and float32 16 x 1080p batches, NHWC and planes), with the times of K7's
   three forms, K1, K6 and the permute(2, 0, 1).contiguous() call of the
   padded stride-lemma form from the same run; the dispatching wrappers
   send float32 and uint8 frames to K1 and K6; K2's and K8's score branch (dense_search="mxu") held to
   scan_plain / scan_idx_plain bitwise in the five modes at B=3 37x53 with
   P in {65, 100, 256, 1024}, u8 and f32, on planted duplicate colours and
   flat frames, P = 64 and P = 2048 equal to the exact output (the branch
   is not taken), one 1080p frame at k-means-256, and the timed 16 x 1080p
   k-means-256 and -1024 launches held to one plain run each beside the
   exact search's time; the main path ImageDitherer(ERROR_DIFFUSION),
   k-means-256, 16 x 1080p u8, numpy in and out, with
   DITHER_PIE_TPU_DENSE_SEARCH=mxu and then auto (the first call runs both
   searches, the second one), each with its launch counts, its wall beside
   the exact wall, the score output's identity and 4x4 block-mean error
   against the exact output (the gate's two block thresholds must hold;
   the identity is a measurement, and the gate's verdict must follow from
   the three numbers) and its golden identity on 2 frames (printed; the
   exact output's must be 1.0), the gate's other verdict on small random
   frames,
   the same through the index stream and planar (== the RGB NHWC score
   output), and one PIL image through apply_dithering (one float32 frame:
   skew, ed_scan and unskew_unpack launched; golden identity 1.0 in exact
   mode); K7's own path (its wrapper on that frame in its three type pairs,
   NHWC and planes, with its launch counts; no facade call reaches it);
   T2, the search probe (a frame over a cluster of n blocks, as the scan):
   both kernels held to their plain versions bitwise at 256 and 1024
   colours for every n in (1, 2, 4, 8), 1 and 64 repetitions, their
   microseconds a repetition, the flip fraction of score against exact on
   random and on k-means inputs, the n sweep at 64, 256 and 1024 colours
   and its fit c_n + k * P / n, and the row's times (a repetition of one
   launch of 64, one launch in a CUDA graph of 100). The k-means-256 call
   in score mode is traced in phase 6, right after the exact one;
11. wavelet and halftone, K4 on float32 frames, and the probes T1 and T3:
   K4's float32 instantiation held to its plain version bitwise at B=3 37x53
   with P in {2, 16, 33, 300} on non-integer frames (random and Bayer
   screens, colours and indices), on flat float32 frames of exact ties, and
   at 16 x 1080p on a wavelet reconstruction with the k-means-32 palette
   (timed beside the u8 instantiation and the plain version);
   integer-valued float32 frames must give the u8 frames' output; the main
   paths ImageDitherer(WAVELET haar/8/42), (WAVELET db4/16/7), (HALFTONE
   defaults) and (HALFTONE cell 6, 30 degrees, diamond), each
   apply_dithering_batch on the 16 frames of phase 5 and apply_dithering on
   one of them as a PIL image (== the batch's frame), with the launch
   counts set to 0 before and read after (wavelet launches ordered_fused,
   halftone nothing), shape, dtype, palette-only colours, the index stream
   forced on == the RGB output, the card == the CPU device
   (``device="cpu"``, the plain path) bitwise on 2 frames, identity with a
   numpy float64 twin of the mode on 2 frames (wavelet >= 0.98, halftone >=
   0.995) and the batch wall (median of 5); the device times of the
   wavelet's stages and of halftone; T1, the gather probe
   (``gather_phase``; the forms of ``gather_slab_plan``: block, multicast
   lane slabs, distributed lane slabs): the gather held to its plain
   version and to np.take_along_axis at 64, 512, 1024, 4096 and 16384
   rows, both chains ("chain" and "sweep") at 256 to 16384 rows (k = 1 and
   68), the gather and the chains on output rows that are not the table's
   ((512, 37), (1024, 333), (4096, 1001), (7169, 50), (16384, 777)), a
   table off the 16-byte boundary, and the L2 line (the block body on the
   table in device memory) at every height of the tool; the launcher's
   refusals (a table off the boundary, lanes % 8 != 0, a plan that is not
   the plan function's, a multicast cluster of 4, a cluster of 16, the
   wrong form);
   the select sweep to its plain version at P = 64, 256, 1024 (k = 3) and,
   at k = 1026, to the gather chain on its tile, then the tool's lines
   (microseconds a gather by table height and form beside the L2 line, a
   sweep step beside a gather on the same tile) with the launch counts of
   that run, and the row's times (the gather alone at 4096 rows,
   torch.gather, the L2 line, an empty kernel and the 4 MB copy idx -> out,
   each in a CUDA graph of 100);
   T3, the identity (``identity_phase``): == its input and == clone() at
   (3, 2160, 1920), an odd size, a view off the 16-byte boundary and 15
   bytes, and pairs of views into outputs at chosen offsets that agree and
   disagree mod 16 (the bulk form and the shifted one; the bytes around
   each output untouched), one 100 x 1080p plane timed beside clone() (GB/s
   beside the 3.35 TB/s of the bounds) in the bulk form and in the shifted
   form (the plane less its first byte), the layout harness at
   3 x 100 frames (temporary bytes over the arguments') and its chain
   through K4 at 3 x 16;
12. K2 and K8 over thread-block clusters (one frame on n blocks whose ranks
   search contiguous slices of the palette, ``ops.wavefront.
   scan_cluster_plan``): both held to scan_plain / scan_idx_plain bitwise
   at B=1, 3, 17, 33, 133 x 37x53 with P in {2, 3, 7, 33, 65, 100, 1023,
   2049}, at the plan's n and at every n <= min(8, P); in the five modes,
   u8 and float32, at P=33 and at P=100 with both searches; on colours
   planted on both sides of every slice boundary (the lower index must win)
   and on exact ties across the first boundary; the plan's n at 1080p for
   the same batch sizes (8 down to 1) and the clusters the card holds at
   once for the main path's launches;
13. K1 and K3, the tile transposes (``ops.wavefront.skew_tile_plan``,
   ``unskew_tile_plan``): K1 (u8 and float32) == skew_plain and == K7's
   stream, K7's u8 -> f32 form == K1's stream cast, K3 (NHWC and planar)
   == unskew_unpack_plain, bitwise, at the
   shapes of tests/test_torch_skew_tiles.py (B in 1, 3, 17; H in 1, 7, 8,
   33, 64, 65; W in 1, 2, 3, 5, 21, 64, 65; s = 2 and 3), whole and as
   contiguous slices whose base lies off the 16-byte boundary, K1 into
   outputs off a sector boundary, and on 2 x 1080 x 1919 slices (the 16 x
   1080p batch's holds are phase 6's, 9's and 10's);
14. K6 as K1's one-channel tile transpose (``skew_tile_plan(...,
   channels=1)``) and K4's two bodies (``ops.ordered_fused.ordered_plan``;
   the integer body for u8 frames and a palette of integers in 0..255, the
   float body otherwise): K6 (u8 and float32) == skew_planar_plain and ==
   K7's stream (and K1's for planes of frames), K7's u8 -> f32 form on
   planes == K6's stream cast, at R in (1, 3, 5, 48)
   planes of odd sizes, s = 2 and 3, whole, as slices off the 16-byte
   boundary and into outputs off a sector, and on the 48 planes of the 16 x
   1080p batch; K4 == ordered_dither_fused_plain, colours and indices, at
   P in (1, 2, 16, 33, 256, 300, 4096) on odd shapes (u8 through both
   bodies, float32 frames, whole and as slices), on flat frames of exact
   ties and a palette with planted duplicates, and at 16 x 1080p (pico8
   through both bodies, float32 frames with a k-means-32 palette, one copy 3
   bytes off the boundary); then the planar main path == the NHWC main
   path's output;
15. K5 as the index kinds of K3's tile transpose (``unskew_tile_plan(...,
   "u8" / "u16")``): == unskew_idx_plain bitwise at the odd shapes of phase
   13, on indices each type holds, whole and as slices off the 16-byte
   boundary, into fresh outputs and outputs off the boundary (through the
   binding), on 2 x 1080 x 1919 slices, and on the index scan's uint16
   streams of 16 x 1080p at 300 and 1024 colours;
16. the host engine (the scans with no wavefront): the port's
   dither_pie_tpu_torch/native/ed_scan.cpp built with g++, then FS,
   Stucki and Ostromoukhov serpentine and Riemersma on the 16 1080p frames
   at k-means-32 through apply_dithering_batch, every frame == the golden
   engine's float32 twin (Riemersma along the port's hilbert_path), and
   one serpentine 1080p image through apply_dithering == the golden
   engine's float64 ed_fixed; fps and the thread count;
17. the streaming video pipeline: process_frames on synthetic 720p frames
   (moving gradients and noise from --seed, default 0), legs (a)
   BASELINE.md config 4 (101 frames, Stucki, median-cut 16 from frame 0),
   (b) examples/video_basic.json's settings (regular pixelize to 240, x2
   final resize, 37 frames), (c) Bayer 8x8 pico8, (d) FS serpentine (17
   frames), (e) the planar FS flow, each with overlap on and off: every
   frame == apply_dithering_batch in the same batches, (a) == the golden
   engine on 2 frames, planar == interleaved, overlap == serial, no batch
   call raised (nothing retried or patched), K1, K2, K3, K4 and K6
   launched; fps serial and overlapped (leg (a) is traced in phase 6, as
   a late trace loses its device records: its idle share), and, where
   ffmpeg is on PATH, leg (a) end to end through
   VideoProcessor on a clip ffmpeg encodes from the frames (else one line
   says that leg did not run);
18. the neural pixelizer, BASELINE.md config 5 (bench.py's): 8 synthetic
   1080p frames through process_frames(..., pixelize_func=("neural",
   128), batch_size=8) with load_random(0) weights installed as the card's
   pixelizer (the net's input 8 x 512x912 at the model's full widths),
   then HYBRID at k-means-32 from the pixelized frame 0. Holds: K1, K2 and
   K3 launched; the output == apply_dithering_batch of the same pixelized
   frames bitwise and 2 frames == the golden engine's hybrid twin; ds4 on
   == ds4 off bitwise in float32; the card's float32 forward == the port's
   CPU forward within 1e-4 (u8 within one step) at 2 x 64x96. Prints what
   the first-batch gates locked, fps (best of 2 warm runs) with ds4 on and
   off, the device ms of one batched forward in float32, tensorfloat32 and
   bfloat16 (CUDA events) with their mean |u8 delta| against float32, the
   stage report, the idle share of one traced run (traced in phase 6, as
   leg (a) is) and the phase's seconds; and what the whole run took of its
   1200 s limit.

Phases 1-8 run with DITHER_PIE_TPU_INDEX_TRANSFER=0 (the RGB path, whatever
the link probe would say); phases 9 to 11 set it as each check needs.
DITHER_PIE_TPU_DENSE_SEARCH is unset (the exact search) outside phase 10's
main paths and phase 6's one score-mode trace. Phases 3-9 hold K1 and K6
themselves (``skew_gather``, ``skew_planar_gather``) where they hold a skew
to its plain version; ``skew`` and ``skew_planar`` send frames of either
dtype there too.

Every row of the kernels line carries the kernel's bound: the larger of its
bytes (inputs read once, outputs written once; of the (D, B, H) stream an
unskew needs only the B*H*W entries inside the image) over 3.35 TB/s and its
float32 operations over 67 TFLOP/s, the card's published peaks. The rows of
the scans K2 and K8, and each entry of K2's ``modes_ms`` and ``palette_ms``,
carry ``chain_bound_ms`` beside it: the serial chain of D wavefront steps
at 0.1 us a step, the least latency one step is taken to have (a
block-wide barrier, one trip through shared memory or L1, and about 25
dependent float instructions). Each timed scan (those and ``score_ms``'s
entries) also carries ``n``, the cluster size its launch ran with.

The lines before the last are a JSON object {"kernels": [...]} and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
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
RUN_LIMIT_S = 1200  # the time this script must finish in, its build included
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


def scan_bound(b, h, w, s, p, n_entries, in_bytes=1, aux=False, score=False):
    """Bound of K2 / K8: the stream and the palette (and the aux map) read
    once, the (D, B, H) int32 output written once; per pixel the fold (a
    multiply and an add per channel and entry), the search (3 subtracts, 3
    multiplies, 2 adds per colour; with ``score`` 3 multiplies and 3 adds
    over an augmented palette of 16 bytes a colour) and the error (3
    subtracts). Beside it
    ``chain_bound_ms``: the D steps follow one another, each at least
    CHAIN_STEP_US long."""
    d = w + s * (h - 1)
    n_bytes = (d * 3 * b * h * in_bytes + p * (16 if score else 12) + d * b * h * 4
               + (b * h * w * 4 if aux else 0))
    per_colour = 6 if score else 8
    return {**bound(n_bytes, b * h * w * (6 * n_entries + per_colour * p + 3)),
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
    ("unskew_select", "dither_pie_tpu_torch/kernels/csrc/unskew_unpack.cu",
     "dither_pie_tpu/ops/wavefront.py:1709"),
]
TRANSFER_KERNELS = [  # the index stream and the planar layout
    ("unskew_idx", "dither_pie_tpu_torch/kernels/csrc/unskew_unpack.cu",
     "dither_pie_tpu/ops/wavefront.py:1636"),
    ("skew_planar", "dither_pie_tpu_torch/kernels/csrc/skew.cu",
     "dither_pie_tpu/ops/wavefront.py:1352"),
]
DENSE_KERNELS = [  # the transposing skew and the search probe
    ("skew_transpose", "dither_pie_tpu_torch/kernels/csrc/skew.cu",
     "dither_pie_tpu/ops/wavefront.py:371"),
    ("search_probe", "dither_pie_tpu_torch/kernels/csrc/search_probe.cu",
     "tools/proto_mxu_search.py:78"),
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
        stream = twf.skew_gather(frames, geom.s)
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
    """The float32 twins of every mode and the float64 ed_fixed from
    dither_pie_tpu/native/ed_scan.cpp, compiled with the JAX package's own
    flags (no FMA contraction) and loaded by ctypes."""
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
    lib.ed_riemersma_f32.argtypes = head + [i32p, ctypes.c_int64]
    lib.ed_fixed.argtypes = head + [i32p, f32p, c_i, c_i]
    for fn in (lib.ed_fixed_f32, lib.ed_ostromoukhov_f32, lib.ed_hybrid_f32,
               lib.ed_perceptual_f32, lib.ed_adaptive_f32, lib.ed_riemersma_f32,
               lib.ed_fixed):
        fn.restype = None
    return lib


def golden_frame(lib, kernel_arrays, frame, pal, variant, serpentine=False, exact=False):
    """One frame through the golden engine's ed_fixed_f32 (``exact``: the
    float64 ed_fixed), row-major or serpentine."""
    work = np.ascontiguousarray(frame, dtype=np.float32).copy()
    offs, wts = kernel_arrays(variant)
    h, w, _ = work.shape
    fn = lib.ed_fixed if exact else lib.ed_fixed_f32
    fn(work, h, w, np.ascontiguousarray(pal, np.float32), pal.shape[0], offs, wts, len(wts),
       int(serpentine))
    return work.astype(np.uint8)


def sensitivity_np(frames):
    """numpy twin of the perceptual sensitivity map, as the JAX package
    computes it: 0.5 + 0.5 * (gray / 255), gray = (0.299 r + 0.587 g) +
    0.114 b, float32."""
    gray = (np.float32(0.299) * frames[..., 0] + np.float32(0.587) * frames[..., 1]
            + np.float32(0.114) * frames[..., 2])
    return np.float32(0.5) + np.float32(0.5) * (gray / np.float32(255.0))


def golden_mode_frame(lib, frame, pal, mode, lum_factor=1.0, col_factor=0.2, gate=None,
                      serpentine=False):
    """One frame through the golden engine's f32 twin of a non-fixed mode;
    Riemersma along the port's Hilbert path."""
    from dither_pie_tpu_torch.ops.ed_kernels import OSTROMOUKHOV_ARRAY
    from dither_pie_tpu_torch.ops.hilbert import hilbert_path, next_power_of_two

    work = np.ascontiguousarray(frame, dtype=np.float32).copy()
    h, w, _ = work.shape
    head = (work, h, w, np.ascontiguousarray(pal, np.float32), pal.shape[0])
    if mode == "ostromoukhov":
        lib.ed_ostromoukhov_f32(*head, np.ascontiguousarray(OSTROMOUKHOV_ARRAY),
                                int(serpentine))
    elif mode == "riemersma":
        path = np.ascontiguousarray(hilbert_path(next_power_of_two(max(h, w))))
        lib.ed_riemersma_f32(*head, path, path.shape[0])
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
    summed ms}, bytes of the host-to-device copies, bytes of the
    device-to-host copies, host copy calls)."""
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
    by_name, h2d_bytes, d2h_bytes = {}, 0, 0
    busy_us, edge = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: float(e["ts"])):
        start, dur = float(e["ts"]), float(e["dur"])
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + dur / 1e3
        if "HtoD" in e["name"]:
            h2d_bytes += int(e.get("args", {}).get("bytes", 0))
        if "DtoH" in e["name"]:
            d2h_bytes += int(e.get("args", {}).get("bytes", 0))
        if start + dur > edge:
            busy_us += start + dur - max(start, edge)
            edge = start + dur
    return wall_ms, busy_us / 1e3, by_name, h2d_bytes, d2h_bytes, copy_calls


def report_trace(torch, tag, what, fn, frame_bytes, card):
    """Trace fn() once and log its device busy time and idle share. The
    idle share is read only from a trace that holds the frames'
    host-to-device copy (frame_bytes or more); otherwise it is reported as
    not measured. A measurement only: a profiler fault fails nothing."""
    from dither_pie_tpu_torch.kernels import build

    try:
        t_wall, t_busy, by_name, h2d_bytes, d2h_bytes, copy_calls = traced_call(
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
            f"copy calls) and {d2h_bytes} D2H bytes: idle share not measured (no H2D "
            f"event); device time by name: "
            f"{events} [{card}]")
        return
    log(f"[{tag}] traced {what} (torch.profiler): wall {t_wall:.3f} ms, device busy "
        f"{t_busy:.3f} ms (union of kernel and copy intervals), idle share "
        f"{1 - t_busy / t_wall:.4f}, H2D {h2d_bytes} bytes, D2H {d2h_bytes} bytes; device "
        f"time by name: "
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
    """Phase 7; returns the kernels-line row of K4 and the Bayer 8x8 main
    path's output."""
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

    return row, out16


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
    stream = twf.skew_gather(frames, geom.s)
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
        # The batch of u8 frames and apply_dithering's one float32 frame
        # both take K1.
        check(set(launches) == {k for k, _, _ in kernels}, f"{name} path launched {launches}")
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
                "n": twf.launch_plan(stream, pal_t, geom).n,
                **scan_bound(BATCH, FULL_H, FULL_W, geom.s, pal_t.shape[0],
                             len(geom.weights), aux=aux is not None)}

    def timed_line(entries, prefix=""):
        return ", ".join(f"{prefix}{k} {v['ms']:.3f} ms, n {v['n']} (plain {v['plain_ms']:.0f} ms)"
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
    n_sd = BATCH * SD_H * SD_W
    bounds = {"ed_scan_idx": scan_bound(BATCH, SD_H, SD_W, fs.s, 2048, len(fs.weights)),
              # The unskews read only the stream's B*H*W valid entries.
              "unskew_select": bound(n_sd * 4 + 2048 * 12 + n_sd * 3, 0)}
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
        cluster = ({"n": twf.launch_plan(sd_stream, pals_t[2048], fs, True).n}
                   if key == "ed_scan_idx" else {})
        log(f"[8] {key}: kernel {ms:.3f} ms, plain PyTorch {plain_ms:.3f} ms per "
            f"{BATCH}x{SD_H}x{SD_W} FS k-means-2048 batch, outputs equal bitwise {cluster} "
            f"[{card}]")
        new_rows.append({"name": key, "route": "cuda", "source": source, "replaces": replaces,
                         "launches": totals[key], "max_abs_err": errs[key], "ms": ms,
                         "plain_ms": plain_ms, **cluster, **bounds[key]})
    scan_row["max_abs_err"] = errs["ed_scan"]
    # K9's row: its times in CUDA graphs beside its library call (a device
    # time shorter than its enqueue), its holds at every palette size.
    new_rows[-1].update(select_phase(torch, dev, card, twf, sd_stream, sd_idx, pals_t[2048],
                                     fs, errs, stream, pal32_t))
    new_rows[-1]["max_abs_err"] = errs["unskew_select"]

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


SELECT_SIZES = (1025, 2048, 4096, 16384)  # K9's palettes: above K2's 1024, to K8's 16384


def select_palette(rng, p):
    """A K9 test palette: p random float32 colours in [0, 256) with
    fractional entries (12.9, 255.5 and 0.3 truncate) and duplicate colours
    planted at both ends and every 7th row."""
    pal = np.minimum(rng.uniform(0.0, 256.0, (p, 3)), 255.99).astype(np.float32)
    pal[:3] = [[12.9, 255.5, 0.3], [255.5, 12.9, 0.0], [0.3, 0.3, 255.0]]
    pal[p - 1] = pal[0]
    pal[p // 2] = pal[1]
    pal[1::7] = pal[0::7][:len(pal[1::7])]
    return pal


def select_phase(torch, dev, card, twf, sd_stream, sd_idx, pal2048, fs, errs, stream,
                 pal32):
    """Phase 8's K9 checks and times: ``unskew_select`` (the "select" kind
    of ``unskew_unpack.cu``'s tile kernel, after its palette-packing
    kernel) == ``unskew_select_plain`` bitwise at P in SELECT_SIZES on
    palettes with fractional entries and planted duplicates, at the odd
    shapes of phase 13 (B in TILE_BS, H in TILE_HS, W in TILE_WS, widths
    W <= s among them) with s = 2 and 3, on random indices of the palette,
    streams whole and as slices off the 16-byte boundary, through the
    wrapper and through ``launch_unskew`` into outputs 1-15 bytes off the
    boundary with random bytes around them, which must stay as they were;
    then K9's times at 16 x 480p on the index scan's own streams at 2048
    and 16384 colours beside its library call, and in the same run the
    other kinds of the tile kernel on the 16 x 1080p FS k-means-32 batch
    (``stream``, ``pal32``): K3's NHWC kind on the scan's colours and K5's
    u8 and u16 kinds on its indices, each held to its plain version, each
    a launch in a CUDA graph of 100 (tools/time_ed_path.py times them on
    the parent in the same call). Returns the row's extra entries."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(8)
    pals = {p: torch.from_numpy(select_palette(rng, p)).to(dev) for p in SELECT_SIZES}
    count = 0

    def at_offset(col, pal, s, h, w, off):
        """K9 through ``launch_unskew`` into an output ``off`` bytes into a
        buffer of random bytes; the bytes around the output must not move."""
        n = col.shape[1] * h * w * 3
        buf = torch.from_numpy(rng.randint(0, 256, off + n + 32).astype(np.uint8)).to(dev)
        before = buf.clone()
        out = buf[off:off + n].view(col.shape[1], h, w, 3)
        twf.launch_unskew(col, out, s, "select", pal)
        check(torch.equal(buf[:off], before[:off]) and torch.equal(buf[off + n:],
                                                                   before[off + n:]),
              f"unskew_select wrote outside its output (offset {off}, {h}x{w} s={s})")
        return out

    i = 0
    for s in (2, 3):
        for b in TILE_BS:
            for h in TILE_HS:
                for w in TILE_WS:
                    p = SELECT_SIZES[i % len(SELECT_SIZES)]
                    off = 1 + i % 15
                    i += 1
                    d = twf.stream_length(h, w, s)
                    buf = torch.from_numpy(
                        rng.randint(0, p, d * b * h + 1).astype(np.int32)).to(dev)
                    for col, name in ((buf[:-1].view(d, b, h), "whole"),
                                      (buf[1:].view(d, b, h), "slice")):
                        want = twf.unskew_select_plain(col, pals[p], s, h, w)
                        what = f"B={b} {h}x{w} s={s} P={p} {name}"
                        hold(torch, "unskew_select", twf.unskew_select(col, pals[p], s, h, w),
                             want, errs, what)
                        hold(torch, "unskew_select", at_offset(col, pals[p], s, h, w, off),
                             want, errs, f"{what}, output {off} bytes off the boundary")
                        count += 2
    # The index scan's own streams at 480p: 2048 colours (the main path's)
    # and 16384 (the largest K8 takes), on planted duplicates.
    sd_idx16k = twf.scan_idx(sd_stream, pals[16384], fs, SD_W)
    for idx, pal, p in ((sd_idx, pal2048, 2048), (sd_idx16k, pals[16384], 16384)):
        hold(torch, "unskew_select", twf.unskew_select(idx, pal, fs.s, SD_H, SD_W),
             twf.unskew_select_plain(idx, pal, fs.s, SD_H, SD_W), errs,
             f"the index scan's stream, {BATCH}x{SD_H}x{SD_W} P={p}")
        count += 1
    sync(torch, dev)
    log(f"[8] K9 (unskew_select: the select kind of K3's tile kernel) == plain, bitwise, at "
        f"P in {SELECT_SIZES} (fractional entries, planted duplicates), B in {TILE_BS}, H in "
        f"{TILE_HS}, W in {TILE_WS}, s = 2 and 3, whole and as slices off the 16-byte "
        f"boundary, into fresh outputs and outputs 1-15 bytes off the boundary (the bytes "
        f"around them untouched), and on the index scan's {BATCH}x{SD_H}x{SD_W} streams at "
        f"2048 and 16384 colours: {count} comparisons ({time.perf_counter() - t0:.1f} s) "
        f"[{card}]")

    # K9's times at 2048 and 16384 colours, each call in a CUDA graph of 100
    # (its device time is shorter than its enqueue), beside its library call
    # and its bound. The library call is the truncated u8 palette table (a
    # (P, 3) set-up cast, made once) indexed by a strided view of the
    # stream, timed here and used nowhere in the port.
    from dither_pie_tpu_torch.tools.time_ed_path import graph_ms

    n_sd = BATCH * SD_H * SD_W
    bh = BATCH * SD_H
    extra = {}
    for idx, pal, p in ((sd_idx, pal2048, 2048), (sd_idx16k, pals[16384], 16384)):
        kernel = lambda: twf.unskew_select(idx, pal, fs.s, SD_H, SD_W)
        got = kernel()
        pal_u8 = pal.to(torch.int32).to(torch.uint8)
        view = idx.as_strided((BATCH, SD_H, SD_W), (SD_H, fs.s * bh + 1, bh))
        hold(torch, "unskew_select", pal_u8[view], got, errs, f"the library call, P={p}")
        ms, lib_ms = graph_ms(kernel), graph_ms(lambda: pal_u8[view])
        enq_ms, _ = cuda_ms(torch, kernel, 5)
        b_ = bound(n_sd * 4 + p * 12 + n_sd * 3, 0)["bound_ms"]
        log(f"[8] unskew_select {BATCH}x{SD_H}x{SD_W} P={p}, ms a launch in a CUDA graph of "
            f"100: kernel {ms:.5f}, library call {lib_ms:.5f}; enqueued one call at a time "
            f"(CUDA events) {enq_ms:.5f}; bound {b_:.5f} ms by bytes [{card}]")
        extra.update({f"p{p}_ms": ms, f"p{p}_library_ms": lib_ms,
                      f"p{p}_enqueued_ms": enq_ms, f"p{p}_bound_ms": b_})
        del got
    extra.update(ms=extra["p2048_ms"], library_ms=extra["p2048_library_ms"],
                 enqueued_ms=extra["p2048_enqueued_ms"])
    del sd_idx16k

    # The other kinds of the same tile kernel, which the select kind must
    # not slow: K3 NHWC and K5 u8 / u16 at 16 x 1080p.
    col = twf.scan(stream, pal32, fs, FULL_W)
    idx = twf.scan_idx(stream, pal32, fs, FULL_W)
    kinds = {"K3 NHWC": ("unskew_unpack", lambda: twf.unskew_unpack(col, fs.s, FULL_H, FULL_W),
                         lambda: twf.unskew_unpack_plain(col, fs.s, FULL_H, FULL_W)),
             "K5 u8": ("unskew_idx",
                       lambda: twf.unskew_idx(idx, fs.s, FULL_H, FULL_W, torch.uint8),
                       lambda: twf.unskew_idx_plain(idx, fs.s, FULL_H, FULL_W, torch.uint8)),
             "K5 u16": ("unskew_idx",
                        lambda: twf.unskew_idx(idx, fs.s, FULL_H, FULL_W, torch.uint16),
                        lambda: twf.unskew_idx_plain(idx, fs.s, FULL_H, FULL_W, torch.uint16))}
    kind_ms = {}
    for label, (key, kernel, plain) in kinds.items():
        got, want = kernel(), plain()
        hold(torch, key, got, want, errs, f"{label}, {BATCH}x{FULL_H}x{FULL_W} FS k-means-32")
        kind_ms[label] = graph_ms(kernel)
        del got, want
    log(f"[8] the tile kernel's other kinds in the same run, {BATCH}x{FULL_H}x{FULL_W} FS "
        f"k-means-32, each == plain, ms a launch in a CUDA graph of 100: "
        f"{', '.join(f'{k} {v:.5f}' for k, v in kind_ms.items())} [{card}]")
    extra["other_kinds_ms"] = kind_ms
    return extra


# ---------------------------------------------------------------------------
# Phase 9: the index stream and planar batches
# ---------------------------------------------------------------------------


class env_var:
    """Set (or, with None, unset) one environment variable for a block."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        if self.value is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.old


def index_transfer(value):
    return env_var("DITHER_PIE_TPU_INDEX_TRANSFER", value)


def as_int32(torch, t):
    """Any integer tensor as int32 values (uint16 has few operators)."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.int32)


def hold(torch, key, got, want, errs, what):
    """Require got == want bitwise; record the max abs error under ``key``
    and return this comparison's."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{key}: {got.dtype} {tuple(got.shape)} against plain {want.dtype} "
          f"{tuple(want.shape)} ({what})")
    if got.dtype == torch.float32:
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = (got.to(torch.float64) - want.to(torch.float64)).abs().max().item()
    else:
        a, b = as_int32(torch, got), as_int32(torch, want)
        same = torch.equal(a, b)
        err = float((a - b).abs().max().item())
    errs[key] = max(errs.get(key, 0.0), err)
    check(same, f"{key} kernel != plain version ({what}, max abs err {err})")
    return err


def median_wall(fn, reps=5):
    """(median seconds, all seconds) of fn() on the host's clock."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def transfer_phase(torch, dev, card, lib, frames16, frame0, palette32, palette16,
                   palette256, out16_rgb, out_bayer_rgb, rows, errs):
    """Phase 9; adds its main paths' launches to ``rows``, K3's planar times
    to its row, and returns the kernels-line rows of K5 and K6."""
    from PIL import Image

    import dither_pie_tpu_torch as dpt
    from dither_pie_tpu_torch.api import linkspeed
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.ops import ed_kernels, idxpack, wavefront as twf

    def on_card(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def planes_of(frames_np):
        return np.ascontiguousarray(np.moveaxis(frames_np, -1, 0))

    fs = twf.scan_geometry("floyd_steinberg")
    jjn = twf.scan_geometry("jjn")

    # --- kernel == plain, bitwise, small odd shapes ---------------------
    t0 = time.perf_counter()
    rng = np.random.RandomState(9)
    b, h, w = SMALL
    small_u8 = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    small_f32 = rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32)
    small_t = on_card(small_u8)
    for geom in (fs, jjn):
        d_small = twf.stream_length(h, w, geom.s)
        stream = twf.skew(small_t, geom.s)
        for p in (32, 256, 257, 1024):
            dtype = twf.index_dtype(p)
            what = f"B={b} {h}x{w} s={geom.s} P={p}"
            rand = on_card(rng.randint(0, p, (d_small, b, h)).astype(np.int32))
            own = twf.scan_idx(stream, on_card(unique_palette(rng, p)), geom, w)
            for name, idx in (("random indices", rand), ("the scan's indices", own)):
                got = twf.unskew_idx(idx, geom.s, h, w, dtype)
                check(got.dtype == dtype, f"unskew_idx gave {got.dtype} at P={p}")
                hold(torch, "unskew_idx", got, twf.unskew_idx_plain(idx, geom.s, h, w, dtype),
                     errs, f"{what}, {name}")
        for name, arr in (("u8", small_u8), ("f32", small_f32)):
            planes = on_card(planes_of(arr)).view(3 * b, h, w)
            got = twf.skew_planar_gather(planes, geom.s)
            hold(torch, "skew_planar", got, twf.skew_planar_plain(planes, geom.s), errs,
                 f"B={b} {h}x{w} s={geom.s} {name}")
            hold(torch, "skew_planar", got, twf.skew_gather(on_card(arr), geom.s), errs,
                 f"against K1's stream, B={b} {h}x{w} s={geom.s} {name}")
        five = on_card(rng.randint(0, 256, (5, h, w)).astype(np.uint8))  # any R
        hold(torch, "skew_planar", twf.skew_planar(five, geom.s),
             twf.skew_planar_plain(five, geom.s), errs, f"R=5 {h}x{w} s={geom.s}")
        col = twf.scan(stream, on_card(unique_palette(rng, 32)), geom, w)
        planar = twf.unskew_unpack(col, geom.s, h, w, planar_out=True)
        hold(torch, "unskew_unpack", planar,
             twf.unskew_unpack_plain(col, geom.s, h, w, planar_out=True), errs,
             f"planar layout, B={b} {h}x{w} s={geom.s}")
        hold(torch, "unskew_unpack", planar,
             twf.unskew_unpack(col, geom.s, h, w).permute(3, 0, 1, 2).contiguous(), errs,
             f"planar layout against NHWC transposed, B={b} {h}x{w} s={geom.s}")
    # The index pack: the card's shift/or ops against the CPU's.
    for bpp, p in ((1, 2), (2, 4), (4, 16)):
        for width in (FULL_W, w):
            idx_np = rng.randint(0, p, (2, 9, width)).astype(np.uint8)
            packed = idxpack.pack_indices_device(on_card(idx_np), bpp)
            check(packed.device.type == dev.type and packed.dtype == torch.uint8,
                  f"pack_indices_device gave {packed.dtype} on {packed.device}")
            packed_cpu = idxpack.pack_indices_device(torch.from_numpy(idx_np), bpp)
            check(torch.equal(packed.cpu(), packed_cpu),
                  f"index pack on the card != on the CPU ({bpp} bits, W={width})")
            check(np.array_equal(idxpack.unpack_indices_host(packed.cpu().numpy(), bpp, width),
                                 idx_np), f"index pack round trip ({bpp} bits, W={width})")
    log(f"[9] kernel == plain, bitwise, B={b} {h}x{w}, s = 2 and 3: K5 at P in (32, 256: u8; "
        f"257, 1024: u16) on random indices and the scan's own; K6 (u8, f32; R=5) and K6 == "
        f"K1's stream; K3 planar == plain == NHWC transposed; index pack on the card == CPU "
        f"for 1, 2, 4 bits at W={FULL_W} and {w}, exact round trip "
        f"({time.perf_counter() - t0:.1f} s)")

    # --- kernel == plain at full size, and the times ---------------------
    pal32_np = np.asarray(palette32, np.float32)
    pal32_t = on_card(pal32_np)
    batch_t = on_card(frames16)
    planes16 = planes_of(frames16)
    planes_t = on_card(planes16)
    stream = twf.skew(batch_t, fs.s)
    idx_stream = twf.scan_idx(stream, pal32_t, fs, FULL_W)
    col_stream = twf.scan(stream, pal32_t, fs, FULL_W)
    one_f32 = on_card(planes_of(frame0[None].astype(np.float32)))
    hold(torch, "skew_planar", twf.skew_planar_gather(one_f32.view(3, FULL_H, FULL_W), fs.s),
         twf.skew_planar_plain(one_f32.view(3, FULL_H, FULL_W), fs.s), errs,
         f"one float32 {FULL_H}x{FULL_W} frame")
    d_fs = twf.stream_length(FULL_H, FULL_W, fs.s)
    n_px = BATCH * FULL_H * FULL_W
    rows3 = planes_t.view(3 * BATCH, FULL_H, FULL_W)
    timed = {
        "unskew_idx": (lambda: twf.unskew_idx(idx_stream, fs.s, FULL_H, FULL_W),
                       lambda: twf.unskew_idx_plain(idx_stream, fs.s, FULL_H, FULL_W),
                       bound(n_px * 4 + n_px, 0)),  # the valid entries in, u8 out
        "skew_planar": (lambda: twf.skew_planar(rows3, fs.s),
                        lambda: twf.skew_planar_plain(rows3, fs.s),
                        bound(n_px * 3 + d_fs * 3 * BATCH * FULL_H, 0)),
        "unskew_unpack": (
            lambda: twf.unskew_unpack(col_stream, fs.s, FULL_H, FULL_W, planar_out=True),
            lambda: twf.unskew_unpack_plain(col_stream, fs.s, FULL_H, FULL_W, planar_out=True),
            bound(n_px * 4 + n_px * 3, 0)),
    }
    measured = {}
    for key, (kern, plain, bnd) in timed.items():
        ms, got = cuda_ms(torch, kern, 5)
        plain_ms, want = cuda_ms(torch, plain, 3)
        hold(torch, key, got, want, errs, f"the timed {BATCH}x{FULL_H}x{FULL_W} batch")
        measured[key] = (ms, plain_ms, bnd, got)
        layout = " (planar layout)" if key == "unskew_unpack" else ""
        log(f"[9] {key}{layout}: kernel {ms:.3f} ms, plain PyTorch {plain_ms:.3f} ms per "
            f"{BATCH}x{FULL_H}x{FULL_W} FS k-means-32 batch, bound {bnd['bound_ms']:.4f} ms by "
            f"{bnd['bound_by']}, outputs equal bitwise [{card}]")
    # One PyTorch call computes K5 (and none K3 or K6, for their shifts and
    # zero fill): a strided view of the stream and its narrowing copy. Timed
    # here, used nowhere in the port.
    check(idx_stream.is_contiguous(), "the index stream is not contiguous")
    bh = BATCH * FULL_H
    lib_ms, lib_out = cuda_ms(
        torch, lambda: idx_stream.as_strided(
            (BATCH, FULL_H, FULL_W), (FULL_H, fs.s * bh + 1, bh)).to(torch.uint8), 5)
    check(torch.equal(lib_out, measured["unskew_idx"][3]),
          "as_strided(...).to(uint8) of the index stream != unskew_idx")
    measured["unskew_idx"][2]["library_ms"] = lib_ms
    log(f"[9] unskew_idx as one PyTorch call, idx.as_strided((B, H, W), (H, s*B*H + 1, "
        f"B*H)).to(uint8): {lib_ms:.3f} ms, equal to the kernel bitwise [{card}]")
    del lib_out
    hold(torch, "skew_planar", measured["skew_planar"][3], stream, errs,
         f"against K1's stream, {BATCH}x{FULL_H}x{FULL_W}")
    hold(torch, "unskew_unpack", measured["unskew_unpack"][3],
         twf.unskew_unpack(col_stream, fs.s, FULL_H, FULL_W).permute(3, 0, 1, 2).contiguous(),
         errs, f"planar layout against NHWC transposed, {BATCH}x{FULL_H}x{FULL_W}")
    ms_u16, got_u16 = cuda_ms(
        torch, lambda: twf.unskew_idx(idx_stream, fs.s, FULL_H, FULL_W, torch.uint16), 5)
    hold(torch, "unskew_idx", got_u16,
         twf.unskew_idx_plain(idx_stream, fs.s, FULL_H, FULL_W, torch.uint16), errs,
         f"uint16, {BATCH}x{FULL_H}x{FULL_W}")
    log(f"[9] unskew_idx, uint16 output, {BATCH}x{FULL_H}x{FULL_W}: {ms_u16:.3f} ms, equal to "
        f"its plain version bitwise [{card}]")
    # The uint16 stream's one PyTorch call, where this torch casts to uint16
    # on CUDA.
    lib16_ms = None
    try:
        lib16_ms, lib16_out = cuda_ms(
            torch, lambda: idx_stream.as_strided(
                (BATCH, FULL_H, FULL_W), (FULL_H, fs.s * bh + 1, bh)).to(torch.uint16), 5)
    except (RuntimeError, NotImplementedError) as e:
        log(f"[9] unskew_idx, uint16, as one PyTorch call: not taken on CUDA ({e})")
    else:
        hold(torch, "unskew_idx", lib16_out, got_u16, errs,
             f"as_strided(...).to(uint16) against K5, {BATCH}x{FULL_H}x{FULL_W}")
        log(f"[9] unskew_idx, uint16, as one PyTorch call, idx.as_strided(...).to(uint16): "
            f"{lib16_ms:.3f} ms, equal to the kernel bitwise [{card}]")
        del lib16_out
    measured["unskew_idx"][2].update(
        u16_library_ms=lib16_ms, u16_bound_ms=bound(n_px * 4 + 2 * n_px, 0)["bound_ms"])
    k6_times = measured.pop("skew_planar")[:3]  # drop the held stream
    del got_u16

    # --- the main paths, each with its own launch counts -----------------
    ed = dpt.DitherMode.ERROR_DIFFUSION
    fs_params = {"variant": "floyd_steinberg"}
    totals = {}

    def drive(name, ditherer, frames, index, expect, pal_np, planar=False, pack=None):
        """One apply_dithering_batch call with the counts set to 0 before it
        and read after it; checks the kernels launched, shape, dtype and
        palette-only colours. Returns the output in NHWC."""
        with index_transfer(index), env_var("DITHER_PIE_TPU_INDEX_PACK", pack):
            build.reset_launch_counts()
            out = ditherer.apply_dithering_batch(frames, planar=planar)
            sync(torch, dev)
            launches = dict(build.LAUNCHES)
        check(set(launches) == set(expect) and all(v >= 1 for v in launches.values()),
              f"{name} path launched {launches}, expected {sorted(expect)}")
        for key, n in launches.items():
            totals[key] = totals.get(key, 0) + n
        check(out.shape == frames.shape and out.dtype == np.uint8,
              f"{name} output {out.shape} {out.dtype}")
        nhwc = np.moveaxis(out, 0, -1) if planar else out
        check(palette_only(nhwc, pal_np), f"{name} output holds colours outside the palette")
        log(f"[9] main path {name}: launches {launches}; {out.shape} uint8, palette-only")
        return nhwc

    rgb_path = ("skew", "ed_scan", "unskew_unpack")
    idx_path = ("skew", "ed_scan_idx", "unskew_idx")

    def ed_ditherer(palette, mode=ed, params=fs_params):
        return dpt.ImageDitherer(num_colors=len(palette), dither_mode=mode, palette=palette,
                                 dither_params=params, device=dev)

    # (a) FS k-means-32, the index stream forced on, against phase 5's output.
    d32 = ed_ditherer(palette32)
    out_a = drive("(a) FS k-means-32, index stream", d32, frames16, "1", idx_path, pal32_np)
    idents = [identity(o, g) for o, g in zip(out_a, out16_rgb)]
    check(np.array_equal(out_a, out16_rgb),
          f"(a) index-stream output != phase 5's RGB output (identity {idents})")
    log(f"[9] (a) == phase 5's RGB-path output on all {BATCH} frames (identity {idents}), "
        f"which phase 5 held to the golden engine")

    # (b) k-means-16: the 4-bit packed stream, pack on and off.
    pal16_np = np.asarray(palette16, np.float32)
    d16 = ed_ditherer(palette16)
    rgb16 = drive("(b) FS k-means-16, RGB", d16, frames16, "0", rgb_path, pal16_np)
    for pack in (None, "0"):
        out_b = drive(f"(b) FS k-means-16, index stream, pack {'on' if pack is None else 'off'}",
                      d16, frames16, "1", idx_path, pal16_np, pack=pack)
        check(np.array_equal(out_b, rgb16), f"(b) index stream (pack {pack}) != RGB path")
    golds = [golden_frame(lib, ed_kernels.kernel_arrays, f, pal16_np, "floyd_steinberg")
             for f in frames16[:2]]
    idents = [identity(o, g) for o, g in zip(rgb16, golds)]
    check(all(v == 1.0 for v in idents), f"(b) k-means-16 golden identity {idents}")
    log(f"[9] (b) packed == unpacked == RGB path on all {BATCH} frames; golden identity of "
        f"frames 0-1 {idents}")

    # (c) k-means-256 at 1080p (u8) and k-means-300 at 480p (u16).
    pal256_np = np.asarray(palette256, np.float32)
    d256 = ed_ditherer(palette256)
    rgb256 = drive("(c) FS k-means-256, RGB", d256, frames16, "0", rgb_path, pal256_np)
    out_c = drive("(c) FS k-means-256, index stream (u8)", d256, frames16, "1", idx_path,
                  pal256_np)
    check(np.array_equal(out_c, rgb256), "(c) k-means-256 index stream != RGB path")
    sd16 = np.stack([synth_image(SD_H, SD_W, 200 + i) for i in range(BATCH)])
    palette300 = dpt.ColorReducer.generate_kmeans_palette(Image.fromarray(sd16[0]), 300,
                                                          device=dev)
    pal300_np = np.asarray(palette300, np.float32)
    d300 = ed_ditherer(palette300)
    rgb300 = drive("(c) FS k-means-300 480p, RGB", d300, sd16, "0", rgb_path, pal300_np)
    out_c = drive("(c) FS k-means-300 480p, index stream (u16)", d300, sd16, "1", idx_path,
                  pal300_np)
    check(np.array_equal(out_c, rgb300), "(c) k-means-300 index stream != RGB path")
    with index_transfer("1"):
        idx300 = d300._get_dither_strategy(ed).dither_batch_indices(sd16[:1], pal300_np)
    check(idx300.dtype == np.uint16, f"(c) k-means-300 stream is {idx300.dtype}")
    log("[9] (c) index stream == RGB path: k-means-256 1080p (u8), k-means-300 480p (u16)")

    # (d) Bayer 8x8 pico8 through K4's indices, against phase 7's output.
    pico8 = pico8_palette()
    bayer = dpt.ImageDitherer(dither_mode=dpt.DitherMode.BAYER, palette=pico8,
                              dither_params={"size": "8x8"}, device=dev)
    out_d = drive("(d) BAYER 8x8 pico8, index stream", bayer, frames16, "1",
                  ("ordered_fused",), np.asarray(pico8, np.float32))
    check(np.array_equal(out_d, out_bayer_rgb), "(d) Bayer index stream != phase 7's output")
    log("[9] (d) == phase 7's RGB-path output")

    # (e) one non-fixed mode through the index stream.
    perc = ed_ditherer(palette32, dpt.DitherMode.PERCEPTUAL, {})
    rgb_e = drive("(e) PERCEPTUAL k-means-32, RGB", perc, frames16, "0", rgb_path, pal32_np)
    out_e = drive("(e) PERCEPTUAL k-means-32, index stream", perc, frames16, "1", idx_path,
                  pal32_np)
    check(np.array_equal(out_e, rgb_e), "(e) perceptual index stream != RGB path")
    log("[9] (e) index stream == RGB path")

    # (f) planar batches, without and with the index stream.
    out_f = drive("(f) FS k-means-32, planar", d32, planes16, "0",
                  ("skew_planar", "ed_scan", "unskew_unpack"), pal32_np, planar=True)
    check(np.array_equal(out_f, out16_rgb), "(f) planar output != the NHWC output transposed")
    out_f = drive("(f) FS k-means-32, planar, index stream", d32, planes16, "1",
                  ("skew_planar", "ed_scan_idx", "unskew_idx"), pal32_np, planar=True)
    check(np.array_equal(out_f, out16_rgb),
          "(f) planar index-stream output != the NHWC output transposed")
    pal2048 = [tuple(int(v) for v in c) for c in unique_palette(rng, 2048)]
    answers = (d32.supports_planar_batch(), bayer.supports_planar_batch(),
               ed_ditherer(pal2048).supports_planar_batch())
    check(answers == (True, False, False), f"supports_planar_batch: {answers}")
    log(f"[9] (f) planar == NHWC transposed, bitwise, both ways; supports_planar_batch: ED "
        f"{answers[0]}, Bayer {answers[1]}, 2048 colours {answers[2]}")

    # (g) the environment unset: the probe decides.
    with index_transfer(None):
        mb_s = linkspeed.d2h_bandwidth_mb_s(dev)
        verdict = linkspeed.index_transfer_wins(dev)
    gather_ns, even = linkspeed.host_gather_ns_per_px(), linkspeed.break_even_mb_s()
    check(mb_s is not None and mb_s > 0 and gather_ns > 0 and verdict == (mb_s < even),
          f"probe {mb_s} MB/s, host gather {gather_ns} ns a pixel, verdict {verdict}")
    out_g = drive("(g) FS k-means-32, environment unset", d32, frames16, None,
                  idx_path if verdict else rgb_path, pal32_np)
    check(np.array_equal(out_g, out16_rgb), "(g) output != phase 5's")
    log(f"[9] (g) link probe (pageable 16 MB copies, best of 2): {mb_s:.1f} MB/s -> index "
        f"stream {'on' if verdict else 'off'} by default (host gather pal_u8[idx] of one "
        f"1080x1920 frame, best of 2: {gather_ns:.3f} ns a pixel, so 2 bytes a pixel "
        f"saved break even at {even:.1f} MB/s); the facade "
        f"took the {'index' if verdict else 'RGB'} path [{card}]")

    for row in rows:
        row["launches"] += totals.get(row["name"], 0)

    # --- walls, each pair in this run, each beside the card --------------
    def wall_line(name, ditherer, cases):
        parts = []
        for label, frames, index, pack, planar in cases:
            with index_transfer(index), env_var("DITHER_PIE_TPU_INDEX_PACK", pack):
                med, walls = median_wall(
                    lambda: ditherer.apply_dithering_batch(frames, planar=planar))
            parts.append(f"{label} median {med * 1e3:.3f} ms -> {BATCH / med:.2f} fps (5 runs: "
                         f"{', '.join(f'{t * 1e3:.3f}' for t in walls)})")
        log(f"[9] apply_dithering_batch wall, {name}, {BATCH}x{FULL_H}x{FULL_W} (numpy u8 in/"
            f"out): {'; '.join(parts)} [{card}]")

    three = [("RGB", frames16, "0", None, False),
             ("index stream u8", frames16, "1", "0", False),
             ("index stream 4-bit packed", frames16, "1", None, False)]
    wall_line("FS k-means-32", d32, three[:2])
    wall_line("FS k-means-16", d16, three)
    wall_line("BAYER 8x8 pico8", bayer, three)
    wall_line("FS k-means-32, NHWC against planar", d32,
              [("NHWC RGB", frames16, "0", None, False),
               ("planar RGB", planes16, "0", None, True),
               ("planar index stream u8", planes16, "1", None, True)])

    # Inside the index walls: the copy, the unpack and the gather.
    def host_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            sync(torch, dev)
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    idx8 = measured["unskew_idx"][3]  # (16, 1080, 1920) u8 on the card
    idx4 = idx8 & 15
    packed = idxpack.pack_indices_device(idx4, 4)
    packed_np = packed.cpu().numpy()
    idx_np = idx8.cpu().numpy()
    pal_u8 = pal32_np.astype(np.uint8)
    parts = {
        f"D2H of the RGB batch ({batch_t.numel() / 1e6:.1f} MB)":
            host_ms(lambda: batch_t.cpu().numpy()),
        f"D2H of the u8 index stream ({idx8.numel() / 1e6:.1f} MB)":
            host_ms(lambda: idx8.cpu().numpy()),
        f"device pack to 4 bits + D2H ({packed.numel() / 1e6:.1f} MB)":
            host_ms(lambda: idxpack.pack_indices_device(idx4, 4).cpu().numpy()),
        "host unpack of the 4-bit stream": host_ms(
            lambda: idxpack.unpack_indices_host(packed_np, 4, FULL_W)),
        f"host gather pal_u8[idx] (writes {batch_t.numel() / 1e6:.1f} MB)":
            host_ms(lambda: pal_u8[idx_np]),
        "host planar gather pal_u8.T[:, idx]": host_ms(lambda: pal_u8.T[:, idx_np]),
        # Not the facade's form: timed for the open question in PERF.md.
        "np.take(pal_u8, idx, axis=0)": host_ms(lambda: np.take(pal_u8, idx_np, axis=0)),
    }
    check(np.array_equal(np.take(pal_u8, idx_np[:1], axis=0), pal_u8[idx_np[:1]]),
          "np.take(pal_u8, idx, axis=0) != pal_u8[idx]")
    log(f"[9] inside the index walls, {BATCH}x{FULL_H}x{FULL_W}, medians of 3 on the host's "
        f"clock: {'; '.join(f'{k} {v:.3f} ms' for k, v in parts.items())} [{card}]")

    k3 = next(row for row in rows if row["name"] == "unskew_unpack")
    ms, plain_ms, _, _ = measured["unskew_unpack"]
    k3.update(planar_ms=ms, planar_plain_ms=plain_ms, max_abs_err=errs["unskew_unpack"])
    ms, plain_ms, bnd, _ = measured["unskew_idx"]
    new_rows = [{"name": "unskew_idx", "route": "cuda", "source": TRANSFER_KERNELS[0][1],
                 "replaces": TRANSFER_KERNELS[0][2], "launches": totals["unskew_idx"],
                 "max_abs_err": errs["unskew_idx"], "ms": ms, "plain_ms": plain_ms,
                 "u16_ms": ms_u16, **bnd}]
    ms, plain_ms, bnd = k6_times
    new_rows.append({"name": "skew_planar", "route": "cuda", "source": TRANSFER_KERNELS[1][1],
                     "replaces": TRANSFER_KERNELS[1][2], "launches": totals["skew_planar"],
                     "max_abs_err": errs["skew_planar"], "ms": ms, "plain_ms": plain_ms, **bnd})
    return new_rows


# ---------------------------------------------------------------------------
# Phase 10: the dense-search path, the transposing skew, the search probe
# ---------------------------------------------------------------------------


def dense_search_env(value):
    return env_var("DITHER_PIE_TPU_DENSE_SEARCH", value)


def dense_search_phase(torch, dev, card, lib, frames16, frame0, palette256, rows, errs):
    """Phase 10; adds its main paths' launches to ``rows`` and the score
    search's times to K2's row, and returns the kernels-line rows of K7 and
    the search probe."""
    from PIL import Image

    import dither_pie_tpu_torch as dpt
    from dither_pie_tpu_torch import convert
    from dither_pie_tpu_torch.core import fidelity
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.ops import ed_kernels, wavefront as twf
    from dither_pie_tpu_torch.tools import proto_mxu_search as probe

    def on_card(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def planes_of(frames_np):
        return np.ascontiguousarray(np.moveaxis(frames_np, -1, 0))

    fs = twf.scan_geometry("floyd_steinberg")
    jjn = twf.scan_geometry("jjn")
    rng = np.random.RandomState(10)
    b, h, w = SMALL
    small = {"u8": rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
             "f32": rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32)}

    # --- K7 == plain == K1's and K6's streams, bitwise and everywhere -----
    # K7 is skew.cu's tile kernel in three type pairs (u8 -> u8, f32 -> f32,
    # u8 -> f32), NHWC (C = 3) and planes (C = 1).
    t0 = time.perf_counter()

    def hold_k7(frames_np, s, what):
        """K7 on NHWC frames and on their planes, in each of its type pairs,
        against its plain version and against K1's and K6's streams."""
        nhwc = on_card(frames_np)
        planes = on_card(planes_of(frames_np)).view(-1, *frames_np.shape[1:3])
        k1 = twf.skew_gather(nhwc, s)
        out_dtypes = (None, torch.float32) if nhwc.dtype == torch.uint8 else (None,)
        for layout, x, other, name in (("NHWC", nhwc, k1, "K1"),
                                       ("planes", planes, twf.skew_planar_gather(planes, s),
                                        "K6")):
            for out_dtype in out_dtypes:
                got = twf.skew_transpose(x, s, out_dtype)
                pair = f"{x.dtype} -> {got.dtype}"
                hold(torch, "skew_transpose", got, twf.skew_transpose_plain(x, s, out_dtype),
                     errs, f"{what}, {layout}, {pair}")
                hold(torch, "skew_transpose", got, other.to(got.dtype), errs,
                     f"against {name}'s stream, {what}, {layout}, {pair}")
                hold(torch, "skew_transpose", got, k1.to(got.dtype), errs,
                     f"against K1's stream, {what}, {layout}, {pair}")

    for geom in (fs, jjn):
        for name, arr in small.items():
            hold_k7(arr, geom.s, f"B={b} {h}x{w} s={geom.s} {name}")
        five = on_card(rng.randint(0, 256, (5, h, w)).astype(np.uint8))  # any R
        for out_dtype in (None, torch.float32):
            hold(torch, "skew_transpose", twf.skew_transpose(five, geom.s, out_dtype),
                 twf.skew_transpose_plain(five, geom.s, out_dtype), errs,
                 f"R=5 {h}x{w} s={geom.s} out {out_dtype}")
        # Widths W <= s: the tile kernel serves them as any width.
        for narrow in range(1, geom.s + 1):
            for name, dtype in (("u8", np.uint8), ("f32", np.float32)):
                arr = rng.randint(0, 256, (2, 6, narrow, 3)).astype(dtype)
                hold_k7(arr, geom.s, f"B=2 6x{narrow} (W <= s) s={geom.s} {name}")
    # Frames of either dtype take K1 and K6 from the dispatching wrappers.
    for name in ("f32", "u8"):
        build.reset_launch_counts()
        twf.skew(on_card(small[name]), fs.s)
        twf.skew_planar(on_card(planes_of(small[name])).view(3 * b, h, w), fs.s)
        check(dict(build.LAUNCHES) == {"skew": 1, "skew_planar": 1},
              f"{name} frames launched {dict(build.LAUNCHES)}, expected skew and skew_planar")
    hold_k7(frame0[None].astype(np.float32), fs.s, f"one float32 {FULL_H}x{FULL_W} frame")
    log(f"[10] kernel == plain, bitwise: K7 skew_transpose (skew.cu's tile kernel) at B={b} "
        f"{h}x{w}, s = 2 and 3, u8 -> u8, f32 -> f32 and u8 -> f32, NHWC and planes, == K1's "
        f"and K6's streams everywhere; R=5; widths W <= s (1..s); float32 and uint8 frames "
        f"dispatch to K1 and K6; one float32 {FULL_H}x{FULL_W} frame (B=1) "
        f"({time.perf_counter() - t0:.1f} s)")

    # --- K7's times beside K1, K6 and the library call, one run -----------
    batch_t = on_card(frames16)
    planes_t = on_card(planes_of(frames16)).view(3 * BATCH, FULL_H, FULL_W)
    d_fs = twf.stream_length(FULL_H, FULL_W, fs.s)
    n_px = BATCH * FULL_H * FULL_W
    n_stream = d_fs * 3 * BATCH * FULL_H
    k7_bound = bound(n_px * 3 + n_stream, 0)
    k1_ms, k1_stream = cuda_ms(torch, lambda: twf.skew_gather(batch_t, fs.s), 5)
    k6_ms, k6_stream = cuda_ms(torch, lambda: twf.skew_planar_gather(planes_t, fs.s), 5)
    hold(torch, "skew_planar", k6_stream, k1_stream, errs, f"{BATCH}x{FULL_H}x{FULL_W}")
    del k6_stream
    k7_ms, k7_stream = cuda_ms(torch, lambda: twf.skew_transpose(batch_t, fs.s), 5)
    hold(torch, "skew_transpose", k7_stream, k1_stream, errs,
         f"against K1's stream, the timed {BATCH}x{FULL_H}x{FULL_W} u8 batch, NHWC")
    k7p_ms, k7p_stream = cuda_ms(torch, lambda: twf.skew_transpose(planes_t, fs.s), 5)
    hold(torch, "skew_transpose", k7p_stream, k1_stream, errs,
         f"against K1's stream, the timed {BATCH}x{FULL_H}x{FULL_W} u8 batch, planes")
    del k7p_stream
    k7_plain_ms, plain_stream = cuda_ms(
        torch, lambda: twf.skew_transpose_plain(batch_t, fs.s), 3)
    hold(torch, "skew_transpose", k7_stream, plain_stream, errs,
         f"the timed {BATCH}x{FULL_H}x{FULL_W} u8 batch")
    del plain_stream, k7_stream
    # One PyTorch call computes K7 from the padded stride-lemma form of the
    # planes: permute(2, 0, 1).contiguous(). Timed here, used nowhere in the
    # port (the plain version, which CPU tensors take, is built on it).
    padded = torch.nn.functional.pad(planes_t, (0, d_fs + fs.s - FULL_W))
    lemma = padded.reshape(3 * BATCH, FULL_H * (d_fs + fs.s))[:, : FULL_H * d_fs].reshape(
        3 * BATCH, FULL_H, d_fs)
    lib_ms, lib_stream = cuda_ms(torch, lambda: lemma.permute(2, 0, 1).contiguous(), 5)
    hold(torch, "skew_transpose", lib_stream, k1_stream, errs,
         "permute(2, 0, 1).contiguous() of the padded stride-lemma form against K1's stream")
    del lib_stream, lemma, padded
    k7_bound["library_ms"] = lib_ms
    log(f"[10] skew_transpose (K7), {BATCH}x{FULL_H}x{FULL_W} u8, all streams equal bitwise: "
        f"NHWC {k7_ms:.3f} ms, planes {k7p_ms:.3f} ms; K1 skew {k1_ms:.3f} ms, K6 skew_planar "
        f"{k6_ms:.3f} ms; plain PyTorch {k7_plain_ms:.3f} ms; the library call permute(2, 0, 1)"
        f".contiguous() {lib_ms:.3f} ms; bound {k7_bound['bound_ms']:.4f} ms by "
        f"{k7_bound['bound_by']} [{card}]")
    # u8 -> f32, the cast form: NHWC (C = 3) and planes (C = 1), each held
    # to the plain version and to K1's stream cast.
    k1_f32 = k1_stream.to(torch.float32)
    del k1_stream
    u8f_bound = bound(n_px * 3 + n_stream * 4, 0)
    k7uf_ms, got = cuda_ms(torch, lambda: twf.skew_transpose(batch_t, fs.s, torch.float32), 5)
    hold(torch, "skew_transpose", got, k1_f32, errs,
         f"u8 -> f32 against K1's stream cast, the timed {BATCH}x{FULL_H}x{FULL_W} batch, NHWC")
    del got
    k7ufp_ms, got = cuda_ms(torch, lambda: twf.skew_transpose(planes_t, fs.s, torch.float32), 5)
    hold(torch, "skew_transpose", got, k1_f32, errs,
         f"u8 -> f32 against K1's stream cast, the timed {BATCH}x{FULL_H}x{FULL_W} batch, "
         f"planes")
    del got
    hold(torch, "skew_transpose", twf.skew_transpose(batch_t, fs.s, torch.float32),
         twf.skew_transpose_plain(batch_t, fs.s, torch.float32), errs,
         f"u8 -> f32 against its plain version, {BATCH}x{FULL_H}x{FULL_W}, NHWC")
    hold(torch, "skew_transpose", twf.skew_transpose(planes_t, fs.s, torch.float32),
         twf.skew_transpose_plain(planes_t, fs.s, torch.float32), errs,
         f"u8 -> f32 against its plain version, {BATCH}x{FULL_H}x{FULL_W}, planes")
    log(f"[10] skew_transpose (K7) u8 -> f32, {BATCH}x{FULL_H}x{FULL_W}, == K1's stream cast "
        f"and == plain, bitwise: NHWC {k7uf_ms:.3f} ms, planes {k7ufp_ms:.3f} ms; bound "
        f"{u8f_bound['bound_ms']:.4f} ms by {u8f_bound['bound_by']} [{card}]")
    # The float32 batch: K7's f32 -> f32 form beside K1's float32 launch.
    batch_f32 = batch_t.to(torch.float32)
    f32_bound = bound(n_px * 3 * 4 + n_stream * 4, 0)
    k1f_ms, k1f_stream = cuda_ms(torch, lambda: twf.skew_gather(batch_f32, fs.s), 3)
    hold(torch, "skew", k1f_stream, k1_f32, errs,
         f"float32 against the u8 stream cast, {BATCH}x{FULL_H}x{FULL_W}")
    del k1_f32
    k7f_ms, k7f_stream = cuda_ms(torch, lambda: twf.skew_transpose(batch_f32, fs.s), 3)
    hold(torch, "skew_transpose", k7f_stream, k1f_stream, errs,
         f"against K1's stream, the timed {BATCH}x{FULL_H}x{FULL_W} float32 batch")
    del k1f_stream, k7f_stream, batch_f32
    log(f"[10] skew_transpose (K7), {BATCH}x{FULL_H}x{FULL_W} float32, equal to K1's stream "
        f"bitwise: {k7f_ms:.3f} ms; K1 skew on the same batch {k1f_ms:.3f} ms; bound "
        f"{f32_bound['bound_ms']:.4f} ms by {f32_bound['bound_by']} [{card}]")
    # K1's row: its times beside K7's and K6's on the same batches.
    next(row for row in rows if row["name"] == "skew").update(
        u8_ms=k1_ms, k7_u8_ms=k7_ms, k6_u8_ms=k6_ms, f32_ms=k1f_ms, k7_f32_ms=k7f_ms,
        f32_bound_ms=f32_bound["bound_ms"])

    # --- the score branch of K2 and K8 == plain, bitwise ------------------
    t0 = time.perf_counter()
    adaptive_gates = on_card((rng.rand(b, h, w) < 0.5).astype(np.float32))

    def hold_score(frames_t, pal_t, geom, aux, what, outputs=("ed_scan", "ed_scan_idx")):
        stream = twf.skew(frames_t, geom.s)
        pairs = {"ed_scan": (twf.scan, twf.scan_plain),
                 "ed_scan_idx": (twf.scan_idx, twf.scan_idx_plain)}
        got = {}
        for key in outputs:
            kern, plain = pairs[key]
            got[key] = kern(stream, pal_t, geom, frames_t.shape[2], aux, dense_search="mxu")
            hold(torch, key, got[key],
                 plain(stream, pal_t, geom, frames_t.shape[2], aux, dense_search="mxu"), errs,
                 f"score search, {what}")
        return got

    score_palettes = {p: on_card(unique_palette(rng, p)) for p in (65, 100, 256, 1024)}
    for mode in twf.MODES:
        lum, col = (0.7, 0.45) if mode == "hybrid" else (1.0, 0.2)
        geom = twf.scan_geometry("floyd_steinberg" if mode == "fixed" else "", mode, lum, col)
        for name, arr in small.items():
            frames_t = on_card(arr)
            aux = None
            if mode == "perceptual":
                aux = twf.perceptual_sensitivity(frames_t)
            elif mode == "adaptive":
                aux = adaptive_gates
            for p, pal_t in score_palettes.items():
                hold_score(frames_t, pal_t, geom, aux, f"{mode} {name} P={p}")
    hold_score(on_card(small["u8"]), score_palettes[256], jjn, None, "fixed jjn u8 P=256")
    # Planted duplicates and flat frames: the first index wins.
    p = 600
    dups = ((3, 100), (3, 550), (7, 299))
    pal_np = unique_palette(rng, p)
    for src, dst in dups:
        pal_np[dst] = pal_np[src]
    ties = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    ties[0] = pal_np[3].astype(np.uint8)
    ties[1] = pal_np[7].astype(np.uint8)
    idx = hold_score(on_card(ties), on_card(pal_np), fs, None,
                     f"planted ties P={p}")["ed_scan_idx"].cpu().numpy()
    check(not np.isin(idx, [dst for _, dst in dups]).any(),
          f"score search: a later duplicate's index was emitted (P={p})")
    check(np.isin(idx[:, 0], [0, 3]).all() and np.isin(idx[:, 1], [0, 7]).all(),
          f"score search: flat frames did not resolve to the first copy (P={p})")
    # Outside 64 < P <= 1024 "mxu" runs the exact search: the same output.
    small_u8 = on_card(small["u8"])
    stream = twf.skew(small_u8, fs.s)
    pal64, pal2048 = on_card(unique_palette(rng, 64)), on_card(unique_palette(rng, 2048))
    for key, kern, pal_t in (("ed_scan", twf.scan, pal64), ("ed_scan_idx", twf.scan_idx, pal64),
                             ("ed_scan_idx", twf.scan_idx, pal2048)):
        hold(torch, key, kern(stream, pal_t, fs, w, dense_search="mxu"),
             kern(stream, pal_t, fs, w), errs, f"mxu == exact at P={pal_t.shape[0]}")
    for pal_t in (pal64, pal2048):
        check(torch.equal(twf.ed_batch_wavefront(small_u8, pal_t, dense_search="mxu"),
                          twf.ed_batch_wavefront(small_u8, pal_t)),
              f"dense_search='mxu' changed the output at P={pal_t.shape[0]}")
    log(f"[10] kernel == plain, bitwise: the score branch of K2 and K8 in 5 modes x (u8, f32) "
        f"x P in (65, 100, 256, 1024) at B={b} {h}x{w}, jjn at P=256, planted duplicates and "
        f"flat frames at P={p} (no later index emitted); 'mxu' at P=64 and P=2048 == the "
        f"exact output ({time.perf_counter() - t0:.1f} s)")

    # --- the score branch at full size, and its times ---------------------
    pal256_np = np.asarray(palette256, np.float32)
    palette1024 = dpt.ColorReducer.generate_kmeans_palette(Image.fromarray(frame0), 1024,
                                                           device=dev)
    pals_t = {256: on_card(pal256_np), 1024: on_card(np.asarray(palette1024, np.float32))}
    t0 = time.perf_counter()
    hold_score(batch_t[:1], pals_t[256], fs, None, f"FS k-means-256, B=1 {FULL_H}x{FULL_W}")
    log(f"[10] kernel == plain, bitwise: the score branch of K2 and K8, FS at B=1 "
        f"{FULL_H}x{FULL_W} k-means-256 ({time.perf_counter() - t0:.1f} s)")
    stream16 = twf.skew(batch_t, fs.s)
    score_ms = {}
    plain_frames256 = None
    for p, pal_t in pals_t.items():
        exact_ms, _ = cuda_ms(torch, lambda: twf.scan(stream16, pal_t, fs, FULL_W), 3)
        ms, got = cuda_ms(
            torch, lambda: twf.scan(stream16, pal_t, fs, FULL_W, dense_search="mxu"), 3)
        plain_ms, want = cuda_ms(
            torch, lambda: twf.scan_plain(stream16, pal_t, fs, FULL_W, dense_search="mxu"), 1,
            warmup=False)
        err = hold(torch, "ed_scan", got, want, errs,
                   f"score search, the timed {BATCH}x{FULL_H}x{FULL_W} FS k-means-{p} batch")
        if p == 256:
            # The plain score frames of the batch the facade gets below.
            plain_frames256 = twf.unskew_unpack_plain(want, fs.s, FULL_H, FULL_W).cpu().numpy()
        del got, want
        score_ms[str(p)] = {
            "ms": ms, "exact_ms": exact_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "n": twf.launch_plan(stream16, pal_t, fs, False, "mxu").n,
            "exact_n": twf.launch_plan(stream16, pal_t, fs).n,
            **scan_bound(BATCH, FULL_H, FULL_W, fs.s, p, len(fs.weights), score=True)}
    del stream16
    log(f"[10] ed_scan (K2) with the score branch, {BATCH}x{FULL_H}x{FULL_W} floyd_steinberg "
        f"k-means, each equal to its plain version bitwise: " + ", ".join(
            f"P={p} score {v['ms']:.3f} ms (n {v['n']}) against exact {v['exact_ms']:.3f} ms "
            f"(n {v['exact_n']}; plain "
            f"{v['plain_ms']:.0f} ms, bound {v['bound_ms']:.4f} ms by {v['bound_by']})"
            for p, v in score_ms.items()) + f" [{card}]")
    scan_row = next(row for row in rows if row["name"] == "ed_scan")
    scan_row["score_ms"] = score_ms
    scan_row["max_abs_err"] = errs["ed_scan"]

    # --- the main paths, each with its own launch counts ------------------
    ed = dpt.DitherMode.ERROR_DIFFUSION
    ditherer = dpt.ImageDitherer(num_colors=256, dither_mode=ed, palette=palette256,
                                 dither_params={"variant": "floyd_steinberg"}, device=dev)
    totals = {}
    rgb_path = ("skew", "ed_scan", "unskew_unpack")

    def drive(name, call, expect, search, index="0", count=1):
        """One facade call with the counts set to 0 before it and read after
        it; ``expect``: the kernels it must launch, ``count`` times each."""
        with dense_search_env(search), index_transfer(index):
            build.reset_launch_counts()
            out = call()
            sync(torch, dev)
            launches = dict(build.LAUNCHES)
        check(launches == {key: count for key in expect},
              f"{name} launched {launches}, expected {sorted(expect)} x {count}")
        for key, n in launches.items():
            totals[key] = totals.get(key, 0) + n
        return np.asarray(out), launches

    def gate_metrics(score, exact):
        """(least identity, largest block mean, largest block max) of the
        score output against the exact one over the frames, on the card."""
        score_t, exact_t = on_card(score), on_card(exact)
        idents = [fidelity.identity_fraction(a, c) for a, c in zip(exact_t, score_t)]
        blocks = [fidelity.block_mean_error(a, c, block=4) for a, c in zip(exact_t, score_t)]
        return min(idents), max(m for m, _ in blocks), max(x for _, x in blocks)

    def wall(search, frames, planar=False, index="0"):
        with dense_search_env(search), index_transfer(index):
            return median_wall(lambda: ditherer.apply_dithering_batch(frames, planar=planar))

    out_exact, launches = drive("exact", lambda: ditherer.apply_dithering_batch(frames16),
                                rgb_path, None)
    out_mxu, launches_mxu = drive("DENSE_SEARCH=mxu",
                                  lambda: ditherer.apply_dithering_batch(frames16), rgb_path,
                                  "mxu")
    check(out_mxu.shape == frames16.shape and out_mxu.dtype == np.uint8
          and palette_only(out_mxu, pal256_np), "DENSE_SEARCH=mxu output malformed")
    check(np.array_equal(out_mxu, plain_frames256),
          "DENSE_SEARCH=mxu output != the plain score scan of the same frames and palette, "
          "unskewed and unpacked by the plain version")
    del plain_frames256
    ident, block_mean, block_max = gate_metrics(out_mxu, out_exact)
    # The score search is another function than the exact one: a pick that
    # flips on a near tie changes the pixels after it, so pixel identity is
    # a measurement, and the gate's verdict follows from it. What every
    # valid dithering of these frames must keep is the local mean colour:
    # the gate's two block thresholds are required here.
    check(block_mean <= twf._DENSE_GATE_MAX_BLOCK_MEAN
          and block_max <= twf._DENSE_GATE_MAX_BLOCK_MAX,
          f"the score output drifts in local mean colour: block mean {block_mean}, block max "
          f"{block_max}")
    passes = ident >= twf._DENSE_GATE_MIN_IDENTITY
    golds = [golden_frame(lib, ed_kernels.kernel_arrays, f, pal256_np, "floyd_steinberg")
             for f in frames16[:2]]
    gold_exact = [identity(o, g) for o, g in zip(out_exact, golds)]
    gold_mxu = [identity(o, g) for o, g in zip(out_mxu, golds)]
    check(all(v == 1.0 for v in gold_exact), f"exact golden identity {gold_exact}")
    log(f"[10] main path FS k-means-256, DITHER_PIE_TPU_DENSE_SEARCH=mxu: launches "
        f"{launches_mxu}; {out_mxu.shape} uint8, palette-only, == the plain score scan of "
        f"the same batch through the plain unskew, bitwise; against the exact output of "
        f"this run (launches {launches}) over the {BATCH} frames: least identity {ident}, "
        f"largest 4x4 block mean error {block_mean}, largest block max {block_max} (gate: >= "
        f"{twf._DENSE_GATE_MIN_IDENTITY}, <= {twf._DENSE_GATE_MAX_BLOCK_MEAN}, <= "
        f"{twf._DENSE_GATE_MAX_BLOCK_MAX}: the score search "
        f"{'passes' if passes else 'misses the identity threshold'}); golden identity of "
        f"frames 0-1: exact {gold_exact}, score {gold_mxu}")

    # auto: the first call runs both searches and decides by those three
    # numbers, the second runs the one it chose.
    expected = "mxu" if passes else "exact"
    out_chosen = out_mxu if passes else out_exact
    twf._DENSE_GATE_CACHE.clear()
    out_auto1, launches1 = drive("DENSE_SEARCH=auto, first call",
                                 lambda: ditherer.apply_dithering_batch(frames16), rgb_path,
                                 "auto", count=2)
    verdict = list(twf._DENSE_GATE_CACHE.values())
    check(verdict == [expected], f"the gate's verdict is {verdict}, the metrics say "
                                 f"{expected!r}")
    out_auto2, launches2 = drive("DENSE_SEARCH=auto, second call",
                                 lambda: ditherer.apply_dithering_batch(frames16), rgb_path,
                                 "auto")
    check(np.array_equal(out_auto1, out_chosen) and np.array_equal(out_auto2, out_chosen),
          f"DENSE_SEARCH=auto output != the {expected} output")
    log(f"[10] main path FS k-means-256, DITHER_PIE_TPU_DENSE_SEARCH=auto: first call "
        f"launches {launches1} (both searches), verdict {verdict[0]!r}, second call "
        f"launches {launches2}; both outputs == the {expected} output")
    # The gate's other verdict, on the card: small random frames and a
    # random 256-colour palette, where near ties are rare. The 1080p
    # verdict stays cached for the walls below.
    cached = dict(twf._DENSE_GATE_CACHE)
    twf._DENSE_GATE_CACHE.clear()
    small_t, pal_small = on_card(small["u8"]), score_palettes[256]
    small_exact = twf.ed_batch_wavefront(small_t, pal_small)
    small_score = twf.ed_batch_wavefront(small_t, pal_small, dense_search="mxu")
    small_ident = min(fidelity.identity_fraction(a, c) for a, c in zip(small_exact, small_score))
    build.reset_launch_counts()
    first = twf.ed_batch_wavefront(small_t, pal_small, dense_search="auto")
    counts1 = dict(build.LAUNCHES)
    small_verdict = list(twf._DENSE_GATE_CACHE.values())
    build.reset_launch_counts()
    second = twf.ed_batch_wavefront(small_t, pal_small, dense_search="auto")
    counts2 = dict(build.LAUNCHES)
    small_expected = "mxu" if small_ident >= twf._DENSE_GATE_MIN_IDENTITY else "exact"
    small_chosen = small_score if small_expected == "mxu" else small_exact
    check(small_verdict == [small_expected] and torch.equal(first, small_chosen)
          and torch.equal(second, small_chosen)
          and counts1 == {key: 2 for key in rgb_path} and counts2 == {key: 1 for key in rgb_path},
          f"the gate at B={b} {h}x{w}: verdict {small_verdict}, identity {small_ident}, "
          f"launches {counts1} then {counts2}")
    log(f"[10] the gate on the card, B={b} {h}x{w} random frames, random 256 colours: least "
        f"identity {small_ident}, verdict {small_verdict[0]!r}; first call launches {counts1}, "
        f"second {counts2}")
    twf._DENSE_GATE_CACHE.clear()
    twf._DENSE_GATE_CACHE.update(cached)

    # The index stream and planar batches with the score search.
    out_idx, launches_idx = drive("DENSE_SEARCH=mxu, index stream",
                                  lambda: ditherer.apply_dithering_batch(frames16),
                                  ("skew", "ed_scan_idx", "unskew_idx"), "mxu", index="1")
    check(np.array_equal(out_idx, out_mxu), "score index stream != the RGB score output")
    planes16 = planes_of(frames16)
    out_planar, launches_planar = drive(
        "DENSE_SEARCH=mxu, planar",
        lambda: ditherer.apply_dithering_batch(planes16, planar=True),
        ("skew_planar", "ed_scan", "unskew_unpack"), "mxu")
    check(np.array_equal(np.moveaxis(out_planar, 0, -1), out_mxu),
          "score planar output != the RGB NHWC score output transposed")
    log(f"[10] main path FS k-means-256, DENSE_SEARCH=mxu: index stream (launches "
        f"{launches_idx}) and planar (launches {launches_planar}) == the RGB NHWC score "
        f"output, bitwise")

    # One PIL image: one float32 frame, through K1's float32 form.
    pil = Image.fromarray(frame0)
    pil_exact, launches_pil = drive("apply_dithering, exact",
                                    lambda: ditherer.apply_dithering(pil), rgb_path, None)
    gold0 = golden_frame(lib, ed_kernels.kernel_arrays, frame0, pal256_np, "floyd_steinberg")
    ident_pil = identity(pil_exact, gold0)
    check(ident_pil == 1.0, f"apply_dithering (one float32 frame) golden identity "
                            f"{ident_pil}")
    pil_mxu, _ = drive("apply_dithering, DENSE_SEARCH=mxu",
                       lambda: ditherer.apply_dithering(pil), rgb_path, "mxu")
    pil_auto, _ = drive("apply_dithering, DENSE_SEARCH=auto",
                        lambda: ditherer.apply_dithering(pil), rgb_path, "auto")
    check(np.array_equal(pil_auto, pil_exact), "a single image entered the gate")
    log(f"[10] apply_dithering(PIL {FULL_W}x{FULL_H}) FS k-means-256: launches "
        f"{launches_pil} (K1 on the float32 frame), golden identity {ident_pil} in exact "
        f"mode; DENSE_SEARCH=mxu identity with the exact output "
        f"{identity(pil_mxu, pil_exact)}; DENSE_SEARCH=auto == exact (a single image never "
        f"enters the gate)")
    for row in rows:
        row["launches"] += totals.get(row["name"], 0)
    # K7's own path: no facade call reaches its wrapper since the tile
    # kernel takes frames of either dtype, so its launches are those of its
    # entry point, ops.wavefront.skew_transpose, called as a caller of the
    # stream would on the PIL image's frame: its three type pairs, NHWC and
    # planes, counted from 0, each output held to the stream of the facade's
    # own K1 launch above (the frame as the facade sends it).
    frame_u8 = on_card(frame0[None])
    frame_f32 = frame_u8.to(torch.float32)
    calls = [(x, od) for x in (frame_u8, frame_f32) for od in
             ((None, torch.float32) if x.dtype == torch.uint8 else (None,))]
    build.reset_launch_counts()
    k7_outs = [(twf.skew_transpose(x, fs.s, od), twf.skew_transpose(
        x.permute(3, 0, 1, 2).reshape(3, FULL_H, FULL_W), fs.s, od)) for x, od in calls]
    sync(torch, dev)
    k7_launches = dict(build.LAUNCHES)
    check(k7_launches == {"skew_transpose": 2 * len(calls)},
          f"K7's path launched {k7_launches}")
    ref = twf.skew_gather(frame_f32, fs.s)
    for (x, od), outs in zip(calls, k7_outs):
        for got in outs:
            hold(torch, "skew_transpose", got, ref.to(got.dtype), errs,
                 f"K7's path, one {FULL_H}x{FULL_W} frame, {x.dtype} -> {got.dtype}")
    del k7_outs, ref
    totals["skew_transpose"] = k7_launches["skew_transpose"]
    log(f"[10] K7's path, ops.wavefront.skew_transpose on one {FULL_H}x{FULL_W} frame, u8 -> "
        f"u8, u8 -> f32 and f32 -> f32, NHWC and planes: launches {k7_launches}, each == "
        f"K1's stream of the frame")

    # Walls, all in this run.
    parts = []
    for label, search, frames, planar, index in (
            ("exact", None, frames16, False, "0"), ("mxu", "mxu", frames16, False, "0"),
            (f"auto (locked to {expected})", "auto", frames16, False, "0"),
            ("mxu, index stream", "mxu", frames16, False, "1"),
            ("mxu, planar", "mxu", planes16, True, "0")):
        med, walls = wall(search, frames, planar, index)
        parts.append(f"{label} median {med * 1e3:.3f} ms -> {BATCH / med:.2f} fps (5 runs: "
                     f"{', '.join(f'{t * 1e3:.3f}' for t in walls)})")
    log(f"[10] apply_dithering_batch wall, FS k-means-256, {BATCH}x{FULL_H}x{FULL_W} (numpy "
        f"u8 in/out) by DITHER_PIE_TPU_DENSE_SEARCH: {'; '.join(parts)} [{card}]")
    path_ms = {}
    for search in twf.DENSE_SEARCHES:
        path_ms[search], _ = cuda_ms(
            torch, lambda: twf.ed_batch_wavefront(batch_t, pals_t[256], dense_search=search), 3)
    log(f"[10] device path K1+K2+K3, FS k-means-256 (tensors on the card): exact "
        f"{path_ms['exact']:.3f} ms, mxu {path_ms['mxu']:.3f} ms per batch{BATCH} [{card}]")

    # --- T2: the search probe ---------------------------------------------
    t0 = time.perf_counter()
    iters = 64
    n_holds = 0
    for pp in (256, 1024):
        cur_np, pal_np = probe.probe_inputs(pp)
        cur, pal_t = on_card(cur_np), on_card(pal_np)
        aug = convert.augment_palette(pal_t)
        want_exact = probe.search_exact_plain(cur, pal_t)
        want_score = probe.search_score_plain(cur, aug)
        for n in twf.CLUSTER_SIZES:
            for n_iter in (1, iters):
                hold(torch, "search_probe", probe.search_exact(cur, pal_t, n_iter, n),
                     want_exact, errs, f"exact sweep, pp={pp}, n={n}, {n_iter}x")
                hold(torch, "search_probe", probe.search_score(cur, aug, n_iter, n),
                     want_score, errs, f"score form, pp={pp}, n={n}, {n_iter}x")
                n_holds += 2
    log(f"[10] kernel == plain, bitwise: both search-probe kernels at pp = 256 and 1024, "
        f"nb={probe.NB} lf={probe.LF}, a frame over n = {twf.CLUSTER_SIZES} blocks, 1 and "
        f"{iters} repetitions: {n_holds} comparisons ({time.perf_counter() - t0:.1f} s)")
    build.reset_launch_counts()
    probed = {str(pp): probe.probe(pp, iters, dev) for pp in (256, 1024)}
    probe_launches = build.LAUNCHES["search_probe"]
    check(set(build.LAUNCHES) == {"search_probe"} and probe_launches >= 4,
          f"the probe launched {dict(build.LAUNCHES)}")
    for pp, r in probed.items():
        log(f"[10] search probe pp={pp} lf={probe.LF} iters={iters} n={r['n']}: exact "
            f"{r['exact_us_per_rep']:.3f} us a repetition, score "
            f"{r['score_us_per_rep']:.3f}, speedup {r['exact_ms'] / r['score_ms']:.2f}x; flip "
            f"fraction of score against exact: random inputs {r['flip_fraction']:.6f}, "
            f"k-means inputs {r['flip_fraction_kmeans']:.6f} [{card}]")
    # The n sweep and the fit of a repetition to c_n + k * P / n.
    t0 = time.perf_counter()
    probe_sweep = probe.sweep(iters, dev)
    for form, by_n in probe_sweep["us_per_rep"].items():
        log(f"[10] search probe sweep, {form}, us a repetition (one launch of {iters}): "
            + "; ".join(f"n={n} " + ", ".join(f"P={p} {t:.3f}" for p, t in by_p.items())
                        for n, by_p in by_n.items()) + f" [{card}]")
    fit = probe_sweep["fit"]
    log(f"[10] search probe fit (exact): a repetition = c_n + k * P / n, k = "
        f"{fit['k_us']:.5f} us, " + ", ".join(f"c_{n} = {c:.4f} us"
                                             for n, c in fit["c_us"].items())
        + f", largest residual {fit['max_residual_us']:.4f} us "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")
    # The row's times: the exact form at 256 colours with the plan's n,
    # device time a repetition of one launch of 64, and one launch of one
    # repetition as a CUDA graph of 100 launches; the plain version on the
    # same inputs (one repetition).
    from dither_pie_tpu_torch.tools.time_ed_path import graph_ms

    cur_np, pal_np = probe.probe_inputs(256)
    cur, pal_t = on_card(cur_np), on_card(pal_np)
    rep_ms, got = cuda_ms(torch, lambda: probe.search_exact(cur, pal_t, iters), 5)
    rep_ms /= iters
    want = probe.search_exact_plain(cur, pal_t)
    hold(torch, "search_probe", got, want, errs, "the timed exact form, pp=256")
    one_graph_ms = graph_ms(lambda: probe.search_exact(cur, pal_t, 1))
    one_plain_ms, _ = cuda_ms(torch, lambda: probe.search_exact_plain(cur, pal_t), 3)
    n_lanes = probe.NB * probe.LF
    probe_bound = bound(cur.numel() * 4 + pal_t.numel() * 4 + n_lanes * 4, n_lanes * 256 * 8)
    log(f"[10] search probe row: exact, pp=256, n={probe.probe_cluster_size(256)}: "
        f"{rep_ms:.5f} ms a repetition (one launch of {iters}), {one_graph_ms:.5f} ms a launch "
        f"of one repetition in a CUDA graph of 100; plain {one_plain_ms:.3f} ms; bound "
        f"{probe_bound['bound_ms']:.6f} ms by {probe_bound['bound_by']} [{card}]")

    new_rows = [{"name": "skew_transpose", "route": "cuda", "source": DENSE_KERNELS[0][1],
                 "replaces": DENSE_KERNELS[0][2], "launches": totals["skew_transpose"],
                 "max_abs_err": errs["skew_transpose"], "ms": k7_ms, "plain_ms": k7_plain_ms,
                 "planes_ms": k7p_ms, "k1_ms": k1_ms, "k6_ms": k6_ms, "f32_ms": k7f_ms,
                 "k1_f32_ms": k1f_ms, "f32_bound_ms": f32_bound["bound_ms"],
                 "u8_f32_ms": k7uf_ms, "u8_f32_planes_ms": k7ufp_ms,
                 "u8_f32_bound_ms": u8f_bound["bound_ms"], **k7_bound},
                {"name": "search_probe", "route": "cuda", "source": DENSE_KERNELS[1][1],
                 "replaces": DENSE_KERNELS[1][2], "launches": probe_launches,
                 "max_abs_err": errs["search_probe"], "ms": rep_ms, "graph_ms": one_graph_ms,
                 "plain_ms": one_plain_ms, "n": probe.probe_cluster_size(256),
                 "probe": probed, "sweep": probe_sweep, **probe_bound}]
    return new_rows


# ---------------------------------------------------------------------------
# Phase 12: K2 and K8 over thread-block clusters
# ---------------------------------------------------------------------------

CLUSTER_BATCHES = (1, 3, 17, 33, 133)  # the plan's n from 8 down to 1
CLUSTER_PALETTES = (2, 3, 7, 33, 65, 100, 1023, 2049)


def cluster_phase(torch, dev, card, frames16, errs):
    """Phase 12: the scan over a cluster of n blocks, the palette split in
    rank order, held to the plain scan bitwise at every n. Returns the
    number of kernel == plain comparisons."""
    from dither_pie_tpu_torch.ops import wavefront as twf

    t0 = time.perf_counter()
    rng = np.random.RandomState(12)
    _, h, w = SMALL
    fs = twf.scan_geometry("floyd_steinberg")
    count = [0]

    def on_card(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def hold_sizes(frames_t, pal_t, geom, aux, what, searches=("exact",), sizes=(1, 2, 4, 8)):
        """K2 (up to 1024 colours) and K8, each search, at the plan's n and
        at every n in ``sizes`` up to P, against one plain run each.
        Returns {(output, search): (the plan's n, {n: output})}."""
        stream = twf.skew(frames_t, geom.s)
        p = pal_t.shape[0]
        found = {}
        for emit_idx in ((False, True) if p <= twf.PACKED_PALETTE_MAX else (True,)):
            key = "ed_scan_idx" if emit_idx else "ed_scan"
            kern, plain = ((twf.scan_idx, twf.scan_idx_plain) if emit_idx
                           else (twf.scan, twf.scan_plain))
            for search in searches:
                want = plain(stream, pal_t, geom, w, aux, search)
                plan_n = twf.launch_plan(stream, pal_t, geom, emit_idx, search).n
                outs = {0: kern(stream, pal_t, geom, w, aux, search)}
                for n in sizes:
                    if n <= p:
                        outs[n] = twf.launch_scan(stream, pal_t, geom, w, aux, emit_idx,
                                                  search, n)
                sync(torch, dev)
                for n, got in outs.items():
                    hold(torch, key, got, want, errs,
                         f"{what}, P={p}, {search}, n={n or f'{plan_n} (plan)'}")
                    count[0] += 1
                found[(key, search)] = (plan_n, outs)
        return found

    # (a) The plan at every batch size, FS on random u8 frames: K2 and K8 at
    # the plan's n and at every n up to P.
    picked = {}
    for b in CLUSTER_BATCHES:
        frames_t = on_card(rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8))
        for p in CLUSTER_PALETTES:
            got = hold_sizes(frames_t, on_card(unique_palette(rng, p)), fs, None,
                             f"FS B={b}")
            picked[(b, p)] = got[("ed_scan_idx", "exact")][0]
    log(f"[12] kernel == plain, bitwise, K2 and K8 FS at {h}x{w}, B in {CLUSTER_BATCHES} x P in "
        f"{CLUSTER_PALETTES}, each at the plan's n and at every n <= min(8, P); the plan's n "
        f"by (B, P): {picked} ({time.perf_counter() - t0:.1f} s)")
    # The same batch sizes at the main path's frame size, where a block has
    # 1024 threads and one SM holds one: the plan goes down from 8 to 1 as
    # the clusters stop fitting the card at once (a stream of zero strides
    # carries the launch's shape).
    pal_t = on_card(unique_palette(rng, 1023))
    by_b = {}
    for b in CLUSTER_BATCHES:
        shape = (twf.stream_length(FULL_H, FULL_W, fs.s), 3 * b, FULL_H)
        stream = torch.zeros(1, dtype=torch.uint8, device=dev).expand(*shape)
        by_b[b] = twf.launch_plan(stream, pal_t, fs, True).n
    log(f"[12] the plan's n at {FULL_H}x{FULL_W}, K8 at 1023 colours, by batch: {by_b}")
    check(set(by_b.values()) == {1, 2, 4, 8},
          f"the plan did not take every cluster size over the batches at 1023 colours: {by_b}")

    # (b) Every mode, u8 and float32, both outputs, both searches.
    t1 = time.perf_counter()
    b = 3
    small = {"u8": rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
             "f32": rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32)}
    gates = on_card((rng.rand(b, h, w) < 0.5).astype(np.float32))
    pals = {33: on_card(unique_palette(rng, 33)), 100: on_card(unique_palette(rng, 100))}
    for mode in twf.MODES:
        lum, col = (0.7, 0.45) if mode == "hybrid" else (1.0, 0.2)
        geom = twf.scan_geometry("floyd_steinberg" if mode == "fixed" else "", mode, lum, col)
        for name, arr in small.items():
            frames_t = on_card(arr)
            aux = (twf.perceptual_sensitivity(frames_t) if mode == "perceptual"
                   else gates if mode == "adaptive" else None)
            hold_sizes(frames_t, pals[33], geom, aux, f"{mode} {name}")
            hold_sizes(frames_t, pals[100], geom, aux, f"{mode} {name}",
                       searches=("exact", "mxu"))
    jjn = twf.scan_geometry("jjn")
    hold_sizes(on_card(small["u8"]), pals[100], jjn, None, "jjn u8", searches=("exact", "mxu"))
    log(f"[12] kernel == plain, bitwise: 5 modes x (u8, f32) x (K2, K8) at B={b} {h}x{w}, "
        f"P=33 exact and P=100 exact and score, jjn at P=100, each at the plan's n and n in "
        f"(1, 2, 4, 8) ({time.perf_counter() - t1:.1f} s)")

    # (c) A colour planted on both sides of every slice boundary (index
    # hi_r - 1 repeated at hi_r): the lower index must win; frames flat on
    # those colours give exact distance-0 ties across ranks.
    t1 = time.perf_counter()
    planted = 0
    for p in (65, 1023, 2049):
        for n in (2, 4, 8):
            bounds = twf.palette_slices(p, n)
            pal_np = unique_palette(rng, p)
            for hi in bounds[1:-1]:
                pal_np[hi] = pal_np[hi - 1]
            frames = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
            frames[0] = pal_np[bounds[1] - 1].astype(np.uint8)
            frames[1] = pal_np[bounds[-2] - 1].astype(np.uint8)
            frames[2, :, : w // 2] = pal_np[bounds[n // 2] - 1].astype(np.uint8)
            searches = ("exact", "mxu") if twf.score_search("mxu", p) else ("exact",)
            got = hold_sizes(on_card(frames), on_card(pal_np), fs, None,
                             f"planted boundaries n={n}", searches=searches, sizes=(n,))
            for search in searches:
                for idx in got[("ed_scan_idx", search)][1].values():
                    idx = idx.cpu().numpy()
                    check(not np.isin(idx, bounds[1:-1]).any(),
                          f"a slice's first colour won over its planted twin below the "
                          f"boundary (P={p}, n={n}, {search})")
                    planted += 1
    # Exact ties between neighbours across a boundary: a flat frame midway
    # between colour hi_0 - 1 and colour hi_0.
    for p, n in ((2, 2), (7, 2), (7, 4), (33, 8)):
        bounds = twf.palette_slices(p, n)
        pal_np = rng.randint(180, 256, (p, 3)).astype(np.float32)
        pal_np[bounds[1] - 1] = (100, 100, 100)
        pal_np[bounds[1]] = (102, 100, 100)
        ties = np.empty((b, h, w, 3), np.uint8)
        ties[...] = (101, 100, 100)
        got = hold_sizes(on_card(ties), on_card(pal_np), fs, None, f"exact ties n={n}",
                         sizes=(n,))
        idx = got[("ed_scan_idx", "exact")][1][n].cpu().numpy()
        # Each frame's first pixel is the exact tie (the error moves the rest).
        check((idx[0, :, 0] == bounds[1] - 1).all(),
              f"a tie across the slice boundary went to the later colour (P={p}, n={n})")
    log(f"[12] kernel == plain, bitwise: colours planted on both sides of every slice "
        f"boundary at P in (65, 1023, 2049) x n in (2, 4, 8), exact and score, no later twin "
        f"emitted ({planted} index streams); flat frames whose first pixel ties exactly across "
        f"the first boundary at (P, n) in ((2, 2), (7, 2), (7, 4), (33, 8)) took the lower index "
        f"({time.perf_counter() - t1:.1f} s)")

    # Residency: how many clusters of n blocks the card holds at once for
    # the main path's 16 x 1080p launches, and the n the plan takes.
    batch_t = on_card(frames16)
    stream = twf.skew(batch_t, fs.s)
    caps = {}
    for p in (32, 64, 256, 1024):
        pal_t = on_card(unique_palette(rng, p))
        caps[p] = ({n: twf.launch_capacity(stream, pal_t, fs, n) for n in (1, 2, 4, 8)},
                   twf.launch_plan(stream, pal_t, fs).n)
    del stream
    log(f"[12] clusters resident at once, FS {BATCH}x{FULL_H}x{FULL_W}, by P: "
        + "; ".join(f"P={p}: {c} -> plan n={n}" for p, (c, n) in caps.items())
        + f" ({count[0]} comparisons in all, {time.perf_counter() - t0:.1f} s) [{card}]")
    return count[0]


# ---------------------------------------------------------------------------
# Phase 11: wavelet and halftone, K4 on float32 frames, the probes T1 and T3
# ---------------------------------------------------------------------------

T1_ROWS = 4096  # T1's row time: the gather alone on a 4096 x 128 table
PROBE_KERNELS = [
    ("gather_probe", "dither_pie_tpu_torch/kernels/csrc/gather_probe.cu",
     "tools/gather_probe.py:24"),
    ("identity", "dither_pie_tpu_torch/kernels/csrc/identity.cu",
     "tools/xla_layout_repro.py:39"),
]


def quant_twin(sub, noise, q_levels):
    """float64 twin of the wavelet mode's subband quantiser."""
    mn, mx = sub.min(), sub.max()
    scale = mx - mn
    if scale == 0:
        return sub
    q = np.clip(np.floor((sub - mn) / (scale + 1e-9) * q_levels + noise), 0, q_levels - 1)
    return q / (q_levels - 1 + 1e-9) * scale + mn


def wavelet_twin(frame, pal, wavelet, q_levels, noises, thr):
    """numpy twin of the wavelet mode on one frame: the float64 transform
    (the port's numpy copy of the filter banks), the float64 quantiser, and
    the ordered pick of ``ordered_twin`` on the reconstruction."""
    from dither_pie_tpu_torch.ops import wavelet as twav

    h, w, _ = frame.shape
    chans = []
    for ch in range(3):
        cA, details = twav.dwt2_np(frame[:, :, ch], wavelet)
        subs = [quant_twin(sub, noises[ch, k].astype(np.float64), q_levels)
                for k, sub in enumerate((cA, *details))]
        rec = twav.idwt2_np(subs[0], subs[1:], wavelet)
        chans.append(np.clip(rec[:h, :w], 0, 255))
    rec = np.stack(chans, axis=-1).astype(np.float32)
    return ordered_twin(rec[None], pal, thr)[0]


def halftone_twin(frame, pal, screen, cell_idx, n_cells):
    """float64 numpy twin of the halftone mode on one frame."""
    px = frame.reshape(-1, 3).astype(np.float64)
    flat = cell_idx.reshape(-1)
    counts = np.maximum(np.bincount(flat, minlength=n_cells), 1)[:, None]
    avgs = np.stack([np.bincount(flat, px[:, c], n_cells) for c in range(3)], 1) / counts
    pal64 = pal.astype(np.float64)
    cell_pal = ((avgs[:, None, :] - pal64[None]) ** 2).sum(-1).argmin(1)
    weights = np.array([0.299, 0.587, 0.114])
    paper = int((pal64 @ weights).argmax())
    ink = (1.0 - (px @ weights) / 255.0) > screen.reshape(-1)
    idx = np.where(ink, cell_pal[flat], paper)
    return pal[idx].astype(np.int32).astype(np.uint8).reshape(frame.shape)


def transform_phase(torch, dev, card, frames16, palette32, rows, errs):
    """Phase 11; adds the float32 times to K4's row and returns the
    kernels-line rows of the gather probe and the identity."""
    from PIL import Image

    import dither_pie_tpu_torch as dpt
    from dither_pie_tpu_torch.api import ditherer as tditherer
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.ops import halftone as thalf
    from dither_pie_tpu_torch.ops import ordered as tord
    from dither_pie_tpu_torch.ops import ordered_fused as tof
    from dither_pie_tpu_torch.ops import wavelet as twav
    from dither_pie_tpu_torch.core import thresholds as thr

    def on_card(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    pal_np = np.asarray(palette32, np.float32)
    pal_t = on_card(pal_np)
    k4_row = next(r for r in rows if r["name"] == "ordered_fused")

    # --- K4 on float32 frames == plain, bitwise ---------------------------
    t0 = time.perf_counter()
    rng = np.random.RandomState(11)
    b, h, w = SMALL
    small_f32 = on_card(rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32))
    small_u8 = on_card(rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8))
    small_screens = {"random": on_card(rng.rand(h, w).astype(np.float32)),
                     "bayer8x8": tord.screen_for_matrix(thr.bayer_matrix("8x8"), h, w, dev)}
    for p in (2, 16, 33, 300):
        pal = on_card(rng.randint(0, 256, (p, 3)).astype(np.float32))
        for name, screen in small_screens.items():
            ind = (False, True) if p <= 256 else (False,)
            compare_ordered(torch, tof, small_f32, pal, screen, errs,
                            f"float32 B={b} {h}x{w} P={p} {name}", ind)
            # Integer-valued float32 frames: the u8 instantiation's output.
            for i in ind:
                check(torch.equal(
                    tof.ordered_dither_fused(small_u8.to(torch.float32), pal, screen, i),
                    tof.ordered_dither_fused(small_u8, pal, screen, i)),
                    f"ordered_fused: integer-valued float32 frames != u8 frames (P={p} {name})")
    for colour, pal_rows in (((101, 100, 100), [[100, 100, 100], [102, 100, 100], [0, 0, 0]]),
                             ((40.5, 50.25, 60), [[0, 0, 0], [40.5, 50.25, 60], [40.5, 50.25, 60]]),
                             ((100.5, 100, 100), [[100, 100, 100], [101, 100, 100], [0, 0, 0]])):
        flat = torch.tensor(colour, dtype=torch.float32, device=dev).expand(b, h, w, 3).contiguous()
        pal = torch.tensor(pal_rows, dtype=torch.float32, device=dev)
        for level in (0.0, 0.5, 1.0):
            compare_ordered(torch, tof, flat, pal,
                            torch.full((h, w), level, dtype=torch.float32, device=dev),
                            errs, f"float32 exact ties {colour} screen {level}")
    log(f"[11] ordered_fused (float32 frames) == plain, bitwise: B={b} {h}x{w} P in (2, 16, "
        f"33, 300) x (random, Bayer 8x8 screens), non-integer frames, colours and indices "
        f"(P <= 256), flat float32 frames of exact ties; integer-valued float32 frames == "
        f"the u8 frames' output ({time.perf_counter() - t0:.1f} s)")

    # Full size: a wavelet reconstruction of the 16 frames, and its times.
    t0 = time.perf_counter()
    batch_t = on_card(frames16)
    haar = dpt.WaveletDitherStrategy("haar", 8, 42, device=dev)
    noises_np, thr_np = haar._draw_noise(FULL_H, FULL_W)
    noises_t, thr_t = on_card(noises_np), on_card(thr_np)
    rec = haar.reconstruct(batch_t, noises_t)
    check(rec.dtype == torch.float32 and tuple(rec.shape) == frames16.shape,
          f"wavelet reconstruction {tuple(rec.shape)} {rec.dtype}")
    frac = float((rec != rec.floor()).float().mean())
    check(frac > 0.5, f"the wavelet reconstruction is integer-valued ({frac})")
    compare_ordered(torch, tof, rec, pal_t, thr_t, errs,
                    f"float32 {BATCH}x{FULL_H}x{FULL_W} wavelet reconstruction")
    as_f32 = batch_t.to(torch.float32)
    check(torch.equal(tof.ordered_dither_fused(as_f32, pal_t, thr_t),
                      tof.ordered_dither_fused(batch_t, pal_t, thr_t)),
          f"ordered_fused: integer-valued float32 != u8 at {BATCH}x{FULL_H}x{FULL_W}")
    f32_ms, got = cuda_ms(torch, lambda: tof.ordered_dither_fused(rec, pal_t, thr_t), 5)
    f32_plain_ms, want = cuda_ms(
        torch, lambda: tof.ordered_dither_fused_plain(rec, pal_t, thr_t), 3)
    check(torch.equal(got, want), "ordered_fused (float32) != plain on the timed run")
    u8_ms, _ = cuda_ms(torch, lambda: tof.ordered_dither_fused(batch_t, pal_t, thr_t), 5)
    n_px = BATCH * FULL_H * FULL_W
    f32_bound = bound(n_px * 12 + n_px * 3 + FULL_H * FULL_W * 4 + len(pal_np) * 12,
                      n_px * 8 * len(pal_np))
    del as_f32
    log(f"[11] ordered_fused (float32 frames) == plain, bitwise, at {BATCH}x{FULL_H}x{FULL_W} on "
        f"a wavelet reconstruction ({frac:.3f} of its values hold a fraction), k-means-32, "
        f"colours and indices; integer-valued float32 == u8 there; kernel {f32_ms:.3f} ms "
        f"(u8 frames, same palette and screen: {u8_ms:.3f} ms), plain PyTorch "
        f"{f32_plain_ms:.3f} ms, bound {f32_bound['bound_ms']:.4f} ms by "
        f"{f32_bound['bound_by']} ({time.perf_counter() - t0:.1f} s) [{card}]")

    # --- the main paths, each with its own launch counts ------------------
    cases = [("WAVELET haar/8/42", dpt.DitherMode.WAVELET,
              {"wavelet": "haar", "subband_quant": 8, "seed": 42}),
             ("WAVELET db4/16/7", dpt.DitherMode.WAVELET,
              {"wavelet": "db4", "subband_quant": 16, "seed": 7}),
             ("HALFTONE defaults", dpt.DitherMode.HALFTONE, {}),
             ("HALFTONE 6/30/diamond", dpt.DitherMode.HALFTONE,
              {"cell_size": 6, "angle": 30.0, "shape": "diamond"})]
    single = 3  # the frame that also goes through apply_dithering
    pil = Image.fromarray(frames16[single])
    walls = {}
    f32_launches = 0
    for name, mode, params in cases:
        is_wavelet = mode is dpt.DitherMode.WAVELET
        d = dpt.ImageDitherer(num_colors=N_COLORS, dither_mode=mode, palette=palette32,
                              dither_params=params, device=dev)
        build.reset_launch_counts()
        out16 = d.apply_dithering_batch(frames16)
        out_pil = np.asarray(d.apply_dithering(pil))
        sync(torch, dev)
        launches = dict(build.LAUNCHES)
        log(f"[11] {name} main path launches: {launches}")
        if is_wavelet:
            check(launches == {"ordered_fused": 2},
                  f"{name}: expected ordered_fused twice (batch and image), got {launches}")
            f32_launches += launches["ordered_fused"]
        else:
            check(launches == {}, f"{name}: halftone launched {launches}")
        check(out16.shape == frames16.shape and out16.dtype == np.uint8,
              f"{name} batch output {out16.shape} {out16.dtype}")
        check(palette_only(out16, pal_np), f"{name} batch holds colours outside the palette")
        check(out_pil.shape == frames16[single].shape and out_pil.dtype == np.uint8,
              f"{name} apply_dithering output {out_pil.shape}")
        check(np.array_equal(out_pil, out16[single]),
              f"{name}: apply_dithering of frame {single} != the batch's frame {single}")
        # The index stream forced on == the RGB output, bitwise.
        build.reset_launch_counts()
        with index_transfer("1"):
            out_idx = d.apply_dithering_batch(frames16)
        idx_launches = dict(build.LAUNCHES)
        check(idx_launches == ({"ordered_fused": 1} if is_wavelet else {}),
              f"{name} index stream launched {idx_launches}")
        check(np.array_equal(out_idx, out16), f"{name}: index stream != RGB output")
        # The card against the CPU device (the plain path) on 2 frames.
        cpu = dpt.ImageDitherer(num_colors=N_COLORS, dither_mode=mode, palette=palette32,
                                dither_params=params, device="cpu")
        out_cpu = cpu.apply_dithering_batch(frames16[:2])
        check(np.array_equal(out_cpu, out16[:2]),
              f"{name}: card != CPU device (identity "
              f"{[identity(a, c) for a, c in zip(out16[:2], out_cpu)]})")
        # A numpy float64 twin.
        strategy = d._get_dither_strategy(mode)
        if is_wavelet:
            noises, thresholds = strategy._draw_noise(FULL_H, FULL_W)
            twins = [wavelet_twin(f, pal_np, params["wavelet"], params["subband_quant"],
                                  noises, thresholds) for f in frames16[:2]]
            floor = 0.98
        else:
            screen, cell_idx, n_cells = thalf.halftone_screen(
                FULL_H, FULL_W, **strategy.get_current_parameters())
            twins = [halftone_twin(f, pal_np, screen, cell_idx, n_cells) for f in frames16[:2]]
            floor = 0.995
        idents = [identity(o, t) for o, t in zip(out16[:2], twins)]
        check(min(idents) >= floor, f"{name}: numpy float64 twin identity {idents} < {floor}")
        wall, all_walls = median_wall(lambda: d.apply_dithering_batch(frames16))
        walls[name] = wall
        log(f"[11] {name}: {out16.shape} uint8, palette-only; apply_dithering(PIL frame "
            f"{single}) == the batch's frame; index stream == RGB bitwise (launches "
            f"{idx_launches}); card == CPU device bitwise on 2 frames; numpy float64 twin "
            f"identity {idents} (>= {floor}); wall median {wall * 1e3:.3f} ms/batch{BATCH} -> "
            f"{BATCH / wall:.2f} fps (5 runs: "
            f"{', '.join(f'{t * 1e3:.3f}' for t in all_walls)}) [{card}]")

    # Device times of the wavelet's stages and of halftone, tensors on the card.
    planes = batch_t.permute(0, 3, 1, 2).to(torch.float32)
    dwt_ms, (cA, details) = cuda_ms(torch, lambda: twav.dwt2(planes, "haar"), 5)
    quant_ms, subs = cuda_ms(torch, lambda: [
        tditherer._quant_subband(sub, noises_t[:, k], 8)
        for k, sub in enumerate((cA, *details))], 5)
    idwt_ms, _ = cuda_ms(torch, lambda: twav.idwt2(subs[0], subs[1:], "haar")[
        :, :, :FULL_H, :FULL_W].clamp(0, 255).permute(0, 2, 3, 1).contiguous(), 5)
    del planes, cA, details, subs
    screen, cell_idx, n_cells = thalf.halftone_screen(FULL_H, FULL_W)
    screen_t, cell_t = on_card(screen), on_card(cell_idx)
    half_ms, _ = cuda_ms(torch, lambda: thalf.halftone_dither_batch(
        batch_t, pal_t, screen_t, cell_t, n_cells), 5)
    # Host work inside the walls: the wavelet's noise is drawn anew on every
    # call (as in the JAX package); the halftone screen is cached by shape.
    noise_s, _ = median_wall(lambda: haar._draw_noise(FULL_H, FULL_W))
    thalf._SCREEN_CACHE.clear()
    t0 = time.perf_counter()
    thalf.halftone_screen(FULL_H, FULL_W)
    screen_first_s = time.perf_counter() - t0
    log(f"[11] host times at {FULL_H}x{FULL_W}: the wavelet's noise (haar: "
        f"{noises_np.size + thr_np.size} RandomState samples a call) median "
        f"{noise_s * 1e3:.3f} ms of 5; halftone_screen, first call (float64 numpy, then "
        f"cached) {screen_first_s * 1e3:.3f} ms [{card}]")
    log(f"[11] device times at {BATCH}x{FULL_H}x{FULL_W} k-means-32 (tensors on the card): "
        f"wavelet haar DWT {dwt_ms:.3f} ms, quantise {quant_ms:.3f} ms, IDWT + crop + clip + "
        f"NHWC {idwt_ms:.3f} ms, K4 on float32 {f32_ms:.3f} ms; halftone (torch ops, "
        f"{n_cells} cells) {half_ms:.3f} ms [{card}]")
    k4_row.update(f32_ms=f32_ms, f32_plain_ms=f32_plain_ms, f32_bound_ms=f32_bound["bound_ms"],
                  f32_launches=f32_launches,
                  max_abs_err=max(k4_row["max_abs_err"], errs["ordered_fused"]))
    del rec, batch_t

    return [gather_phase(torch, dev, card, errs),
            identity_phase(torch, dev, card, frames16, errs)]


def gather_phase(torch, dev, card, errs):
    """Phase 11's T1: the gather in its three forms (``gather_slab_plan``:
    block, multicast, distributed) == its plain version and
    np.take_along_axis at every table height of the tool, its chains at
    k = 1 and 68 in both updates, output rows that are not the table's, a
    table off the 16-byte boundary; the L2 line (``gather_chain_l2``, the
    block body on the table in device memory) likewise; the launcher's
    refusals; the select sweep == the gather on its tile; the tool's lines
    with their launch counts; the row's times beside the floor (an empty
    kernel, a 4 MB copy) and the L2 line in CUDA graphs of 100. Returns the
    kernels-line row of T1."""
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.tools import gather_probe as gp

    def on_card(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    t0 = time.perf_counter()
    forms = {}

    def form_of(tbl, idx):
        """The default plan's form, recorded by table height."""
        plan = gp.gather_slab_plan(tbl.shape[0], idx.shape[0], tbl.shape[1])
        forms[(tbl.shape[0], plan.form)] = plan.cluster
        return plan

    # The plan's forms (gather_chain) and the L2 line (gather_chain_l2).
    lines = (("gather_probe", gp.gather_chain, ""), ("gather_probe_l2", gp.gather_chain_l2,
                                                     " (L2 line)"))
    for n_rows in gp.CHECK_ROWS:
        tbl_np, idx_np = gp.gather_inputs(n_rows)
        tbl, idx = on_card(tbl_np), on_card(idx_np)
        form_of(tbl, idx)
        for key, fn, what in lines:
            got = fn(tbl, idx)
            hold(torch, key, got, gp.gather_chain_plain(tbl, idx), errs,
                 f"gather, rows={n_rows}{what}")
            check(np.array_equal(got.cpu().numpy(), np.take_along_axis(tbl_np, idx_np, axis=0)),
                  f"gather rows={n_rows}{what} != np.take_along_axis")
    for n_rows in gp.CHAIN_ROWS:
        tbl, idx = (on_card(a) for a in gp.chain_inputs(n_rows))
        form_of(tbl, idx)
        for update in ("chain", "sweep"):
            for k in (1, 68):
                want = gp.gather_chain_plain(tbl, idx, k, update)
                for key, fn, what in lines:
                    hold(torch, key, fn(tbl, idx, k, update), want, errs,
                         f"gather {update}, rows={n_rows}, k={k}{what}")
    # Output rows that are not the table's, nor a multiple of 8.
    rng = np.random.RandomState(11)
    for n_rows, n in ((512, 37), (1024, 333), (4096, 1001), (7169, 50), (16384, 777)):
        tbl_np = rng.randint(0, n_rows, (n_rows, gp.LF)).astype(np.int32)
        idx_np = rng.randint(0, n_rows, (n, gp.LF)).astype(np.int32)
        tbl, idx = on_card(tbl_np), on_card(idx_np)
        form_of(tbl, idx)
        got = gp.gather_chain(tbl, idx)
        hold(torch, "gather_probe", got, gp.gather_chain_plain(tbl, idx), errs,
             f"gather, rows={n_rows}, n={n}")
        check(np.array_equal(got.cpu().numpy(), np.take_along_axis(tbl_np, idx_np, axis=0)),
              f"gather rows={n_rows} n={n} != np.take_along_axis")
        for update, k in (("chain", 68),) + ((("sweep", 68),) if n_rows & (n_rows - 1) == 0
                                              else ()):
            hold(torch, "gather_probe", gp.gather_chain(tbl, idx, k, update),
                 gp.gather_chain_plain(tbl, idx, k, update), errs,
                 f"gather {update}, rows={n_rows}, n={n}, k={k}")
    # A table off the 16-byte boundary goes as a fresh copy; the launcher
    # itself refuses it, a width that is not whole lane groups, a plan that
    # is not the plan function's: among them a multicast cluster of 4 and a
    # cluster above 8.
    tbl, idx = (on_card(a) for a in gp.gather_inputs(4096))
    shifted = torch.empty(tbl.numel() + 1, dtype=torch.int32, device=dev)[1:].view(tbl.shape)
    shifted.copy_(tbl)
    hold(torch, "gather_probe", gp.gather_chain(shifted, idx), gp.gather_chain_plain(tbl, idx),
         errs, "gather, a table 4 bytes off the 16-byte boundary")
    plan = gp.gather_slab_plan(4096, 4096, gp.LF)
    narrow = tbl[:, :100].contiguous()
    refusals = {"a table off the 16-byte boundary": (shifted, idx, plan),
                "lanes % 8 != 0": (narrow, idx[:, :100].contiguous(), plan),
                "a plan that is not the plan function's":
                    (tbl, idx, dataclasses.replace(plan, rows_per_block=plan.rows_per_block + 1)),
                "a multicast cluster of 4": (tbl, idx, dataclasses.replace(plan, cluster=4)),
                "a cluster of 16": (tbl, idx, dataclasses.replace(plan, cluster=16)),
                "a distributed plan for a multicast table":
                    (tbl, idx, dataclasses.replace(plan, form="distributed", cluster=8))}
    for what, (t, i, pl) in refusals.items():
        try:
            gp.launch_gather(t, i, torch.empty_like(i), 1, "none", pl)
            refused = False
        except RuntimeError:
            refused = True
        check(refused, f"the gather launcher took {what}")
    sync(torch, dev)
    log(f"[11] kernel == plain, bitwise: the gather at rows {gp.CHECK_ROWS} (== "
        f"np.take_along_axis), the chains \"chain\" and \"sweep\" at rows {gp.CHAIN_ROWS} "
        f"(k = 1 and 68), each also on the L2 line, the gather and both chains at "
        f"(rows, n) = (512, 37), (1024, 333), (4096, 1001), (7169, 50), (16384, 777), and "
        f"a table off the 16-byte boundary; the launcher refuses "
        f"{', '.join(refusals)}; forms by table height "
        f"{', '.join(f'{r}: {f} C={c}' for (r, f), c in sorted(forms.items()))} "
        f"({time.perf_counter() - t0:.1f} s)")
    k_hi = gp.SWEEP_K[0] + gp.SWEEP_K[1] * 64
    for p in gp.SWEEP_SIZES:
        tbl, idx = (on_card(a) for a in gp.sweep_inputs(p))
        hold(torch, "gather_probe", gp.sweep_chain(tbl, idx, 3),
             gp.sweep_chain_plain(tbl, idx, 3), errs, f"select sweep, P={p}, k=3")
        same_tile = gp.gather_chain(tbl, idx, k_hi, "sweep")
        hold(torch, "gather_probe", same_tile, gp.gather_chain_plain(tbl, idx, k_hi, "sweep"),
             errs, f"gather on the sweep's tile, P={p}, k={k_hi}")
        hold(torch, "gather_probe", gp.sweep_chain(tbl, idx, k_hi), same_tile, errs,
             f"select sweep against the gather on its tile, P={p}, k={k_hi}")
    log(f"[11] the select sweep == plain at P {gp.SWEEP_SIZES} (k = 3), and at k = {k_hi} the "
        f"sweep == the gather chain on its tile == that chain's plain version")
    # The tool's lines, with the launch counts of its run.
    build.reset_launch_counts()
    checks = {n_rows: gp.check_gather(n_rows, dev) for n_rows in gp.CHECK_ROWS}
    chains = {str(n_rows): gp.probe_chain(n_rows, 64, dev) for n_rows in gp.CHAIN_ROWS}
    sweeps = {str(p): gp.probe_sweep(p, 64, dev) for p in gp.SWEEP_SIZES}
    gather_launches = build.LAUNCHES["gather_probe"]
    sweep_launches = build.LAUNCHES["gather_probe_sweep"]
    l2_launches = build.LAUNCHES["gather_probe_l2"]
    check(set(build.LAUNCHES) == {"gather_probe", "gather_probe_sweep", "gather_probe_l2"}
          and min(gather_launches, sweep_launches, l2_launches) >= 1,
          f"the gather probe launched {dict(build.LAUNCHES)}")
    for n_rows, ok in checks.items():
        check(ok, f"gather rows={n_rows}: WRONG")
        log(f"[11] gather rows={n_rows}: OK exact [{card}]")
    for n_rows, r in chains.items():
        log(f"[11] gather rows={n_rows}: {r['us_per_op']:.4f} us/op ({r['ns_per_row']:.4f} "
            f"ns/row), table in {r['memory']}; from L2 {r['l2_us_per_op']:.4f} us/op [{card}]")
    for p, r in sweeps.items():
        check(r["equal"], f"select sweep P={p} != the gather on its tile")
        log(f"[11] select-sweep P={p} ({gp.SWEEP_TILE_ROWS}-row tile): "
            f"{r['sweep_us_per_op']:.4f} us/op; gather on the same tile: "
            f"{r['gather_us_per_op']:.4f} us/op, sweep / gather "
            f"{r['sweep_us_per_op'] / r['gather_us_per_op']:.1f}x, outputs equal, the sweep's "
            f"table in {r['sweep_memory']}, the gather's in {r['memory']} [{card}]")
    # The row's times: the gather alone on the 4096 x 128 table, each call in
    # a CUDA graph of 100 (a launch is shorter than its enqueue), beside the
    # floor: an empty kernel and a coalesced copy of the gather's own idx
    # and out bytes (4 MB) in the same graph, and beside the L2 line.
    from dither_pie_tpu_torch.tools.time_ed_path import graph_ms

    tbl, idx = (on_card(a) for a in gp.gather_inputs(T1_ROWS))
    idx64 = idx.long()
    copy_out = torch.empty_like(idx)
    ext = build.extension()
    t1_ms = graph_ms(lambda: gp.gather_chain(tbl, idx))
    t1_lib_ms = graph_ms(lambda: torch.gather(tbl, 0, idx64))
    l2_ms = graph_ms(lambda: gp.gather_chain_l2(tbl, idx))
    empty_ms = graph_ms(lambda: ext.empty_kernel(idx))
    copy_ms = graph_ms(lambda: copy_out.copy_(idx))
    enq_ms, got = cuda_ms(torch, lambda: gp.gather_chain(tbl, idx), 7)
    t1_plain_ms, want = cuda_ms(torch, lambda: gp.gather_chain_plain(tbl, idx), 7)
    hold(torch, "gather_probe", got, want, errs, "the timed gather")
    check(torch.equal(got, torch.gather(tbl, 0, idx64)), "the timed gather != torch.gather")
    check(torch.equal(copy_out, idx), "the floor's copy != idx")
    t1_bound = bound(3 * tbl.numel() * 4, 0)
    t1_bound["library_ms"] = t1_lib_ms
    plan = gp.gather_slab_plan(T1_ROWS, T1_ROWS, gp.LF)
    log(f"[11] gather alone, rows={T1_ROWS} x {gp.LF} int32 ({plan.form}, C={plan.cluster}), "
        f"ms a launch in a CUDA graph of 100: kernel {t1_ms:.5f}, torch.gather on int64 "
        f"indices {t1_lib_ms:.5f}, the L2 line {l2_ms:.5f}; the floor: an empty kernel "
        f"{empty_ms:.5f}, the 4 MB copy "
        f"idx -> out {copy_ms:.5f}; kernel - copy {t1_ms - copy_ms:.5f} ms; enqueued one call "
        f"at a time (CUDA events) {enq_ms:.5f}; plain PyTorch {t1_plain_ms:.4f}; bound "
        f"{t1_bound['bound_ms']:.5f} ms by bytes [{card}]")

    return {"name": "gather_probe", "route": "cuda", "source": PROBE_KERNELS[0][1],
             "replaces": PROBE_KERNELS[0][2], "launches": gather_launches,
             "sweep_launches": sweep_launches, "l2_launches": l2_launches,
             "l2_ms": l2_ms, "max_abs_err": errs["gather_probe"],
             "ms": t1_ms, "plain_ms": t1_plain_ms, "enqueued_ms": enq_ms,
             "empty_kernel_ms": empty_ms, "copy_ms": copy_ms, "form": plan.form,
             "cluster": plan.cluster, "chain": chains, "sweep": sweeps, **t1_bound}


def identity_phase(torch, dev, card, frames16, errs):
    """Phase 11's T3: the identity kernel == its input == clone() at odd
    sizes, views off the boundary, pairs of views into offset outputs (the
    bulk form and the shifted one), the timed 100 x 1080p plane in each
    form beside clone(), and the layout harness and its chain through K4.
    Returns the kernels-line row of the identity."""
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.tools import layout_repro as lr

    def on_card(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    t0 = time.perf_counter()
    two = on_card(np.random.RandomState(12).randint(
        0, 256, (3, 2 * FULL_H, FULL_W)).astype(np.uint8))
    hold(torch, "identity", lr.identity_copy(two), two, errs, f"(3, {2 * FULL_H}, {FULL_W})")
    flat_two = two.view(-1)
    for what, x in (("an odd size", flat_two[:1_000_003]),
                    ("a view off the 16-byte boundary", flat_two[1:1_000_020]),
                    ("15 bytes", flat_two[:15])):
        got = lr.identity_copy(x)
        check(got.data_ptr() != x.data_ptr(), f"identity returned its input ({what})")
        hold(torch, "identity", got, x, errs, what)
        hold(torch, "identity", got, lr.identity_plain(x), errs, f"{what}, against clone()")
    # Pairs of views into outputs at chosen offsets: agreeing mod 16 off the
    # boundary (a head, the bulk body, a tail) and disagreeing (the shifted
    # form), the bytes around each output untouched.
    t3_pairs = 0
    for n in (1_000_003, 4_000_037, 47, 15):
        for in_off, out_off in ((5, 5), (13, 13), (1, 0), (0, 7), (3, 14), (15, 2)):
            x = flat_two[in_off:in_off + n]
            buf = torch.full((n + 64,), 0xA5, dtype=torch.uint8, device=dev)
            got = lr.identity_copy(x, out=buf[16 + out_off:16 + out_off + n])
            hold(torch, "identity", got, lr.identity_plain(x), errs,
                 f"{n} bytes at {in_off} into {out_off} mod 16")
            check(bool((buf[:16 + out_off] == 0xA5).all()) and
                  bool((buf[16 + out_off + n:] == 0xA5).all()),
                  f"identity wrote outside its output ({n} bytes, {in_off}, {out_off})")
            t3_pairs += 1
    plane = lr.planarize(torch.cat(
        [on_card(frames16).roll(37 * k, dims=2)
         for k in range(-(-BIG_BATCH // BATCH))])[:BIG_BATCH])
    t3_ms, got = cuda_ms(torch, lambda: lr.identity_copy(plane), 7)
    t3_plain_ms, want = cuda_ms(torch, lambda: lr.identity_plain(plane), 7)
    hold(torch, "identity", got, want, errs, f"the timed {BIG_BATCH}x{FULL_H}x{FULL_W} plane")
    hold(torch, "identity", got, plane, errs, "the timed plane against its input")
    # The shifted form on the plane less its first byte (a view 1 byte off
    # the boundary into a fresh output).
    off_by_one = plane.view(-1)[1:]
    shifted_ms, got = cuda_ms(torch, lambda: lr.identity_copy(off_by_one), 7)
    hold(torch, "identity", got, off_by_one, errs, "the timed plane 1 byte off, shifted form")
    t3_bound = bound(2 * plane.numel(), 0)
    t3_bound["library_ms"] = t3_plain_ms
    gbs = 2 * plane.numel() / t3_ms / 1e6
    log(f"[11] identity == input == clone(), bitwise: (3, {2 * FULL_H}, {FULL_W}), an odd "
        f"size, a view off the 16-byte boundary, 15 bytes, {t3_pairs} pairs of views into "
        f"offset outputs (agreeing and disagreeing mod 16); one "
        f"{BIG_BATCH}x{FULL_H}x{FULL_W} plane ({plane.numel() / 1e6:.1f} MB): kernel "
        f"(bulk) {t3_ms:.3f} ms = {gbs:.1f} GB/s read + written "
        f"({gbs / (PEAK_BYTES_PER_S / 1e9):.3f} of {PEAK_BYTES_PER_S / 1e12:.2f} TB/s), "
        f"shifted (1 byte off) {shifted_ms:.3f} ms, clone() "
        f"{t3_plain_ms:.3f} ms = {2 * plane.numel() / t3_plain_ms / 1e6:.1f} GB/s, bound "
        f"{t3_bound['bound_ms']:.3f} ms ({time.perf_counter() - t0:.1f} s) [{card}]")
    del plane, got, want, two, flat_two, off_by_one
    build.reset_launch_counts()
    r = lr.harness(3, BIG_BATCH, dev, FULL_H, FULL_W)
    identity_launches = build.LAUNCHES["identity"]
    check(dict(build.LAUNCHES) == {"identity": 3},
          f"the layout harness launched {dict(build.LAUNCHES)}")
    for i, out in enumerate(r["outs"]):
        check(tuple(out.shape) == (3, BIG_BATCH * FULL_H, FULL_W) and bool((out == i).all()),
              f"the layout harness' plane {i} is not its input")
    log(f"[11] layout harness: params=3 batch={BIG_BATCH} args={r['arg_bytes'] / 1e9:.2f} GB "
        f"[identity operands]; temp allocation: {r['temp_bytes'] / 1e9:.2f} GB "
        f"({r['temp_bytes'] / r['arg_bytes']:.2f}x of args); output: "
        f"{r['out_bytes'] / 1e9:.2f} GB ({r['out_bytes'] / r['arg_bytes']:.1f}x); executed "
        f"ok, 3 planes of {tuple(r['outs'][0].shape)} [{card}]")
    del r
    build.reset_launch_counts()
    r = lr.chain(3, BATCH, dev, FULL_H, FULL_W)
    check(dict(build.LAUNCHES) == {"ordered_fused": 3},
          f"the layout chain launched {dict(build.LAUNCHES)}")
    check(np.isfinite(r["acc"]) and r["acc"] > 0, f"the layout chain's sum is {r['acc']}")
    log(f"[11] layout chain: params=3 batch={BATCH} args={r['arg_bytes'] / 1e9:.2f} GB; temp "
        f"allocation: {r['temp_bytes'] / 1e9:.2f} GB ({r['temp_bytes'] / r['arg_bytes']:.2f}x "
        f"of args); executed ok: {r['acc']} [{card}]")

    return {"name": "identity", "route": "cuda", "source": PROBE_KERNELS[1][1],
            "replaces": PROBE_KERNELS[1][2], "launches": identity_launches,
            "max_abs_err": errs["identity"], "ms": t3_ms, "plain_ms": t3_plain_ms,
            "gb_per_s": gbs, "shifted_ms": shifted_ms, **t3_bound}


# ---------------------------------------------------------------------------
# Phase 13: K1 and K3, the tile transposes, at the odd shapes
# ---------------------------------------------------------------------------

TILE_HS = (1, 7, 8, 33, 64, 65)  # the shapes of tests/test_torch_skew_tiles.py
TILE_WS = (1, 2, 3, 5, 21, 64, 65)
TILE_BS = (1, 3, 17)


def tile_phase(torch, dev, card, errs):
    """Phase 13: K1 (``skew_gather``, u8 and float32) against ``skew_plain``
    and K7's stream, K7's u8 -> f32 form against K1's stream cast, and K3
    (``unskew_unpack``, NHWC and planar) against ``unskew_unpack_plain``,
    all bitwise, at the CPU test's odd shapes: on whole tensors, on
    contiguous slices whose base lies off the 16-byte boundary, and on a K1
    output (all three type pairs) that starts off a sector boundary (the
    binding called with an offset output and its plan). Returns the number
    of comparisons."""
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.ops import wavefront as twf

    t0 = time.perf_counter()
    rng = np.random.RandomState(13)
    count = 0

    def skew_at(frames, s, out_offset, out_dtype=None):
        """K1 (K7's u8 -> f32 form with ``out_dtype``) through the binding
        into an output ``out_offset`` bytes into a fresh buffer (the
        wrappers always allocate a fresh one)."""
        b, h, w, _ = frames.shape
        shape = (twf.stream_length(h, w, s), 3 * b, h)
        out_dtype = frames.dtype if out_dtype is None else out_dtype
        e = out_dtype.itemsize
        buf = torch.empty(int(np.prod(shape)) * e + out_offset, dtype=torch.uint8, device=dev)
        out = buf[out_offset:].view(out_dtype).view(shape)
        plan = twf.skew_tile_plan(b, h, w, s, out_dtype, out.data_ptr() % twf.SECTOR_BYTES)
        build.extension().skew(frames, out, s, plan.td, plan.ty, plan.lead, plan.threads,
                               list(plan.grid), plan.smem_bytes)
        return out

    for s in (2, 3):
        for b in TILE_BS:
            for h in TILE_HS:
                for w in TILE_WS:
                    what = f"B={b} {h}x{w} s={s}"
                    # One spare frame: [1:] is a contiguous slice whose base
                    # lies h*w*3 bytes in, off the 16-byte boundary unless
                    # that is a multiple of 16.
                    u8 = torch.from_numpy(
                        rng.randint(0, 256, (b + 1, h, w, 3)).astype(np.uint8)).to(dev)
                    f32 = torch.from_numpy(
                        rng.uniform(-8.0, 263.0, (b + 1, h, w, 3)).astype(np.float32)).to(dev)
                    for frames, name in ((u8[:b], "u8"), (u8[1:], "u8 slice"),
                                         (f32[:b], "f32"), (f32[1:], "f32 slice")):
                        got = twf.skew_gather(frames, s)
                        hold(torch, "skew", got, twf.skew_plain(frames, s), errs,
                             f"{what} {name}")
                        if frames.dtype == torch.uint8:
                            hold(torch, "skew_transpose",
                                 twf.skew_transpose(frames, s, torch.float32),
                                 got.to(torch.float32), errs,
                                 f"K7 u8 -> f32 against K1's stream cast, {what} {name}")
                        else:
                            hold(torch, "skew", got, twf.skew_transpose(frames, s), errs,
                                 f"against K7's stream, {what} {name}")
                        count += 2
                    for frames, off, out_dtype in ((u8[1:], 13, None), (f32[1:], 12, None),
                                                   (u8[1:], 12, torch.float32)):
                        got = skew_at(frames, s, off, out_dtype)
                        hold(torch, "skew_transpose" if out_dtype else "skew", got,
                             twf.skew_plain(frames, s).to(got.dtype), errs,
                             f"{what} {frames.dtype} -> {got.dtype}, output {off} bytes off "
                             f"a sector")
                        count += 1
                    d = twf.stream_length(h, w, s)
                    buf = torch.from_numpy(
                        rng.randint(0, 1 << 24, d * b * h + 1).astype(np.int32)).to(dev)
                    for col, name in ((buf[:-1].view(d, b, h), "whole"),
                                      (buf[1:].view(d, b, h), "slice")):
                        for planar in (False, True):
                            hold(torch, "unskew_unpack",
                                 twf.unskew_unpack(col, s, h, w, planar),
                                 twf.unskew_unpack_plain(col, s, h, w, planar), errs,
                                 f"{what} {name} planar={planar}")
                            count += 1
    # Off the boundary at the main path's width: 1919-wide frames (a frame
    # of 6217560 bytes, 8 past a 16-byte boundary) and a stream 4 bytes in.
    fr = torch.from_numpy(rng.randint(0, 256, (3, FULL_H, FULL_W - 1, 3)).astype(np.uint8)).to(dev)
    for s in (2, 3):
        got = twf.skew_gather(fr[1:], s)
        hold(torch, "skew", got, twf.skew_plain(fr[1:], s), errs,
             f"2x{FULL_H}x{FULL_W - 1} slice s={s}")
        hold(torch, "skew_transpose", twf.skew_transpose(fr[1:], s, torch.float32),
             got.to(torch.float32), errs,
             f"K7 u8 -> f32 against K1's stream cast, 2x{FULL_H}x{FULL_W - 1} slice s={s}")
        d = twf.stream_length(FULL_H, FULL_W - 1, s)
        col = torch.from_numpy(rng.randint(0, 1 << 24, d * 2 * FULL_H + 1).astype(
            np.int32)).to(dev)[1:].view(d, 2, FULL_H)
        for planar in (False, True):
            hold(torch, "unskew_unpack", twf.unskew_unpack(col, s, FULL_H, FULL_W - 1, planar),
                 twf.unskew_unpack_plain(col, s, FULL_H, FULL_W - 1, planar), errs,
                 f"2x{FULL_H}x{FULL_W - 1} slice s={s} planar={planar}")
        count += 4
    log(f"[13] kernel == plain, bitwise: K1 skew (u8, float32; == K7's stream too), K7's u8 "
        f"-> f32 form and K3 unskew_unpack (NHWC, planar) at B in {TILE_BS}, H in {TILE_HS}, "
        f"W in {TILE_WS}, s = 2 and 3, whole and as slices off the 16-byte boundary, K1 into "
        f"outputs 13 and 12 bytes off a sector (u8 -> f32 12), and 2x{FULL_H}x{FULL_W - 1} "
        f"slices: {count} comparisons "
        f"({time.perf_counter() - t0:.1f} s); the 16x{FULL_H}x{FULL_W} batch's are phase 6's, "
        f"9's and 10's")
    return count


# ---------------------------------------------------------------------------
# Phase 14: K6 as K1's one-channel tile transpose, K4's two bodies
# ---------------------------------------------------------------------------

PLANE_COUNTS = (1, 3, 5, 48)
PLANE_HWS = ((1, 1), (7, 5), (37, 53), (65, 21), (130, 300))
ORDERED_PALETTES = (1, 2, 16, 33, 256, 300, 4096)
ORDERED_SHAPES = ((3, 37, 53), (1, 7, 5), (2, 5, 130))


def ported_phase(torch, dev, card, frames16, palette, out16, errs):
    """Phase 14: the redesigned K6 (``skew_planar_gather``, u8 and float32)
    against ``skew_planar_plain`` and K1's / K7's streams, K7's u8 -> f32
    form on planes against K6's stream cast, and the
    redesigned K4 (``ordered_dither_fused``: u8 frames through the integer
    body and, with a palette that fails its vote, the float body; float32
    frames) against ``ordered_dither_fused_plain``, colours and indices, all
    bitwise: at odd shapes, R planes in PLANE_COUNTS, P colours in
    ORDERED_PALETTES, on flat frames of exact ties and palettes with
    planted duplicates, on slices whose base lies off the 16-byte boundary,
    K6 into outputs off a sector boundary, and at 16 x 1080p; then the
    planar main path against the NHWC main path's output. Returns the
    number of comparisons."""
    import dither_pie_tpu_torch as dpt
    from dither_pie_tpu_torch.core import thresholds as thr
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.ops import ordered as tord
    from dither_pie_tpu_torch.ops import ordered_fused as tof
    from dither_pie_tpu_torch.ops import wavefront as twf

    t0 = time.perf_counter()
    rng = np.random.RandomState(14)
    count = 0

    def on_card(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def k6_at(planes, s, out_offset, out_dtype=None):
        """K6 (K7's u8 -> f32 form with ``out_dtype``) through the binding
        into an output ``out_offset`` bytes into a fresh buffer."""
        r, h, w = planes.shape
        shape = (twf.stream_length(h, w, s), r, h)
        out_dtype = planes.dtype if out_dtype is None else out_dtype
        buf = torch.empty(int(np.prod(shape)) * out_dtype.itemsize + out_offset,
                          dtype=torch.uint8, device=dev)
        out = buf[out_offset:].view(out_dtype).view(shape)
        plan = twf.skew_tile_plan(r, h, w, s, out_dtype,
                                  out.data_ptr() % twf.SECTOR_BYTES, 1)
        build.extension().skew(planes, out, s, plan.td, plan.ty, plan.lead, plan.threads,
                               list(plan.grid), plan.smem_bytes)
        return out

    # --- K6 at the odd shapes ---------------------------------------------
    for s in (2, 3):
        for r in PLANE_COUNTS:
            for h, w in PLANE_HWS:
                what = f"R={r} {h}x{w} s={s}"
                # One spare plane: [1:] starts h*w elements in.
                u8 = on_card(rng.randint(0, 256, (r + 1, h, w)).astype(np.uint8))
                f32 = on_card(rng.uniform(-8.0, 263.0, (r + 1, h, w)).astype(np.float32))
                for planes, name in ((u8[:r], "u8"), (u8[1:], "u8 slice"),
                                     (f32[:r], "f32"), (f32[1:], "f32 slice")):
                    got = twf.skew_planar_gather(planes, s)
                    hold(torch, "skew_planar", got, twf.skew_planar_plain(planes, s), errs,
                         f"{what} {name}")
                    if planes.dtype == torch.uint8:
                        hold(torch, "skew_transpose",
                             twf.skew_transpose(planes, s, torch.float32),
                             got.to(torch.float32), errs,
                             f"K7 u8 -> f32 against K6's stream cast, {what} {name}")
                    else:
                        hold(torch, "skew_planar", got, twf.skew_transpose(planes, s), errs,
                             f"against K7's stream, {what} {name}")
                    count += 2
                for planes, off, out_dtype in ((u8[1:], 13, None), (f32[1:], 12, None),
                                               (u8[1:], 12, torch.float32)):
                    got = k6_at(planes, s, off, out_dtype)
                    hold(torch, "skew_transpose" if out_dtype else "skew_planar", got,
                         twf.skew_planar_plain(planes, s).to(got.dtype), errs,
                         f"{what} {planes.dtype} -> {got.dtype}, output {off} bytes off a "
                         f"sector")
                    count += 1
                if r % 3 == 0:  # the planes of r/3 frames give K1's stream
                    frames = on_card(rng.randint(0, 256, (r // 3, h, w, 3)).astype(np.uint8))
                    planes = frames.permute(3, 0, 1, 2).contiguous().view(r, h, w)
                    hold(torch, "skew_planar", twf.skew_planar_gather(planes, s),
                         twf.skew_gather(frames, s), errs, f"against K1's stream, {what}")
                    count += 1
    def off_boundary(t, offset):
        """A copy of ``t`` whose base lies ``offset`` bytes past a 16-byte
        boundary (the 1080p frames and planes are multiples of 16 bytes, so
        their own slices are not)."""
        buf = torch.empty(t.numel() * t.element_size() + offset, dtype=torch.uint8, device=dev)
        out = buf[offset:].view(t.dtype).view(t.shape)
        out.copy_(t)
        return out

    # At the planar main path's shape: the 48 planes of the 16 frames, and
    # the same planes 5 bytes off the boundary.
    batch_t = on_card(frames16)
    planes16 = batch_t.permute(3, 0, 1, 2).contiguous().view(3 * BATCH, FULL_H, FULL_W)
    for s in (2, 3):
        got = twf.skew_planar_gather(planes16 if s == 2 else off_boundary(planes16, 5), s)
        hold(torch, "skew_planar", got, twf.skew_planar_plain(planes16, s), errs,
             f"{3 * BATCH}x{FULL_H}x{FULL_W} u8 s={s}")
        hold(torch, "skew_planar", got, twf.skew_gather(batch_t, s), errs,
             f"against K1's stream, {3 * BATCH}x{FULL_H}x{FULL_W} u8 s={s}")
        count += 2
    del got
    planes16_f32 = planes16.to(torch.float32)
    got = twf.skew_planar_gather(planes16_f32, 2)
    hold(torch, "skew_planar", got, twf.skew_planar_plain(planes16_f32, 2), errs,
         f"{3 * BATCH}x{FULL_H}x{FULL_W} float32")
    hold(torch, "skew_planar", got, twf.skew_transpose(planes16_f32, 2), errs,
         f"against K7's stream, {3 * BATCH}x{FULL_H}x{FULL_W} float32")
    count += 2
    del got, planes16_f32
    k6_count = count
    log(f"[14] K6 skew_planar == plain and == K7's (and K1's) stream, and K7's u8 -> f32 "
        f"form on planes, bitwise: R in "
        f"{PLANE_COUNTS}, (H, W) in {PLANE_HWS}, s = 2 and 3, u8 and float32, whole and as "
        f"slices off the 16-byte boundary, outputs 13 and 12 bytes off a sector, and "
        f"{3 * BATCH}x{FULL_H}x{FULL_W} planes (u8 also 5 bytes off the boundary, and "
        f"float32): {k6_count} comparisons "
        f"({time.perf_counter() - t0:.1f} s)")

    # --- K4: both bodies at the odd shapes --------------------------------
    t1 = time.perf_counter()

    def hold_k4(frames, pal, screen, what, indices=(False, True)):
        nonlocal count
        for ind in indices:
            if ind and pal.shape[0] > tof.INDEX_PALETTE_MAX:
                continue
            hold(torch, "ordered_fused", tof.ordered_dither_fused(frames, pal, screen, ind),
                 tof.ordered_dither_fused_plain(frames, pal, screen, ind), errs,
                 f"{what}, indices={ind}")
            count += 1

    for p in ORDERED_PALETTES:
        pal_int = rng.randint(0, 256, (p, 3)).astype(np.float32)
        pal_frac = pal_int.copy()
        pal_frac[p // 2, 1] += 0.5  # one value off the integers: the float body
        for b, h, w in ORDERED_SHAPES:
            u8 = on_card(rng.randint(0, 256, (b + 1, h, w, 3)).astype(np.uint8))
            f32 = on_card(rng.uniform(-8.0, 263.0, (b + 1, h, w, 3)).astype(np.float32))
            screen = on_card(rng.rand(h, w).astype(np.float32))
            for pal_np, body in ((pal_int, "integer"), (pal_frac, "float")):
                pal = on_card(pal_np)
                for frames, name in ((u8[:b], "u8"), (u8[1:], "u8 slice")):
                    hold_k4(frames, pal, screen, f"P={p} B={b} {h}x{w} {name}, {body} body")
            for frames, name in ((f32[:b], "float32"), (f32[1:], "float32 slice")):
                hold_k4(frames, on_card(pal_int), screen, f"P={p} B={b} {h}x{w} {name}")
    # Exact ties: flat frames midway between two colours, on a duplicated
    # colour (d1 + d2 == 0), on one colour, and frames drawn from a palette
    # with planted duplicates; flat screens 0, 0.5 and 1.
    b, h, w = SMALL
    ties = [((101, 100, 100), [[100, 100, 100], [102, 100, 100], [0, 0, 0]]),
            ((40, 50, 60), [[0, 0, 0], [40, 50, 60], [40, 50, 60]]),
            ((7, 7, 7), [[7, 7, 7]]),
            ((10, 10, 10), [[12, 10, 10], [8, 10, 10], [10, 12, 10], [10, 8, 10]])]
    dup = rng.randint(0, 256, (40, 3)).astype(np.float32)
    dup[[5, 17, 33]] = dup[2]
    dup[[30, 39]] = dup[29]
    drawn = on_card(dup[rng.randint(0, 40, (b + 1, h, w))].astype(np.uint8))
    for level in (0.0, 0.5, 1.0):
        flat_screen = torch.full((h, w), level, dtype=torch.float32, device=dev)
        for colour, rows in ties:
            flat = torch.tensor(colour, dtype=torch.uint8, device=dev).expand(
                b, h, w, 3).contiguous()
            pal = torch.tensor(rows, dtype=torch.float32, device=dev)
            hold_k4(flat, pal, flat_screen, f"exact ties {colour} screen {level}")
            hold_k4(flat.to(torch.float32), pal, flat_screen,
                    f"exact ties {colour} float32 screen {level}")
        hold_k4(drawn[1:], on_card(dup), flat_screen, f"planted duplicates, screen {level}")
    # 16 x 1080p: pico8 through the integer body (Bayer 8x8, blue noise),
    # pico8 shifted by 0.25 through the float body, float32 frames.
    pico8 = on_card(np.asarray(pico8_palette(), np.float32))
    bayer = tord.screen_for_matrix(thr.bayer_matrix("8x8"), FULL_H, FULL_W, dev)
    blue = tord.screen_for_matrix(thr.blue_noise_cached(64, 42), FULL_H, FULL_W, dev)
    pal32 = on_card(np.asarray(palette, np.float32))
    noisy = batch_t.to(torch.float32) + on_card(
        rng.uniform(-0.5, 0.5, frames16.shape).astype(np.float32))
    full = f"{BATCH}x{FULL_H}x{FULL_W}"
    hold_k4(batch_t, pico8, bayer, f"{full} pico8 Bayer 8x8, integer body")
    hold_k4(off_boundary(batch_t, 3), pico8, blue,
            f"{full} 3 bytes off the boundary, pico8 blue noise")
    hold_k4(batch_t, pico8 + 0.25, bayer, f"{full} pico8 + 0.25 Bayer 8x8, float body",
            (False,))
    hold_k4(noisy, pal32, bayer, f"{full} float32 k-means-32 Bayer 8x8")
    del noisy
    log(f"[14] K4 ordered_fused == plain, bitwise: P in {ORDERED_PALETTES} at (B, H, W) in "
        f"{ORDERED_SHAPES}, u8 through the integer body and (one value + 0.5) the float body, "
        f"float32 frames, whole and as slices off the 16-byte boundary, colours and indices "
        f"(P <= 256); exact ties and planted duplicates at screens 0, 0.5, 1; {full} pico8 "
        f"(integer and float bodies) and float32 k-means-32: {count - k6_count} comparisons "
        f"({time.perf_counter() - t1:.1f} s)")

    # --- The planar main path against the NHWC main path's output --------
    ditherer = dpt.ImageDitherer(
        num_colors=N_COLORS, dither_mode=dpt.DitherMode.ERROR_DIFFUSION,
        palette=palette, dither_params={"variant": "floyd_steinberg"}, device=dev)
    planar_np = np.ascontiguousarray(np.moveaxis(frames16, -1, 0))
    build.reset_launch_counts()
    out_planar = ditherer.apply_dithering_batch(planar_np, planar=True)
    sync(torch, dev)
    launches = dict(build.LAUNCHES)
    check(launches.get("skew_planar", 0) >= 1 and "skew" not in launches,
          f"the planar main path launched {launches}")
    check(np.array_equal(np.moveaxis(out_planar, 0, -1), out16),
          "the planar main path's output != the NHWC main path's")
    count += 1
    log(f"[14] planar main path (FS k-means-32, {planar_np.shape} u8): launches {launches}; "
        f"== the NHWC main path's output transposed, bitwise")
    log(f"[14] phase 14: {count} comparisons in {time.perf_counter() - t0:.1f} s [{card}]")
    return count


# ---------------------------------------------------------------------------
# Phase 15: K5 as the index kinds of K3's tile transpose
# ---------------------------------------------------------------------------


def index_tile_phase(torch, dev, card, frames16, errs):
    """Phase 15: K5 (``unskew_idx``: the "u8" and "u16" kinds of
    ``unskew_unpack.cu``'s tile kernel, ``unskew_tile_plan``) against
    ``unskew_idx_plain``, bitwise, at the CPU tests' odd shapes (whole
    streams, slices of them whose base lies off the 16-byte boundary, and
    outputs that start off a 16-byte boundary through the binding), on 2 x
    1080 x 1919 slices, and on the index scan's uint16 streams of 16 x 1080p
    at 300 and 1024 colours. Returns the number of comparisons."""
    from dither_pie_tpu_torch.ops import wavefront as twf

    t0 = time.perf_counter()
    rng = np.random.RandomState(15)
    count = 0
    kinds = ((torch.uint8, "u8", 256, 13), (torch.uint16, "u16", 1 << 16, 6))

    def idx_at(idx, s, h, w, dtype, kind, out_offset):
        """K5 through the binding into an output ``out_offset`` bytes into a
        fresh buffer (the wrapper always allocates a fresh one)."""
        n = idx.shape[1] * h * w * dtype.itemsize
        buf = torch.empty(n + out_offset, dtype=torch.uint8, device=dev)
        out = buf[out_offset:].view(dtype).view(idx.shape[1], h, w)
        twf.launch_unskew(idx, out, s, kind)
        return out

    def hold_kind(idx, s, h, w, dtype, kind, off, what):
        """The wrapper and the binding into an offset output == plain."""
        nonlocal count
        want = twf.unskew_idx_plain(idx, s, h, w, dtype)
        hold(torch, "unskew_idx", twf.unskew_idx(idx, s, h, w, dtype), want, errs,
             f"{what} {kind}")
        hold(torch, "unskew_idx", idx_at(idx, s, h, w, dtype, kind, off), want, errs,
             f"{what} {kind}, output {off} bytes off the boundary")
        count += 2

    # Each kind on indices its type holds: below 256 (u8), below 65536 (u16).
    for s in (2, 3):
        for b in TILE_BS:
            for h in TILE_HS:
                for w in TILE_WS:
                    d = twf.stream_length(h, w, s)
                    for dtype, kind, top, off in kinds:
                        buf = torch.from_numpy(
                            rng.randint(0, top, d * b * h + 1).astype(np.int32)).to(dev)
                        for col, name in ((buf[:-1].view(d, b, h), "whole"),
                                          (buf[1:].view(d, b, h), "slice")):
                            hold_kind(col, s, h, w, dtype, kind, off,
                                      f"B={b} {h}x{w} s={s} {name}")
        d = twf.stream_length(FULL_H, FULL_W - 1, s)
        for dtype, kind, top, off in kinds:
            col = torch.from_numpy(rng.randint(0, top, d * 2 * FULL_H + 1).astype(
                np.int32)).to(dev)[1:].view(d, 2, FULL_H)
            hold_kind(col, s, FULL_H, FULL_W - 1, dtype, kind, off,
                      f"2x{FULL_H}x{FULL_W - 1} slice s={s}")
    # The uint16 streams the index path makes: the index scan's own indices.
    fs = twf.scan_geometry("floyd_steinberg")
    stream = twf.skew(torch.from_numpy(frames16).to(dev), fs.s)
    for p in (300, 1024):
        idx = twf.scan_idx(stream, torch.from_numpy(unique_palette(rng, p)).to(dev), fs, FULL_W)
        got = twf.unskew_idx(idx, fs.s, FULL_H, FULL_W, twf.index_dtype(p))
        check(got.dtype == torch.uint16, f"the index stream at P={p} is {got.dtype}")
        hold(torch, "unskew_idx", got,
             twf.unskew_idx_plain(idx, fs.s, FULL_H, FULL_W, torch.uint16), errs,
             f"the index scan's stream, {BATCH}x{FULL_H}x{FULL_W} P={p}")
        count += 1
        del idx, got
    log(f"[15] K5 (unskew_idx, the u8 and u16 kinds of K3's tile kernel) == plain, bitwise, "
        f"at B in {TILE_BS}, H in {TILE_HS}, W in {TILE_WS}, s = 2 and 3, whole and as "
        f"slices off the 16-byte boundary, into fresh outputs and outputs 13 (u8) and 6 (u16) "
        f"bytes off the boundary, on 2x{FULL_H}x{FULL_W - 1} slices, and on the index scan's "
        f"uint16 streams of {BATCH}x{FULL_H}x{FULL_W} at P = 300 and 1024: {count} "
        f"comparisons ({time.perf_counter() - t0:.1f} s) [{card}]")
    return count


# ---------------------------------------------------------------------------
# Phase 16: the host engine (serpentine scans and Riemersma)
# ---------------------------------------------------------------------------

HOST_MODES = [  # (label, mode, parameters)
    ("FS serpentine", "error_diffusion", {"variant": "floyd_steinberg", "serpentine": "true"}),
    ("Stucki serpentine", "error_diffusion", {"variant": "stucki", "serpentine": "true"}),
    ("Ostromoukhov serpentine", "ostromoukhov", {"serpentine": "true"}),
    ("Riemersma", "riemersma", {}),
]


def host_golden(lib, frame, pal, mode, params):
    """One frame of a HOST_MODES entry through the golden float32 twin."""
    from dither_pie_tpu_torch.ops.ed_kernels import kernel_arrays

    if mode == "error_diffusion":
        return golden_frame(lib, kernel_arrays, frame, pal, params["variant"], serpentine=True)
    return golden_mode_frame(lib, frame, pal, mode, serpentine=mode == "ostromoukhov")


def golden_frames(fn, frames):
    """fn over the frames on every core (the ctypes calls release the GIL)."""
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        return list(ex.map(fn, frames))


def host_engine_phase(torch, dev, card, lib, frames16, frame0, palette):
    """The port's host engine, built from dither_pie_tpu_torch/native/
    ed_scan.cpp: FS, Stucki and Ostromoukhov serpentine and Riemersma on
    the 16 1080p frames at k-means-32 through apply_dithering_batch, every
    frame == the golden engine's float32 twin; one serpentine 1080p image
    through apply_dithering == the golden engine's float64 ed_fixed. Returns
    {label: fps}."""
    from PIL import Image

    import dither_pie_tpu_torch as dpt
    from dither_pie_tpu_torch.api.ditherer import _native_thread_cap
    from dither_pie_tpu_torch.native import build as native_build
    from dither_pie_tpu_torch.ops.ed_kernels import kernel_arrays

    t0 = time.perf_counter()
    native_build.get_lib()
    log(f"[16] host engine built from "
        f"{native_build.SRC.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s "
        f"(g++ {' '.join(native_build.CFLAGS)})")
    pal_np = np.asarray(palette, np.float32)
    threads = _native_thread_cap()
    fps = {}
    for label, mode, params in HOST_MODES:
        d = dpt.ImageDitherer(num_colors=N_COLORS, dither_mode=dpt.DitherMode(mode),
                              palette=palette, dither_params=params, device=dev)
        walls = []
        for _ in range(2):  # the first call also builds Riemersma's Hilbert path
            t0 = time.perf_counter()
            out = d.apply_dithering_batch(frames16)
            walls.append(time.perf_counter() - t0)
            check(out.shape == frames16.shape and out.dtype == np.uint8,
                  f"{label}: batch output {out.shape} {out.dtype}")
        golds = golden_frames(lambda f: host_golden(lib, f, pal_np, mode, params),
                              list(frames16))
        idents = [identity(o, g) for o, g in zip(out, golds)]
        check(all(v == 1.0 for v in idents), f"{label}: golden identity {idents}")
        fps[label] = BATCH / walls[1]
        log(f"[16] {label} k-means-{N_COLORS}, {BATCH}x{FULL_H}x{FULL_W} through "
            f"apply_dithering_batch: all {BATCH} frames == the golden engine's float32 twin "
            f"bitwise; first call {walls[0] * 1e3:.3f} ms, second {walls[1] * 1e3:.3f} ms "
            f"-> {BATCH / walls[1]:.3f} fps on {threads} threads (os.cpu_count() "
            f"{os.cpu_count()}) [{card}]")
    d = dpt.ImageDitherer(num_colors=N_COLORS, dither_mode=dpt.DitherMode.ERROR_DIFFUSION,
                          palette=palette, dither_params=HOST_MODES[0][2], device=dev)
    t0 = time.perf_counter()
    single = np.asarray(d.apply_dithering(Image.fromarray(frame0)))
    wall = time.perf_counter() - t0
    want = golden_frame(lib, kernel_arrays, frame0, pal_np, "floyd_steinberg",
                        serpentine=True, exact=True)
    check(np.array_equal(single, want),
          f"serpentine apply_dithering != the golden ed_fixed (identity "
          f"{identity(single, want)})")
    log(f"[16] FS serpentine apply_dithering(PIL {FULL_W}x{FULL_H}) == the golden engine's "
        f"float64 ed_fixed bitwise; {wall * 1e3:.3f} ms on one thread [{card}]")
    return fps


# ---------------------------------------------------------------------------
# Phase 17: the streaming video pipeline
# ---------------------------------------------------------------------------

VIDEO_H, VIDEO_W = 720, 1280  # BASELINE.md config 4: 720p video, Stucki
VIDEO_FRAMES = 101  # 6 batches of 16 and a tail of 5
VIDEO_BATCH = 16
VIDEO_TIMED_RUNS = 5


def moving_frames(n, h, w, seed):
    """n synthetic video frames: gradients that move from frame to frame,
    plus noise, from ``seed``."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(n):
        img = np.stack([
            128 + 110 * np.sin(2 * np.pi * (x / w + t / 40 + 0.1 * np.sin(y / 97.0))),
            128 + 90 * np.cos(2 * np.pi * (y / h - t / 60)),
            128 + 100 * np.sin(2 * np.pi * ((x + y) / (h + w) + t / 25)),
        ], axis=-1)
        img += rng.normal(0, 8, img.shape).astype(np.float32)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


class CountingDitherer:
    """Wraps a ditherer's apply_dithering_batch: counts its calls and its
    raises, so a batch that failed and was retried or patched is seen."""

    def __init__(self, d):
        self.calls, self.raises, self.orig = 0, 0, d.apply_dithering_batch
        d.apply_dithering_batch = self
        self.d = d

    def __call__(self, *a, **kw):
        self.calls += 1
        try:
            return self.orig(*a, **kw)
        except Exception:
            self.raises += 1
            raise


def batched_reference(d, frames, planar=False):
    """The frames through the ditherer's own apply_dithering_batch, in the
    pipeline's batches of VIDEO_BATCH (the last one short)."""
    out = []
    for i in range(0, len(frames), VIDEO_BATCH):
        chunk = frames[i:i + VIDEO_BATCH]
        if planar:
            res = d.apply_dithering_batch(np.stack(chunk, axis=1), planar=True)
            out.extend(res[:, j] for j in range(len(chunk)))
        else:
            res = d.apply_dithering_batch(np.stack(chunk))
            out.extend(res)
    return out


def video_leg_a(dev, frames):
    """Leg (a)'s ditherer: Stucki, median-cut 16 from frame 0."""
    from PIL import Image

    import dither_pie_tpu_torch as dpt

    return dpt.ImageDitherer(num_colors=16, dither_mode=dpt.DitherMode.ERROR_DIFFUSION,
                             palette=dpt.ColorReducer.reduce_colors(
                                 Image.fromarray(frames[0]), 16),
                             dither_params={"variant": "stucki"}, device=dev)


def trace_video_leg(torch, dev, card, frames):
    """One overlapped process_frames run of leg (a) under torch.profiler,
    after a warm-up run: the video idle share."""
    from dither_pie_tpu_torch.pipeline.video import process_frames

    d = video_leg_a(dev, frames)

    def leg():
        for _ in process_frames(iter(frames), d, batch_size=VIDEO_BATCH):
            pass

    leg()
    report_trace(torch, "6-video", f"process_frames leg (a), overlap, {len(frames)} frames "
                 f"of {VIDEO_W}x{VIDEO_H}", leg, len(frames) * VIDEO_H * VIDEO_W * 3, card)


def video_phase(torch, dev, card, lib, frames, fps_host):
    """process_frames on synthetic 720p frames: legs (a) Stucki median-cut
    16 from frame 0 (BASELINE.md config 4; 101 frames), (b)
    examples/video_basic.json (regular pixelize to 240, x2 final resize;
    37 frames), (c) Bayer 8x8 pico8, (d) FS serpentine (17 frames), (e) the
    planar FS flow, each with overlap on and off. Holds: every frame ==
    apply_dithering_batch in the same batches; (a) == the golden engine on
    2 frames; planar == interleaved; overlap == serial; no batch raised
    (nothing retried or patched); K1, K2, K3, K4 and K6 launched. Prints
    fps (leg (a)'s traced run and idle share are phase 6's, from
    trace_video_leg), and, where ffmpeg is on PATH, runs leg (a) end to end
    through VideoProcessor on an encoded clip. ``frames``: the 720p frames
    of ``moving_frames``."""
    from PIL import Image

    import dither_pie_tpu_torch as dpt
    from dither_pie_tpu_torch.api import profiling
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.ops.ed_kernels import kernel_arrays
    from dither_pie_tpu_torch.pipeline import ffio
    from dither_pie_tpu_torch.pipeline.pixelize import pixelize_regular
    from dither_pie_tpu_torch.pipeline.video import VideoProcessor, process_frames

    t_phase = time.perf_counter()
    d_a = video_leg_a(dev, frames)
    pal16 = d_a.palette  # median cut from frame 0
    ed = dpt.DitherMode.ERROR_DIFFUSION

    def ditherer(mode, palette, params):
        return dpt.ImageDitherer(num_colors=len(palette), dither_mode=mode, palette=palette,
                                 dither_params=params, device=dev)

    legs = [  # (tag, ditherer, frames, pixelize, final resize, planar)
        ("a", d_a, frames, None, None, False),
        ("b", ditherer(ed, pal16, {"variant": "stucki"}), frames[:37], ("regular", 240), 2,
         False),
        ("c", ditherer(dpt.DitherMode.BAYER, pico8_palette(), {"size": "8x8"}), frames[:37],
         None, None, False),
        ("d", ditherer(ed, pal16, {"variant": "floyd_steinberg", "serpentine": "true"}),
         frames[:17], None, None, False),
        ("e-nhwc", ditherer(ed, pal16, {"variant": "floyd_steinberg"}), frames[:37], None,
         None, False),
        ("e", ditherer(ed, pal16, {"variant": "floyd_steinberg"}),
         [np.ascontiguousarray(f.transpose(2, 0, 1)) for f in frames[:37]], None, None, True),
    ]
    counters = {tag: CountingDitherer(d) for tag, d, *_ in legs}
    outs, walls = {}, {}
    build.reset_launch_counts()
    for tag, d, fr, pix, resize, planar in legs:
        for overlap in (False, True):
            t0 = time.perf_counter()
            outs[tag, overlap] = list(process_frames(
                iter(fr), d, pixelize_func=pix, final_resize_multiplier=resize,
                batch_size=VIDEO_BATCH, overlap=overlap, planar=planar))
            walls[tag, overlap] = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    log(f"[17] video main path launches: {launches}")
    for key in ("skew", "ed_scan", "unskew_unpack", "ordered_fused", "skew_planar"):
        check(launches.get(key, 0) >= 1, f"video path: kernel {key} not launched")
    for tag, d, fr, pix, resize, planar in legs:
        c = counters[tag]
        n_batches = -(-len(fr) // VIDEO_BATCH)
        check(c.raises == 0 and c.calls == 2 * n_batches,
              f"leg ({tag}): {c.raises} raises in {c.calls} calls of apply_dithering_batch "
              f"(want 0 in {2 * n_batches}): frames were retried or patched")
        serial, overlapped = outs[tag, False], outs[tag, True]
        check(len(serial) == len(overlapped) == len(fr),
              f"leg ({tag}): {len(serial)} / {len(overlapped)} frames of {len(fr)}")
        check(all(np.array_equal(a, b) for a, b in zip(serial, overlapped)),
              f"leg ({tag}): overlap != serial")
        src = [np.asarray(pixelize_regular(Image.fromarray(f), pix[1])) for f in fr] if pix \
            else fr
        want = batched_reference(d, src, planar)
        if resize:
            want = [np.repeat(np.repeat(w, resize, axis=0), resize, axis=1) for w in want]
        check(all(np.array_equal(a, b) for a, b in zip(serial, want)),
              f"leg ({tag}): process_frames != apply_dithering_batch in the same batches")
        shape = serial[0].shape
        log(f"[17] ({tag}) {len(fr)} frames -> {shape}: == apply_dithering_batch in batches "
            f"of {VIDEO_BATCH} (tail {len(fr) % VIDEO_BATCH or VIDEO_BATCH}), overlap == "
            f"serial, 0 raises in {c.calls} batch calls; serial {walls[tag, False]:.3f} s "
            f"-> {len(fr) / walls[tag, False]:.3f} fps, overlapped {walls[tag, True]:.3f} s "
            f"-> {len(fr) / walls[tag, True]:.3f} fps [{card}]")
    planar = [np.ascontiguousarray(p.transpose(1, 2, 0)) for p in outs["e", False]]
    check(all(np.array_equal(a, b) for a, b in zip(planar, outs["e-nhwc", False])),
          "leg (e): planar != interleaved")
    pal16_np = np.asarray(pal16, np.float32)
    for i in (0, VIDEO_FRAMES - 1):
        gold = golden_frame(lib, kernel_arrays, frames[i], pal16_np, "stucki")
        check(np.array_equal(outs["a", False][i], gold),
              f"leg (a) frame {i} != the golden engine (identity "
              f"{identity(outs['a', False][i], gold)})")
    log(f"[17] (e) planar == interleaved on all {len(planar)} frames; (a) frames 0 and "
        f"{VIDEO_FRAMES - 1} == the golden engine's ed_fixed_f32 (stucki) bitwise")

    # fps of leg (a), serial against overlapped, in turns.
    timed = {False: [], True: []}
    for overlap in (False, True) * VIDEO_TIMED_RUNS:
        t0 = time.perf_counter()
        for _ in process_frames(iter(frames), d_a, batch_size=VIDEO_BATCH, overlap=overlap):
            pass
        timed[overlap].append(time.perf_counter() - t0)
    fps = {k: VIDEO_FRAMES / statistics.median(v) for k, v in timed.items()}
    log(f"[17] leg (a) {VIDEO_FRAMES}x{VIDEO_W}x{VIDEO_H} Stucki median-cut 16: serial "
        f"{fps[False]:.3f} fps, overlapped {fps[True]:.3f} fps (medians of "
        f"{VIDEO_TIMED_RUNS} runs in turns; serial "
        f"{', '.join(f'{t:.3f}' for t in timed[False])} s, overlapped "
        f"{', '.join(f'{t:.3f}' for t in timed[True])} s) [{card}]")
    log("[17] leg (a)'s traced run, overlapped, and its idle share: phase 6's line "
        "[6-video] (a trace taken late in the run loses its device records)")
    log(profiling.stage_report())

    if ffio.ffmpeg_available():
        work = build.BUILD_DIR / "video"
        work.mkdir(parents=True, exist_ok=True)
        clip, out_path = work / "clip.mp4", work / "clip_dithered.mp4"
        writer = ffio.FrameWriter(str(clip), VIDEO_W, VIDEO_H, 30.0)
        for f in frames:
            writer.write(f)
        check(writer.close(), "ffmpeg failed to encode the synthetic clip")
        d = ditherer(ed, pal16, {"variant": "stucki"})
        progress = []
        t0 = time.perf_counter()
        ok = VideoProcessor(progress_callback=lambda f, m: progress.append(f)) \
            .process_video_streaming(str(clip), str(out_path), d)
        wall = time.perf_counter() - t0
        check(ok, "VideoProcessor.process_video_streaming failed")
        info = ffio.probe_video(str(out_path))
        n_out = sum(1 for _ in ffio.read_frames(str(out_path), info["width"], info["height"]))
        check((info["width"], info["height"], n_out) == (VIDEO_W, VIDEO_H, VIDEO_FRAMES),
              f"encoded output {info['width']}x{info['height']}, {n_out} frames")
        log(f"[17] ffmpeg leg: {VIDEO_FRAMES}-frame clip -> VideoProcessor.process_video_"
            f"streaming (planar flow {d.supports_planar_batch()}) -> {n_out} frames "
            f"{info['width']}x{info['height']} in {wall:.3f} s, decode and encode "
            f"included [{card}]")
    else:
        log("[17] ffmpeg leg did not run: ffmpeg or ffprobe is not on PATH")
    log(f"[17] host engine fps by mode: {fps_host}; video phase took "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return fps


# ---------------------------------------------------------------------------
# Phase 18: the neural pixelizer, BASELINE.md config 5
# ---------------------------------------------------------------------------

NEURAL_FRAMES = 8  # BASELINE.md config 5: 8 x 1080p, neural pixelize to 128, hybrid
NEURAL_MAX_SIZE = 128
NEURAL_SMALL = (2, 64, 96)  # the card-against-CPU check's input
NEURAL_PRECISIONS = ("float32", "tensorfloat32", "bfloat16")


class RecordingDitherer(CountingDitherer):
    """CountingDitherer that also keeps the frames of each call."""

    def __init__(self, d):
        super().__init__(d)
        self.seen = []

    def __call__(self, stacked, *a, **kw):
        self.seen.append(np.array(stacked))
        return super().__call__(stacked, *a, **kw)


@dataclasses.dataclass
class NeuralRun:
    """What neural_setup made for phase 18."""
    model: object
    frames: list
    ditherer: object
    recorder: RecordingDitherer
    palette: list


def neural_frames_run(run, **kw):
    """config 5 through process_frames: the frames in one batch of 8."""
    from dither_pie_tpu_torch.pipeline.video import process_frames

    return list(process_frames(iter(run.frames), run.ditherer,
                               pixelize_func=("neural", NEURAL_MAX_SIZE),
                               batch_size=NEURAL_FRAMES, prefetch=False, **kw))


def neural_input(run):
    """The 8 frames as the batch path prepares them: (8, 512, 912, 3) u8."""
    from PIL import Image

    from dither_pie_tpu_torch.models import inference as inf

    return np.concatenate([inf.process_u8(inf.resize_image_nearest(
        Image.fromarray(f).convert("RGB"), NEURAL_MAX_SIZE * 4)) for f in run.frames])


def neural_setup(torch, dev, card):
    """Config 5 (bench.py's): load_random(0) weights installed as the
    card's neural pixelizer, 8 synthetic 1080p frames, the k-means-32
    palette of the pixelized frame 0, a HYBRID ditherer; then a warm-up
    process_frames run, which runs the first-batch gates (their verdicts
    and seconds are printed), and one traced run: the idle share. Traced
    here, early in the run, as phase 6's traces are."""
    from PIL import Image

    import dither_pie_tpu_torch as dpt
    from dither_pie_tpu_torch.models.inference import PixelizationModel
    from dither_pie_tpu_torch.models.pixelizer import NeuralPixelizer
    from dither_pie_tpu_torch.pipeline.pixelize import install_neural_pixelizer

    for name in ("PRECISION", "U8_IN", "DS4", "DS4_STRIDE"):
        os.environ.pop(f"DITHER_PIE_TPU_NEURAL_{name}", None)
    t0 = time.perf_counter()
    model = PixelizationModel(device=dev)
    model.load_random(0)
    pix = NeuralPixelizer.from_model(model)
    install_neural_pixelizer(pix)
    frames = [synth_image(FULL_H, FULL_W, 500 + i) for i in range(NEURAL_FRAMES)]
    px0 = np.array(pix.pixelize(Image.fromarray(frames[0]), NEURAL_MAX_SIZE).convert("RGB"))
    palette = dpt.ColorReducer.generate_kmeans_palette(Image.fromarray(px0), N_COLORS,
                                                       device=dev)
    d = dpt.ImageDitherer(num_colors=N_COLORS, dither_mode=dpt.DitherMode.HYBRID,
                          palette=palette, device=dev)
    run = NeuralRun(model, frames, d, RecordingDitherer(d), palette)
    sync(torch, dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    neural_frames_run(run)
    sync(torch, dev)
    log(f"[18] config 5 set-up: weights, the reference's style code, frame 0 pixelized "
        f"alone and its k-means-{N_COLORS} palette {setup_s:.3f} s; the first "
        f"process_frames run (the gates run float32 and bfloat16, then the ds4 stride "
        f"candidate) {time.perf_counter() - t0:.3f} s; the gates locked precision "
        f"{model._video_prec!r}, ds4 stride {model._ds4_stride} [{card}]")
    pre = neural_input(run)
    report_trace(torch, "6-neural", f"process_frames config 5 ({NEURAL_FRAMES} x "
                 f"{FULL_W}x{FULL_H}, neural {NEURAL_MAX_SIZE} -> hybrid k-means-{N_COLORS}, "
                 f"the net's input {pre.shape[1]}x{pre.shape[2]})",
                 lambda: neural_frames_run(run), pre.nbytes, card)
    return run


def neural_phase(torch, dev, card, lib, run):
    """Phase 18: BASELINE.md config 5 on the card (``run`` from
    neural_setup). Holds: the main path launches K1, K2 and K3; its output
    == apply_dithering_batch of the same pixelized frames, bitwise, and 2
    frames == the golden engine's hybrid twin; no batch call raised; ds4 on
    == ds4 off bitwise in float32 (fresh gates); the card's float32 forward
    == the port's CPU forward within 1e-4 (u8 within one step) at
    NEURAL_SMALL. Prints fps (best of 2 warm runs) with ds4 on and off, the
    device ms of one batched forward by precision with bf16's and TF32's
    mean |u8 delta| against float32, the stage report and the phase's
    seconds."""
    import copy

    from PIL import Image

    from dither_pie_tpu_torch.api import profiling
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.models import inference as inf

    t_phase = time.perf_counter()
    model, rec = run.model, run.recorder
    calls = rec.calls
    rec.seen.clear()
    build.reset_launch_counts()
    outs = neural_frames_run(run)
    sync(torch, dev)
    launches = dict(build.LAUNCHES)
    log(f"[18] config 5 main path launches: {launches}")
    for key in ("skew", "ed_scan", "unskew_unpack"):
        check(launches.get(key, 0) >= 1, f"config 5: kernel {key} not launched")
    check(rec.raises == 0 and rec.calls == calls + 1,
          f"config 5: {rec.raises} raises in {rec.calls - calls} batch calls (want 0 in 1)")
    px = rec.seen[-1]
    h, w = px.shape[1:3]
    check(len(outs) == NEURAL_FRAMES and all(o.shape == (h, w, 3) and o.dtype == np.uint8
                                             for o in outs),
          f"config 5 output: {len(outs)} frames, {outs[0].shape} {outs[0].dtype}")
    want = rec.orig(px)
    check(all(np.array_equal(o, wf) for o, wf in zip(outs, want)),
          "config 5: process_frames != apply_dithering_batch of the same pixelized frames")
    pal_np = np.asarray(run.palette, np.float32)
    for i in (0, NEURAL_FRAMES - 1):
        gold = golden_mode_frame(lib, px[i], pal_np, "hybrid")
        check(np.array_equal(outs[i], gold),
              f"config 5 frame {i} != the golden engine's hybrid twin (identity "
              f"{identity(outs[i], gold)})")
    log(f"[18] config 5: {NEURAL_FRAMES} frames pixelized to {w}x{h}, == "
        f"apply_dithering_batch of the same pixelized frames on all {NEURAL_FRAMES}, frames "
        f"0 and {NEURAL_FRAMES - 1} == the golden engine's ed_hybrid_f32 bitwise; 0 raises")

    # ds4 on == ds4 off, float32, each with fresh gates.
    imgs = [Image.fromarray(f) for f in run.frames]
    ds4_out, stride_f32 = {}, None
    with env_var("DITHER_PIE_TPU_NEURAL_PRECISION", "float32"):
        for ds4 in ("1", "0"):
            fresh = copy.copy(model)
            fresh._video_prec = fresh._ds4_stride = None
            with env_var("DITHER_PIE_TPU_NEURAL_DS4", ds4):
                ds4_out[ds4] = [np.asarray(o) for o in fresh.pixelize_images_batch(
                    imgs, NEURAL_MAX_SIZE)]
            if ds4 == "1":
                stride_f32 = fresh._ds4_stride
    check(all(np.array_equal(a, b) for a, b in zip(ds4_out["1"], ds4_out["0"])),
          "config 5: ds4 on != ds4 off in float32")
    log(f"[18] ds4 on == ds4 off bitwise on all {NEURAL_FRAMES} frames in float32; the "
        f"float32 ds4 stride gate (strided final conv == the dense slice bitwise?) "
        f"said {stride_f32}")

    # The card's float32 forward against the port's CPU forward.
    cpu_model = inf.PixelizationModel(device="cpu")
    cpu_model.load_random(0)
    x_small = np.random.RandomState(18).uniform(-1, 1, (*NEURAL_SMALL, 3)).astype(np.float32)
    cpu_f = cpu_model.forward_tensor(cpu_model._tensor(x_small), "float32")
    errs = {}
    for prec in ("float32", "tensorfloat32"):
        card_f = model.forward_tensor(model._tensor(x_small), prec).cpu()
        errs[prec] = (card_f - cpu_f).abs().max().item()
    u8_card = model.forward_u8(x_small, precision="float32")
    u8_cpu = cpu_model.forward_u8(x_small, precision="float32")
    u8_err = int(np.abs(u8_card.astype(np.int16) - u8_cpu.astype(np.int16)).max())
    check(errs["float32"] <= 1e-4 and u8_err <= 1,
          f"card float32 forward vs CPU: max abs err {errs['float32']} (limit 1e-4), u8 "
          f"|delta| {u8_err} (limit 1)")
    log(f"[18] card vs the port's CPU forward at {NEURAL_SMALL[0]}x{NEURAL_SMALL[1]}x"
        f"{NEURAL_SMALL[2]}, same weights: float32 max abs err {errs['float32']:.3e} "
        f"(limit 1e-4), u8 max |delta| {u8_err} (limit 1); tensorfloat32 on the card "
        f"{errs['tensorfloat32']:.3e} (not held: what a TF32 leak would look like)")

    # fps, best of 2 warm runs, ds4 on (the default) and off, the gates as
    # locked by the first run.
    profiling.reset()
    fps = {}
    for ds4 in ("1", "0"):
        with env_var("DITHER_PIE_TPU_NEURAL_DS4", ds4):
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                got = neural_frames_run(run)
                walls.append(time.perf_counter() - t0)
                check(len(got) == NEURAL_FRAMES, "config 5: frames lost")
            fps[ds4] = NEURAL_FRAMES / min(walls)
            log(f"[18] config 5 process_frames, ds4 {'on' if ds4 == '1' else 'off'}: "
                f"{fps[ds4]:.3f} fps (best of 2 warm runs: "
                f"{', '.join(f'{t:.3f}' for t in walls)} s; precision "
                f"{model._video_prec!r}, ds4 stride {model._ds4_stride}) [{card}]")
        if ds4 == "1":
            log(profiling.stage_report())

    # Device ms of one batched forward by precision (CUDA events).
    pre = neural_input(run)
    x = model._tensor(pre)
    outs_u8, times = {}, {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for prec in NEURAL_PRECISIONS:
        times[prec], out = cuda_ms(torch, lambda: model.forward_tensor(x, prec), 3)
        outs_u8[prec] = inf._to_u8(out).to(torch.int16)
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB" if dev.type == "cuda"
            else "not measured")
    deltas = {p: (outs_u8[p] - outs_u8["float32"]).abs().float().mean().item()
              for p in NEURAL_PRECISIONS[1:]}
    log(f"[18] one batched forward (C2PGen + AliasNet, {pre.shape[0]} x {pre.shape[1]}x"
        f"{pre.shape[2]}, CUDA events, median of 3): "
        + ", ".join(f"{p} {times[p]:.3f} ms" for p in NEURAL_PRECISIONS)
        + f"; mean |u8 delta| against float32: "
        + ", ".join(f"{p} {d:.4f}" for p, d in deltas.items())
        + f"; peak device memory {peak} [{card}]")
    log(f"[18] phase 18 took {time.perf_counter() - t_phase:.1f} s [{card}]")
    return fps


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the synthetic video frames of phase 17")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 2
    # Pin both TF32 switches off, so no reduced-precision path can enter a
    # comparison; the neural pixelizer sets cuDNN's switch for its own
    # calls by its precision (models/layers.py, precision_scope).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(torch, torch.device("cuda"), card_line(), args.seed)


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(torch, dev, card, seed=0) -> int:
    """Phases 1-18 on ``dev``; prints the result lines and returns 0, or
    raises on the first failure. ``seed`` makes phase 17's video frames."""
    from PIL import Image

    t_run = time.perf_counter()

    import dither_pie_tpu_torch as dpt
    from dither_pie_tpu_torch.kernels import build
    from dither_pie_tpu_torch.ops import ed_kernels, wavefront as twf

    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    check("dither_pie_tpu" not in sys.modules, "dither_pie_tpu was imported")
    variants = ed_kernels.KERNEL_NAMES
    # Phases 1-8 hold the RGB path, whatever the link probe would say.
    os.environ["DITHER_PIE_TPU_INDEX_TRANSFER"] = "0"
    os.environ.pop("DITHER_PIE_TPU_DENSE_SEARCH", None)  # the exact search

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
    bounds = {  # bytes: inputs read once, outputs written once; of the (D, B, H)
        # stream an unskew needs only the B*H*W entries inside the image
        "skew": bound(n_px * 3 + d_fs * 3 * BATCH * FULL_H, 0),
        "ed_scan": scan_bound(BATCH, FULL_H, FULL_W, geom.s, N_COLORS,
                              len(geom.weights)),
        "unskew_unpack": bound(n_px * 4 + n_px * 3, 0),
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
        # The cluster size the timed scan launch ran with.
        cluster = {"n": twf.launch_plan(stream, pal_t, geom).n} if key == "ed_scan" else {}
        log(f"[6] {key}: kernel {ms:.3f} ms, plain PyTorch {plain_ms:.3f} ms "
            f"per {BATCH}x{FULL_H}x{FULL_W} FS batch, outputs equal bitwise {cluster} "
            f"[{card}]")
        rows.append({"name": key, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches.get(key, 0),
                     "max_abs_err": errs[key], "ms": ms,
                     "plain_ms": plain_ms, **cluster, **bounds[key]})

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
    # And phase 10's call, the same batch with the score search.
    with env_var("DITHER_PIE_TPU_DENSE_SEARCH", "mxu"):
        ditherer256.apply_dithering_batch(frames16)
        report_trace(torch, "6-256-mxu",
                     "apply_dithering_batch FS k-means-256, DITHER_PIE_TPU_DENSE_SEARCH=mxu",
                     lambda: ditherer256.apply_dithering_batch(frames16), frames16.nbytes, card)
    # Phase 9's index-stream calls are traced here for the same reason:
    # k-means-32 (one byte a pixel) and k-means-16 (4-bit packed).
    palette16 = dpt.ColorReducer.generate_kmeans_palette(
        Image.fromarray(frame0), 16, device=dev)
    ditherer16 = dpt.ImageDitherer(
        num_colors=16, dither_mode=dpt.DitherMode.ERROR_DIFFUSION,
        palette=palette16, dither_params={"variant": "floyd_steinberg"}, device=dev)
    with index_transfer("1"):
        for tag, what, d in (("6-idx", "FS k-means-32, index stream u8", ditherer),
                             ("6-idx4", "FS k-means-16, index stream 4-bit packed",
                              ditherer16)):
            d.apply_dithering_batch(frames16)
            report_trace(torch, tag, f"apply_dithering_batch {what}",
                         lambda: d.apply_dithering_batch(frames16), frames16.nbytes, card)
    # Phase 18's config 5 is traced here for the same reason, before the
    # video leg: traced after it, its frames' H2D copy went missing from
    # the trace (seven config-5 traces in a row all keep it).
    with index_transfer("0"):
        neural_run = neural_setup(torch, dev, card)
    # Phase 17's leg (a), the video pipeline, is traced here for the same
    # reason.
    video_frames = moving_frames(VIDEO_FRAMES, VIDEO_H, VIDEO_W, seed)
    trace_video_leg(torch, dev, card, video_frames)

    # 7. The ordered path.
    ordered_row, out_bayer = ordered_phase(torch, dev, card, frames16, gold_frames)
    rows.append(ordered_row)

    # 8. The rest of the error-diffusion family.
    rows.extend(ed_modes_phase(torch, dev, card, lib, frames16, frame0, palette,
                               palette256, gold_frames, rows, errs))

    # 9. The index stream and planar batches.
    rows.extend(transfer_phase(torch, dev, card, lib, frames16, frame0, palette, palette16,
                               palette256, out16, out_bayer, rows, errs))

    # 10. The dense-search path, the transposing skew and the search probe.
    rows.extend(dense_search_phase(torch, dev, card, lib, frames16, frame0, palette256, rows,
                                   errs))

    # 11. Wavelet and halftone, K4 on float32 frames, the probes T1 and T3.
    rows.extend(transform_phase(torch, dev, card, frames16, palette, rows, errs))

    # 12. K2 and K8 over thread-block clusters.
    cluster_phase(torch, dev, card, frames16, errs)

    # 13. K1 and K3 at the odd shapes.
    tile_phase(torch, dev, card, errs)

    # 14. K6 and K4, redesigned, at the odd shapes and at 16 x 1080p.
    ported_phase(torch, dev, card, frames16, palette, out16, errs)

    # 15. K5, redesigned, at the odd shapes and on the uint16 streams.
    index_tile_phase(torch, dev, card, frames16, errs)

    # 16. The host engine: serpentine scans and Riemersma.
    t0 = time.perf_counter()
    fps_host = host_engine_phase(torch, dev, card, lib, frames16, frame0, palette)
    log(f"[16] phase 16 took {time.perf_counter() - t0:.1f} s")

    # 17. The streaming video pipeline (the RGB path, as phases 1-8).
    with index_transfer("0"):
        video_phase(torch, dev, card, lib, video_frames, fps_host)

    # 18. The neural pixelizer: BASELINE.md config 5 (the RGB path).
    with index_transfer("0"):
        neural_phase(torch, dev, card, lib, neural_run)
    for row in rows:
        if row["name"] in ("ed_scan", "ed_scan_idx", "skew", "unskew_unpack", "skew_planar",
                           "ordered_fused", "unskew_idx", "unskew_select", "identity",
                           "skew_transpose"):
            row["max_abs_err"] = max(row["max_abs_err"], errs.get(row["name"], 0.0))
    took = time.perf_counter() - t_run
    log(f"[18] the whole run took {took:.1f} s, {took / RUN_LIMIT_S:.2f} of its "
        f"{RUN_LIMIT_S} s limit")

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
