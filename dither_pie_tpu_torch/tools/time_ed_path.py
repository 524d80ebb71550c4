#!/usr/bin/env python3
"""Device time of the error-diffusion path of one checkout, for comparing
two checkouts on one card, and the scan's cluster-size sweep.

    python3 dither_pie_tpu_torch/tools/time_ed_path.py [TREE] [--sweep]

TREE is the root of a checkout that holds ``dither_pie_tpu_torch`` (default:
the checkout this script lies in). It builds that tree's kernels, then times
on 16 distinct random uint8 frames already on the card, each as (median,
min, max) milliseconds of CUDA events after one warm-up:

* Floyd-Steinberg to 32 colours at 1080p: the whole device path
  (``ops.wavefront.ed_batch_wavefront``: skew, scan, unskew), 9 runs, on
  the NHWC frames and on their (3, 16, H, W) planes (K6, K2, K3 planar);
* the scan K2 alone at 32, 64, 256 and 1024 colours (1080p; Floyd-Steinberg,
  and at 32 colours also ostromoukhov, hybrid, perceptual and adaptive with
  random gates; at 256 and 1024 colours also the score search) and K8 at
  2048 colours (480p), 3 runs each, with the microseconds a wavefront step;
* K2 at 32 colours on 1024 and on 1080 rows (1920 wide), the microseconds a
  step of each: whether the rows a block of 1024 threads takes in a second
  pass cost anything;
* the ends of the path alone at 1080p, 9 runs each: the skew K1
  (``skew_gather``) of the uint8 frames beside K7 (``skew_transpose``) in
  its three forms (u8 -> u8, u8 -> f32, and f32 -> f32 on the frames as
  float32) and K6 (``skew_planar_gather``, on the frames' planes) on the
  same frames, K1 on the frames as float32, and the unskew K3
  (``unskew_unpack``) of the 32-colour scan's output in both layouts; K1's
  stream is held to K7's and K6's bitwise (K7's float32 forms to K1's
  stream cast);
* the index unskew K5 (``unskew_idx``) of the 32-colour index scan's
  output, uint8 and uint16, 9 runs each, beside the one PyTorch call that
  computes it, ``idx.as_strided((B, H, W), (H, s*B*H + 1, B*H)).to(dtype)``
  on the same stream (where this torch casts to uint16 on CUDA); each held
  to its plain version and to the library call's output bitwise;
* the ordered kernel K4 (``ordered_dither_fused``), 9 runs each: the 16
  frames to pico8 with the Bayer 8x8 screen, colours and indices; the
  frames as float32 with noise in [-0.5, 0.5) (the wavelet mode's float
  input) to a 32-colour palette; 100 frames (the 16 rolled along x) to
  pico8 with the 64x64 blue-noise screen. Each timed output is held to the
  plain version bitwise;
* the search probe T2 (``proto_mxu_search.search_exact`` /
  ``search_score`` with the tree's own cluster size) at 256 and 1024
  colours on its random inputs, one launch of 64 repetitions, 5 runs,
  and one launch of one repetition as a CUDA graph of 100, each output
  held to its plain version;
* K9 (``unskew_select``) of the index scan's 480p stream at 2048 and
  16384 colours, 9 runs each, beside the one PyTorch call that computes it,
  ``pal_u8[idx.as_strided(...)]``, each held to both;
* the probes T1 and T3 beside their library calls: T1's gather
  (``gather_probe.gather_chain``, k = 1, with the form its plan takes) on
  the 4096 x 128 int32 table against ``torch.gather`` on the same int64
  indices (and their ratio) and a 4 MB copy ``idx -> out`` (``copy_``, the
  floor of the gather's own bytes), T1's microseconds a dependent gather
  at 256, 1024, 4096 and 16384 rows with the form the plan takes for a
  chain at each height and, where the tree has it, the L2 line beside it
  (``gather_chain_l2``, the table read from device memory; a tree with the
  chain-aware plan times each staged form from its shortest chain and adds
  the device time of that launch of each, where the two break even, and
  the plan's launch at k = 4 and 68 beside the L2 line's), and T3's identity
  (``layout_repro.identity_copy``, the tree's aligned form) on one 100 x
  1080p plane against ``clone()``. A T1 launch is shorter than its Python
  enqueue, so both T1 forms are timed as a CUDA graph of 100 launches
  (device time a launch, the graph's gaps between kernels included), and
  also as 100 launches enqueued from Python; T3 as 20 launches in a row.
  Each output is held to its library call's bitwise. T3 runs in turns,
  clone(), kernel, kernel, clone(), and prints the kernel's time over
  clone()'s; then the plane less its first byte into a fresh output (input
  and output disagree mod 16: the shifted form).

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

``--probes`` prints only T1's and T3's lines (the card's line, the build,
then ``probe_lines``), for runs that compare the probes alone.

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
T1_ROWS = 4096  # T1's row time: the gather alone on a 4096 x 128 table
T1_CHAIN_ROWS = (256, 1024, 4096, 16384)
K9_SIZES = (2048, 16384)


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
    if "--probes" in sys.argv[1:]:
        return 1 if probe_lines(tree, card, dev, frames) else 0
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

    planes4 = frames.permute(3, 0, 1, 2).contiguous()
    for _ in range(2):
        path = ms(lambda: twf.ed_batch_wavefront(frames, pals[32]), 9)
        print(f"{tree}: FS 32 colours, 16 x 1080p u8: device path ms (median, min, max) "
              f"{path} [{card}]", flush=True)
        path = ms(lambda: twf.ed_batch_wavefront(planes4, pals[32], planar=True), 9)
        print(f"{tree}: FS 32 colours, 16 x 1080p u8 planar: device path ms (median, min, max) "
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
    frames_f32 = frames.to(torch.float32)
    col = twf.scan(stream, pals[32], geom, 1920)
    ends = {"K1 skew u8": lambda: twf.skew_gather(frames, geom.s),
            "K7 skew_transpose u8": lambda: twf.skew_transpose(frames, geom.s),
            "K7 skew_transpose u8 -> f32":
                lambda: twf.skew_transpose(frames, geom.s, torch.float32),
            "K7 skew_transpose float32": lambda: twf.skew_transpose(frames_f32, geom.s),
            "K1 skew float32": lambda: twf.skew_gather(frames_f32, geom.s),
            "K6 skew_planar u8": lambda: twf.skew_planar_gather(planes, geom.s),
            "K3 unskew_unpack NHWC": lambda: twf.unskew_unpack(col, geom.s, 1080, 1920),
            "K3 unskew_unpack planar": lambda: twf.unskew_unpack(col, geom.s, 1080, 1920, True)}
    for label, fn in ends.items():
        graph = f", {graph_ms(fn):.5f} ms a launch in a CUDA graph of 100" if "K3" in label else ""
        print(f"{tree}: {label}, 16 x 1080p FS: ms {ms(fn, 9)}{graph} [{card}]", flush=True)
    k1 = twf.skew_gather(frames, geom.s)
    for other in ("K7 skew_transpose u8", "K6 skew_planar u8", "K7 skew_transpose u8 -> f32",
                  "K7 skew_transpose float32", "K1 skew float32"):
        got = ends[other]()
        if not torch.equal(k1.to(got.dtype), got):
            print(f"{tree}: K1's stream != {other}'s", file=sys.stderr)
            return 1
        del got
    del k1, planes, planes4, col, frames_f32
    if index_lines(tree, card, twf, stream, pals[32], geom, ms):
        return 1
    if select_lines(tree, card, twf, sd_stream, pals, geom, ms, rng):
        return 1

    if (ordered_lines(tree, card, dev, frames, ms) or search_lines(tree, card, dev, ms)
            or probe_lines(tree, card, dev, frames)):
        return 1

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


def ordered_lines(tree, card, dev, frames, ms) -> bool:
    """K4's lines; True if a timed output differs from the plain version."""
    import torch

    from dither_pie_tpu_torch.core import thresholds as thr
    from dither_pie_tpu_torch.core.builtin_palettes import BUILTIN_PALETTES
    from dither_pie_tpu_torch.ops import ordered as tord
    from dither_pie_tpu_torch.ops import ordered_fused as tof

    rng = np.random.RandomState(4)
    h, w = frames.shape[1:3]
    pico8 = torch.tensor([[int(c[i:i + 2], 16) for i in (0, 2, 4)]
                          for c in BUILTIN_PALETTES["pico8_palette"]],
                         dtype=torch.float32, device=dev)
    pal32 = torch.from_numpy(rng.randint(0, 256, (32, 3)).astype(np.float32)).to(dev)
    bayer = tord.screen_for_matrix(thr.bayer_matrix("8x8"), h, w, dev)
    blue = tord.screen_for_matrix(thr.blue_noise_cached(64, 42), h, w, dev)
    noisy = frames.to(torch.float32) + torch.from_numpy(
        rng.uniform(-0.5, 0.5, tuple(frames.shape)).astype(np.float32)).to(dev)
    big = torch.cat([frames.roll(37 * k, dims=2) for k in range(7)])[:100]
    cases = [("u8 pico8 Bayer 8x8 colours, 16 x 1080p", frames, pico8, bayer, False),
             ("u8 pico8 Bayer 8x8 indices, 16 x 1080p", frames, pico8, bayer, True),
             ("float32 32 colours Bayer 8x8 colours, 16 x 1080p", noisy, pal32, bayer, False),
             ("u8 pico8 blue noise colours, 100 x 1080p", big, pico8, blue, False)]
    for label, x, pal, screen, ind in cases:
        t = ms(lambda: tof.ordered_dither_fused(x, pal, screen, ind), 9)
        same = torch.equal(tof.ordered_dither_fused(x, pal, screen, ind),
                           tof.ordered_dither_fused_plain(x, pal, screen, ind))
        print(f"{tree}: K4 ordered {label}: ms {t}, == plain {same} [{card}]", flush=True)
        if not same:
            print(f"{tree}: K4 {label} != its plain version", file=sys.stderr)
            return True
    return False


def index_lines(tree, card, twf, stream, pal, geom, ms) -> bool:
    """K5's lines; True if an output differs from the plain version's or
    the library call's."""
    import torch

    idx = twf.scan_idx(stream, pal, geom, 1920)
    b, bh = stream.shape[1] // 3, stream.shape[1] // 3 * 1080
    view = idx.as_strided((b, 1080, 1920), (1080, geom.s * bh + 1, bh))

    def same(x, y):  # uint16 has few CUDA operators: compare its bits as int16
        if x.dtype != y.dtype:
            return False
        if x.dtype == torch.uint16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        return torch.equal(x, y)

    for dtype in (torch.uint8, torch.uint16):
        kernel = lambda: twf.unskew_idx(idx, geom.s, 1080, 1920, dtype)
        got = kernel()
        ok = same(got, twf.unskew_idx_plain(idx, geom.s, 1080, 1920, dtype))
        t = ms(kernel, 9)
        g = graph_ms(kernel)
        try:
            lib_t = ms(lambda: view.to(dtype), 9)
            ok &= same(view.to(dtype), got)
        except (RuntimeError, NotImplementedError) as e:
            lib_t = f"not taken on CUDA ({e})"
        print(f"{tree}: K5 unskew_idx {str(dtype)[6:]}, 16 x 1080p FS P=32: ms {t}, {g:.5f} ms a "
              f"launch in a CUDA graph of 100; "
              f"as_strided(...).to({str(dtype)[6:]}) ms {lib_t}; == plain and library {ok} "
              f"[{card}]", flush=True)
        if not ok:
            print(f"{tree}: K5 {dtype} != its plain version or the library call",
                  file=sys.stderr)
            return True
    return False


def select_lines(tree, card, twf, sd_stream, pals, geom, ms, rng) -> bool:
    """K9's lines at 16 x 480p: the index scan's own stream at 2048 colours
    and at 16384 (the index scan's largest palette); True if an output
    differs from the plain version's or the library call's."""
    import torch

    for p in K9_SIZES:
        pal = pals.get(p)
        if pal is None:
            pal = torch.from_numpy(rng.randint(0, 256, (p, 3)).astype(np.float32)).to(
                sd_stream.device)
        idx = twf.scan_idx(sd_stream, pal, geom, 854)
        b, bh = idx.shape[1], idx.shape[1] * 480
        pal_u8 = pal.to(torch.int32).to(torch.uint8)
        view = idx.as_strided((b, 480, 854), (480, geom.s * bh + 1, bh))
        kernel = lambda: twf.unskew_select(idx, pal, geom.s, 480, 854)
        got = kernel()
        ok = (torch.equal(got, twf.unskew_select_plain(idx, pal, geom.s, 480, 854))
              and torch.equal(got, pal_u8[view]))
        t = ms(kernel, 9)
        g = graph_ms(kernel)
        lib_t = ms(lambda: pal_u8[view], 9)
        lib_g = graph_ms(lambda: pal_u8[view])
        print(f"{tree}: K9 unskew_select, 16 x 480p FS P={p}: ms {t}, {g:.5f} ms a launch in a "
              f"CUDA graph of 100; pal_u8[idx.as_strided(...)] ms {lib_t}, {lib_g:.5f} ms in a "
              f"graph; == plain and library {ok} [{card}]", flush=True)
        if not ok:
            print(f"{tree}: K9 P={p} != its plain version or the library call",
                  file=sys.stderr)
            return True
        del idx, got
    return False


def graph_ms(fn, launches: int = 100) -> float:
    """Device milliseconds a launch of fn, from CUDA events around the
    replay of a CUDA graph of ``launches`` calls (median of 5 replays)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    del graph
    return statistics.median(times)


def loop_ms(fn, launches: int) -> float:
    """Milliseconds a launch of fn over ``launches`` calls enqueued back to
    back between two CUDA events (median of 5)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return statistics.median(times)


def search_lines(tree, card, dev, ms) -> bool:
    """T2's lines; True if an output differs from its plain version."""
    import torch

    from dither_pie_tpu_torch import convert
    from dither_pie_tpu_torch.tools import proto_mxu_search as probe

    for pp in (256, 1024):
        cur, pal = (torch.from_numpy(a).to(dev) for a in probe.probe_inputs(pp))
        aug = convert.augment_palette(pal)
        for form, fn, arg, plain in (("exact", probe.search_exact, pal, probe.search_exact_plain),
                                     ("score", probe.search_score, aug, probe.search_score_plain)):
            same = torch.equal(fn(cur, arg, 64), plain(cur, arg))
            t = ms(lambda: fn(cur, arg, 64), 5)
            g = graph_ms(lambda: fn(cur, arg, 1))
            n = probe.probe_cluster_size(pp) if hasattr(probe, "probe_cluster_size") else 1
            print(f"{tree}: T2 search probe {form} pp={pp} n={n}: one launch of 64 repetitions "
                  f"ms {t}, {t[0] * 1e3 / 64:.4f} us a repetition; one repetition {g:.5f} ms a "
                  f"launch in a CUDA graph of 100; == plain {same} [{card}]", flush=True)
            if not same:
                print(f"{tree}: T2 {form} pp={pp} != its plain version", file=sys.stderr)
                return True
    return False


def probe_lines(tree, card, dev, frames) -> bool:
    """T1's and T3's lines; True if an output differs from its library
    call's. A tree from before the chain-aware plan (its
    ``gather_slab_plan`` takes no k) prints its own forms."""
    import torch

    from dither_pie_tpu_torch.tools import gather_probe as gp
    from dither_pie_tpu_torch.tools import layout_repro as lr

    chain_aware = hasattr(gp, "chain_line")

    def form(rows, k, update):
        if chain_aware:
            return gp.gather_slab_plan(rows, rows, gp.LF, k, update).form
        return gp.gather_slab_plan(rows, rows, gp.LF).form

    tbl, idx = (torch.from_numpy(a).to(dev) for a in gp.gather_inputs(T1_ROWS))
    idx64 = idx.long()
    copy_out = torch.empty_like(idx)
    t1 = (lambda: gp.gather_chain(tbl, idx), lambda: torch.gather(tbl, 0, idx64),
          lambda: copy_out.copy_(idx))
    same = torch.equal(t1[0](), t1[1]())
    g = [graph_ms(f) for f in t1]
    loop = [loop_ms(f, 100) for f in t1[:2]]
    print(f"{tree}: T1 gather {tuple(tbl.shape)} int32 (k=1, {form(T1_ROWS, 1, 'none')} "
          f"form): kernel {g[0]:.5f} ms, torch.gather {g[1]:.5f} ms (kernel / torch.gather "
          f"{g[0] / g[1]:.3f}), the 4 MB copy idx -> out {g[2]:.5f} ms a launch in a CUDA "
          f"graph of 100; enqueued from Python: kernel {loop[0]:.5f} ms, torch.gather "
          f"{loop[1]:.5f} ms; == torch.gather {same} [{card}]", flush=True)
    chains = {rows: gp.probe_chain(rows, 64, dev) for rows in T1_CHAIN_ROWS}
    if chain_aware:
        for rows, r in chains.items():
            print(f"{tree}: T1 {gp.chain_line(r)} [{card}]", flush=True)
    else:
        print(f"{tree}: T1 chain, us a dependent gather: "
              + ", ".join(f"rows={rows} {r['us_per_op']:.4f} ({form(rows, 2, 'chain')}: "
                          f"{r['memory']}"
                          + (f"; from L2 {r['l2_us_per_op']:.4f}" if "l2_us_per_op" in r
                             else "")
                          + ")" for rows, r in chains.items()) + f" [{card}]", flush=True)
    plane = lr.planarize(torch.cat([frames.roll(37 * k, dims=2) for k in range(7)])[:100])
    kernel = lambda: lr.identity_copy(plane)
    turns = [("clone()", lambda: plane.clone()), (f"kernel ({lr.IDENTITY_FORMS[0]})", kernel)]
    same3 = torch.equal(kernel(), plane)
    times = [(label, loop_ms(fn, 20)) for label, fn in turns + turns[::-1]]
    ratio = (times[1][1] + times[2][1]) / (times[0][1] + times[3][1])
    print(f"{tree}: T3 identity, one {tuple(plane.shape)} u8 plane, ms a launch over 20 in a "
          f"row, in turns: {', '.join(f'{label} {ms:.5f}' for label, ms in times)}; kernel / "
          f"clone() {ratio:.4f}; == input {same3} [{card}]", flush=True)
    off = plane.view(-1)[1:]
    shifted = lambda: lr.identity_copy(off)
    same3 &= torch.equal(shifted(), off)
    print(f"{tree}: T3 identity, the plane less its first byte into a fresh output (shifted "
          f"form): kernel {loop_ms(shifted, 20):.5f} ms a launch over 20 in a row; == input "
          f"{same3} [{card}]", flush=True)
    return not (same and same3)


if __name__ == "__main__":
    sys.exit(main())
