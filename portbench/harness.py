"""One run of one cell: set-up, the measured window, the check, the result.

The system under test is ``dither_pie_tpu_torch`` through its public
entries, driven by the module of the traffic's kind (``kinds/<kind>.py``:
``process_frames`` over decoded frames for "stream", ``apply_dithering``
on PIL images for "image"). The ditherer and its palette come from
``pipeline.image.build_ditherer``, as the command line builds them, with
the configuration's ``dithering`` and ``palette`` settings. What is
compared comes from the configuration's reference
(``references/<reference>.py``).

A run: set-up (extension load, the frame pool, the system with its
palette, the kind's own pieces, a warm-up at the cell's own shape), then
``seconds`` of closed-loop traffic, then the check against the reference
of a sample of the outputs drawn from the seed. With ``trace`` the window
runs under ``torch.profiler`` and the result carries the per-layer metrics.
Without it, a cell with an end-to-end metric read from the device trace
runs its window under a profiler of the card alone (no host ranges), and
that metric's reader (``metrics/<name>.py``) takes it from there.
"""

from __future__ import annotations

import logging
import subprocess
import time
from types import ModuleType
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import frames as frame_gen
from portbench import hoststate, readers
from portbench import trace as tracing
from portbench.cells import Cell, RunError, forbidden_loaded, load_module
from portbench.kinds import System, Window, sync


def card_readings() -> str:
    """nvidia-smi's name, power limit and SM clock of the card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().replace("\n", " | ")


class _FailureLog(logging.Handler):
    """Counts the program's records of batches retried frame by frame and
    of frames patched from a neighbour."""

    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.retried = 0
        self.patched = 0

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Batch dither failed"):
            self.retried += 1
        elif msg.startswith("Patched failed frame"):
            self.patched += 1


def load_extension(pieces: Dict[str, float]) -> str:
    """Load the program's kernels, timing it into ``pieces``; a line that
    says whether this run built them (a cold run, whose set-up stands apart
    from warm runs') or loaded them from the checkout's build directory."""
    from dither_pie_tpu_torch.kernels import build

    lib = build.BUILD_DIR / f"{build.EXT_NAME}.so"
    before = lib.stat().st_mtime_ns if lib.exists() else None
    t = time.perf_counter()
    build.extension()
    pieces["extension_s"] = time.perf_counter() - t
    after = lib.stat().st_mtime_ns if lib.exists() else None
    if before is None or before != after:
        return (f"build cold: this run built the extension (build_s="
                f"{pieces['extension_s']:.3f}); setup_s holds the build")
    return f"build warm: the extension was loaded from {lib.parent.name}/ (build_s=0)"


def check(config: Dict[str, Any], ref: ModuleType, pool: np.ndarray, system: System,
          win: Window, device: torch.device) -> Dict[str, Dict[str, float]]:
    """Every number compared, each beside its limit (``config["limits"]``):
    the reference's numbers about the program's palette, the share of
    pixels of each kept output that differ from the reference's output for
    the same input (the worst kept output), frames or calls that never
    came, frames patched."""
    ref_pal = ref.palette(pool[0], config, device)
    values = dict(ref.palette_checks(pool[0], system.palette, ref_pal, config))
    n = pool.shape[0]
    wanted = sorted({j % n for j in win.kept})
    refs = {}
    for lo in range(0, len(wanted), 64):
        part = wanted[lo:lo + 64]
        refs.update(zip(part, ref.outputs(pool[part], ref_pal, config, device)))
    worst = 1.0 if not win.kept else 0.0
    for j, out in win.kept.items():
        expected = refs[j % n]
        share = 1.0 if out.shape != expected.shape else float(
            np.any(out != expected, axis=-1).mean())
        worst = max(worst, share)
    values.update(mismatch_share=worst,
                  frames_missing=float(len(win.handed) - len(win.done) + win.failed_calls),
                  frames_patched=float(win.patched))
    limits = config["limits"]
    return {name: {"value": values[name], "limit": float(limits[name])} for name in limits}


def run(bench: Dict[str, Any], cell: Cell, seed: int, seconds: float, trace_on: bool,
        device: torch.device, t_start: float, import_s: float):
    """One run of ``cell``; returns (result, lines to print before it).
    ``t_start``: the process's start on ``time.perf_counter``'s clock."""
    config, traffic = cell.config, cell.traffic
    kind = load_module("kinds", traffic["kind"])
    ref = load_module("references", config["reference"])
    lines: List[str] = []
    pieces = {"import_s": import_s}
    cuda = device.type == "cuda"
    if cuda:
        lines.append(load_extension(pieces))
    lines.append(hoststate.placement(device))
    t = time.perf_counter()
    pool = frame_gen.make_pool(traffic, seed, device)
    pieces["frames_s"] = time.perf_counter() - t
    system = kind.setup(config, traffic, pool, device, lines, pieces)
    t = time.perf_counter()
    kind.warm(system, pool, traffic)
    sync(device)
    pieces["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    lines.append("setup " + " ".join(f"{k}={v:.3f}" for k, v in pieces.items())
                 + f" setup_s={setup_s:.3f}")

    stride = int(traffic["sample_stride"])
    offset = int(np.random.default_rng(seed).integers(stride))
    keep = lambda j: j % stride == offset  # noqa: E731
    failures = _FailureLog()
    program_log = logging.getLogger("dither_pie_tpu_torch")
    program_log.addHandler(failures)
    sources = {m["name"]: m["source"] for m in bench["end_to_end"]}
    card_e2e = cuda and any(sources[n] == "device_trace" for n in cell.end_to_end)
    host0 = hoststate.snapshot()
    prof = tracing.start(device, host=trace_on) if trace_on or card_e2e else None
    try:
        win = kind.window(system, pool, traffic, seconds, keep,
                          tracing.WINDOW_SPAN if trace_on else None)
    finally:
        program_log.removeHandler(failures)
    host1 = hoststate.snapshot()
    tr = tracing.collect(prof, cell.chips, window_span=trace_on) if prof is not None else None
    win.patched, win.retried = failures.patched, failures.retried
    memory_peak = max(torch.cuda.max_memory_allocated(c) for c in range(cell.chips)) \
        if cuda else 0
    bad = forbidden_loaded()
    if bad:
        raise RunError(f"modules of JAX or the JAX package were loaded: {bad}")
    lines.append(f"card {card_readings() if cuda else 'cpu (no card)'}")
    lines.append(hoststate.window_line(host0, host1, len(win.done)))
    lines.append(kind.profile(win))
    lines.append(f"window attempted={len(win.handed)} done={len(win.done)} "
                 f"kept={len(win.kept)} batches_retried={win.retried} "
                 f"frames_patched={win.patched} launches={win.launches}")

    frames_per_launch, input_bytes = kind.scan_launch(traffic)
    h, w = pool.shape[1:3]
    scan = ref.scan_work(config, frames_per_launch, h, w, input_bytes)
    if scan:
        lines.append(f"scan_bound one launch: {scan['bound_s'] * 1e3:.4f} ms "
                     f"(ops {scan['ops_s'] * 1e3:.4f}, bytes {scan['bytes_s'] * 1e3:.4f}); "
                     f"chain bound {scan['chain_bound_s'] * 1e3:.4f} ms over "
                     f"{scan['steps']} steps at {scan['chain_step_us']} us")

    system.ditherer = None
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    if hasattr(kind, "check"):
        checks = kind.check(config, ref, pool, system, win, device)
    else:
        checks = check(config, ref, pool, system, win, device)
    lines.append(f"check took {time.perf_counter() - t:.3f} s over "
                 f"{len({j % len(pool) for j in win.kept})} distinct inputs")

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics: Dict[str, Dict[str, Any]] = {}
    dev_info: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result: Dict[str, Any] = {}
    ctx = readers.Context(kind=traffic["kind"], trace=tr, counters=kind.counters(win, traffic),
                          scan=scan or {}, latencies=kind.latencies(win), seconds=win.seconds)
    if not trace_on:
        # The kind's own metrics from the host clock; the others (read from
        # the card's trace, absent where there is no card) by their readers.
        e2e = kind.end_to_end(win, setup_s)
        for name in cell.end_to_end:
            value = e2e[name] if name in e2e else readers.read_metric(name, ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        for name in cell.per_layer:
            value = readers.read_metric(name, ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        dev_info["busy_s"] = tr.busy_seconds()
        dev_info["window_s"] = tr.window_seconds
        result["breakdown"] = tracing.breakdown(tr)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(win.handed), "failed": kind.failed(win),
              "metrics": metrics, "device": dev_info, **result, "checks": checks}
    return result, lines
