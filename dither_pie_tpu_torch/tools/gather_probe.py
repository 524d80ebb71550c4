#!/usr/bin/env python3
"""Probe: a per-lane table gather against the select sweep, alone.

    python3 dither_pie_tpu_torch/tools/gather_probe.py [reps]

The wavefront scan's palette search sweeps every colour for every pixel.
An exact two-stage search (RGB-grid cell -> the cell's list of candidate
colours -> exact refine) would replace the sweep by a fetch of the pixel's
own candidates: ``out[r, l] = table[idx[r, l], l]``. This probe measures
what such a fetch costs beside the sweep, with two hand-written CUDA
kernels (``kernels/csrc/gather_probe.cu``), one thread an element:

* the gather alone, held to ``np.take_along_axis``, at tables of 64, 512,
  1024, 4096 and 16384 rows of 128 lanes (``gather rows=...: OK exact``),
  and both chains held to the plain version at the chain heights below, at
  k = 68 and at the staged form's shortest chain;
* a chain of k dependent gathers, ``acc = |table[acc, l] + step| mod rows``,
  at tables of 256 to 32768 rows (``LINE_ROWS``: the probe's heights and
  the edges of each staged form's range). ``gather_slab_plan`` stages the
  table of a long enough chain in shared memory: whole in each block where
  it fits a block's 227 KB (rows <= 454 at 128 lanes), else as lane slabs
  (8 lanes, 32 bytes of every row, a block) multicast by TMA to a
  thread-block cluster of 2 where a slab fits one block (to 7168 rows),
  else as one lane's column a block (to 32768 rows), filled by loads of the
  table. A staged form pays a fixed time (its fill) to save a time a step,
  so a chain shorter than ``stage_min_k`` at its height reads the table where
  it lies, as a single gather (k = 1) does at every height: the device
  form, whose launch at any k is the L2 line (``gather_chain_l2``). At each
  height the line gives the staged form's and the L2 line's microseconds a
  gather (a launch of k = K + 64*reps against one of k = K, K the form's
  shortest chain: the launch and the staging cancel), the device time of
  each one's k = K launch (in a CUDA graph of 100), the chain length where
  the two launches break even, and the device time of the plan's launch at
  k = 4 and k = 68 beside the L2 line's;
* the select sweep over the P rows of a table on an (8, 128) tile (one
  block of 1024 threads: the scan's situation, one SM a frame),
  ``best = where((acc & (P-1)) == p, table[p], best)`` for every p, then
  ``acc = |best + acc + step| mod 255``, at P = 64, 256 and 1024, and
  beside it the gather chain on the same tile and table with the same
  update, whose output must equal the sweep's bit for bit. Their ratio is
  what a thread's own fetch saves over a sweep of P selects; the gather
  on the L2 line beside it.

It is the port's counterpart of the JAX package's ``tools/gather_probe.py``.
Each wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor. The timing needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

if __name__ == "__main__":  # run as a script: find the package beside it
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from dither_pie_tpu_torch.kernels import build  # noqa: E402
from dither_pie_tpu_torch.tools.proto_mxu_search import _cuda_ms, card_line  # noqa: E402

LF = 128  # lanes of every table and tile
SMEM_BYTES = 227 * 1024  # dynamic shared memory a block may opt in to
# The multicast form (gather_probe.cu): a block serves SLAB_LANES lanes (32
# bytes of every table row), a lane group has SLAB_BLOCKS blocks of
# SLAB_THREADS threads in clusters of MULTICAST_CLUSTER (64 clusters fit one
# wave on an H100; clusters of 4 and 8 ran in two at twice the time,
# PERF.md), the slab arrives in TMA boxes of SLAB_BOX_ROWS rows on a
# SLAB_ALIGN boundary with its mbarrier (SLAB_BARRIER bytes) after it. The
# column form: a block of SLAB_THREADS a lane, at most COLUMN_MAX_ROWS rows
# (128 KB).
SLAB_LANES = 8
SLAB_BLOCKS = 8
SLAB_THREADS = 1024
SLAB_BOX_ROWS = 256
SLAB_ALIGN = 128
SLAB_BARRIER = 16
MULTICAST_CLUSTER = 2
COLUMN_MAX_ROWS = 32768
GATHER_FORMS = ("block", "multicast", "column", "device")  # the kernel's order
# The shortest chain a staged form is taken for, by table height: bands of
# (form, the band's last table row, its shortest chain), from the launches
# ``probe_chain`` timed on an H100 at 128 lanes and n = rows (PERF.md). The
# block form's launch is linear in k, and its break-even with the L2
# line's rises with the height (every block stages the whole table): the
# largest measured at the band's top, 76.6 at 256 rows and 125.4 at 454,
# plus a tenth for the spread between runs. The multicast and column
# forms' first steps cost more than their later ones, so their bands are
# the shortest chain measured to win, the L2 line having won the shorter
# one: at 455 rows k = 4 lost and k = 18 won, at 1024 rows k = 2 lost and
# k = 4 won, at 4096 and 7168 rows k = 2 won; the column form won at k = 4
# at 7169, 16384 and 32768 rows. Below it the device form's launch is the
# faster.
ANY_ROWS = 1 << 30
STAGE_BANDS = (("block", 256, 85), ("block", ANY_ROWS, 138), ("multicast", 1023, 18),
               ("multicast", 4095, 4), ("multicast", ANY_ROWS, 2), ("column", ANY_ROWS, 4))
CHECK_ROWS = (64, 512, 1024, 4096, 16384)
CHAIN_ROWS = (256, 1024, 4096, 16384)
# The chain lines' heights: CHAIN_ROWS and both ends of each staged range.
LINE_ROWS = (256, 454, 455, 1024, 4096, 7168, 7169, 16384, 32768)
SWEEP_SIZES = (64, 256, 1024)
SWEEP_TILE_ROWS = 8
CHAIN_SPAN = 64  # k = K against k = K + 64*reps
LAUNCH_K = (4, 68)  # the chain lengths whose whole launch the line times
SWEEP_K = (2, 16)  # k = 2 against k = 2 + 16*reps
UPDATES = ("none", "chain", "sweep")


def gather_inputs(rows: int, lf: int = LF) -> Tuple[np.ndarray, np.ndarray]:
    """(table, idx) of the correctness check: a table of distinct values
    and seeded random row indices, both (rows, lf) int32."""
    tbl = np.arange(rows * lf, dtype=np.int32).reshape(rows, lf)
    idx = np.random.RandomState(0).randint(0, rows, (rows, lf)).astype(np.int32)
    return tbl, idx


def chain_inputs(rows: int, lf: int = LF) -> Tuple[np.ndarray, np.ndarray]:
    """(table, idx) of the gather chain: row indices in a (rows, lf) table."""
    tbl = np.random.RandomState(1).randint(0, rows, (rows, lf)).astype(np.int32)
    idx = np.random.RandomState(2).randint(0, rows, (rows, lf)).astype(np.int32)
    return tbl, idx


def sweep_inputs(p: int, lf: int = LF) -> Tuple[np.ndarray, np.ndarray]:
    """(table (p, lf), tile (8, lf)) of the select sweep, values under 255."""
    tbl = np.random.RandomState(1).randint(0, 255, (p, lf)).astype(np.int32)
    idx = np.random.RandomState(2).randint(0, 255, (SWEEP_TILE_ROWS, lf)).astype(np.int32)
    return tbl, idx


def table_in_smem(table: torch.Tensor) -> bool:
    """Whether the whole table fits one block's shared memory: the sweep
    stages it there (else it reads device memory), and a long enough chain
    over it takes the block form."""
    return table.numel() * 4 <= SMEM_BYTES


@dataclass(frozen=True)
class GatherPlan:
    """One launch of the gather: its ``form`` (``GATHER_FORMS``), blocks a
    ``cluster``, the output rows a block takes (device and block forms: the
    rows its threads start in), the table rows a block holds in shared
    memory, its ``threads``, the ``grid`` in blocks, and its dynamic shared
    memory."""

    form: str
    cluster: int
    rows_per_block: int
    slab_rows: int
    threads: int
    grid: int
    smem_bytes: int


def device_plan(n: int, lanes: int) -> GatherPlan:
    """The device form's launch: one thread an element, blocks of up to
    1024 threads, the table where it lies (at any k: the L2 line)."""
    n_el = n * lanes
    threads = 1024 if n_el >= 1024 else -(-n_el // 32) * 32
    return GatherPlan("device", 1, -(-threads // lanes), 0, threads, -(-n_el // threads), 0)


def staged_form(rows: int, lanes: int) -> Optional[str]:
    """The staged form a chain takes at this table height: "block" (the
    table fits one block's shared memory whole), "multicast" (a lane slab,
    rows rounded up to whole boxes of 256, 32 bytes a row, fits one block),
    "column" (up to COLUMN_MAX_ROWS rows), or None (no form holds it)."""
    if rows * lanes * 4 <= SMEM_BYTES:
        return "block"
    if -(-rows // SLAB_BOX_ROWS) * SLAB_BOX_ROWS * 32 + SLAB_ALIGN + SLAB_BARRIER <= SMEM_BYTES:
        return "multicast"
    return "column" if rows <= COLUMN_MAX_ROWS else None


def stage_min_k(rows: int, lanes: int) -> int:
    """The shortest chain the staged form of this table height is taken
    for (``STAGE_BANDS``)."""
    form = staged_form(rows, lanes)
    return next(k for f, last, k in STAGE_BANDS if f == form and rows <= last)


def gather_slab_plan(rows: int, n: int, lanes: int, k: int, update: str) -> GatherPlan:
    """The gather's launch for a (rows, lanes) int32 table, n output rows and
    a chain of k gathers with ``update``; ``gather_probe.cu`` computes the
    same and refuses any other (but the device form, the L2 line).

    * "device": a single gather (k = 1) at every height, and a chain
      shorter than ``stage_min_k`` of its height's staged form: one thread
      an element, the table where it lies.
    * "block" (chains): the table fits one block's shared memory whole
      (rows * lanes * 4 <= 227 KB): the device form's walk, each block
      staging the table.
    * "multicast" (chains): a lane slab fits one block: a lane group's
      SLAB_BLOCKS blocks form clusters of MULTICAST_CLUSTER, each loading
      the slab once by TMA multicast, and take ceil(n / SLAB_BLOCKS)
      output rows each; lanes must be a multiple of 8 (for every chain at
      these heights, staged or not).
    * "column" (chains, up to COLUMN_MAX_ROWS rows): a block a lane (the
      grid is ``lanes``), each holding its lane's column, filled by loads
      of the table, and taking all n output rows."""
    if rows < 1 or n < 1 or lanes < 1 or k < 1:
        raise ValueError(f"no gather plan for rows={rows} n={n} lanes={lanes} k={k}")
    if update not in UPDATES:
        raise ValueError(f"update must be one of {UPDATES}, got {update!r}")
    if update == "none" and k != 1:
        raise ValueError('update "none" is one gather: k must be 1')
    if k == 1:
        return device_plan(n, lanes)
    form = staged_form(rows, lanes)
    if form is None:
        raise ValueError(f"a column of {rows} rows does not fit a block's shared memory")
    if form == "multicast" and lanes % SLAB_LANES:
        raise ValueError(f"the multicast form takes lanes in multiples of {SLAB_LANES}, "
                         f"got {lanes}")
    if k < stage_min_k(rows, lanes):
        return device_plan(n, lanes)
    if form == "block":
        return dataclasses.replace(device_plan(n, lanes), form="block", slab_rows=rows,
                                   smem_bytes=rows * lanes * 4)
    if form == "multicast":
        slab_rows = -(-rows // SLAB_BOX_ROWS) * SLAB_BOX_ROWS
        return GatherPlan("multicast", MULTICAST_CLUSTER, -(-n // SLAB_BLOCKS), slab_rows,
                          SLAB_THREADS, lanes // SLAB_LANES * SLAB_BLOCKS,
                          slab_rows * 32 + SLAB_ALIGN + SLAB_BARRIER)
    return GatherPlan("column", 1, n, rows, SLAB_THREADS, lanes, rows * 4)


def gather_chain_plain(table: torch.Tensor, idx: torch.Tensor, k: int = 1,
                       update: str = "none") -> torch.Tensor:
    """Plain PyTorch gather chain: ``torch.gather(table, 0, acc)`` k times
    with the integer update between, int32 throughout."""
    rows = table.shape[0]
    if update == "none":
        return torch.gather(table, 0, idx.long())
    acc = idx
    for step in range(k):
        if update == "chain":
            acc = (torch.gather(table, 0, acc.long()) + step).abs() % rows
        else:
            best = torch.gather(table, 0, (acc & (rows - 1)).long())
            acc = (best + acc + step).abs() % 255
    return acc


def sweep_chain_plain(table: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch select sweep: P eager selects a step."""
    p = table.shape[0]
    acc = idx
    for step in range(k):
        key = acc & (p - 1)
        best = torch.zeros_like(acc)
        for row in range(p):
            best = torch.where(key == row, table[row:row + 1], best)
        acc = (best + acc + step).abs() % 255
    return acc


def _check(table: torch.Tensor, idx: torch.Tensor, k: int, power_of_two: bool) -> None:
    if table.dtype != torch.int32 or table.dim() != 2:
        raise ValueError("table must be a (rows, lanes) int32 tensor")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[1] != table.shape[1]:
        raise ValueError("idx must be an (n, lanes) int32 tensor")
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device}, table on {table.device}")
    if k < 1:
        raise ValueError("k must be >= 1")
    rows = table.shape[0]
    if power_of_two and rows & (rows - 1):
        raise ValueError(f"the sweep's table height must be a power of two, got {rows}")


def _check_update(table: torch.Tensor, idx: torch.Tensor, k: int, update: str) -> None:
    if update not in UPDATES:
        raise ValueError(f"update must be one of {UPDATES}, got {update!r}")
    if update == "none" and k != 1:
        raise ValueError('update "none" is one gather: k must be 1')
    _check(table, idx, k, power_of_two=update == "sweep")


def launch_gather(table: torch.Tensor, idx: torch.Tensor, out: torch.Tensor, k: int,
                  update: str, plan: GatherPlan) -> None:
    """The gather kernel as ``plan`` says (the launcher refuses any plan
    but ``gather_slab_plan``'s and ``device_plan``'s), on contiguous CUDA
    tensors."""
    build.extension().gather_chain(table, idx, out, k, UPDATES.index(update),
                                   GATHER_FORMS.index(plan.form), plan.cluster,
                                   plan.rows_per_block, plan.slab_rows, plan.threads,
                                   plan.grid, plan.smem_bytes)


def _gather(table: torch.Tensor, idx: torch.Tensor, k: int, update: str,
            plan: GatherPlan) -> torch.Tensor:
    """One launch of ``plan``: a multicast table whose base lies off a
    16-byte boundary goes as a fresh contiguous copy (a tensor map's base
    is aligned; the same kernel runs)."""
    table = table.contiguous()
    if plan.form == "multicast" and table.data_ptr() % 16:
        table = table.clone()
    out = torch.empty_like(idx)
    launch_gather(table, idx.contiguous(), out, k, update, plan)
    build.count_launch("gather_probe")
    return out


def gather_chain(table: torch.Tensor, idx: torch.Tensor, k: int = 1,
                 update: str = "none") -> torch.Tensor:
    """The gather kernel on CUDA tensors, its plain version on CPU tensors.

    ``table`` (rows, lanes) int32, ``idx`` (n, lanes) int32 -> (n, lanes)
    int32. ``update`` "none": ``table[idx, l]`` (k = 1); "chain": k times
    ``acc = |table[acc, l] + step| mod rows``; "sweep": k times
    ``acc = |table[acc & (rows-1), l] + acc + step| mod 255``, the select
    sweep's update with the fetch done by one load. Start values outside
    0..rows-1 are an error ("none", "chain"): ``torch.gather`` raises for
    them on the CPU, the kernel asserts on the card. On the card the launch
    is ``gather_slab_plan(rows, n, lanes, k, update)``'s."""
    _check_update(table, idx, k, update)
    if not build.on_cuda(table):
        return gather_chain_plain(table, idx, k, update)
    return _gather(table, idx, k, update,
                   gather_slab_plan(table.shape[0], idx.shape[0], table.shape[1], k, update))


def gather_chain_l2(table: torch.Tensor, idx: torch.Tensor, k: int = 1,
                    update: str = "none") -> torch.Tensor:
    """``gather_chain``'s function in the device form at any k (the table
    read where it lies in device memory, nothing staged; an H100's L2 holds
    every table of the probe): the L2 line that the staged forms are
    measured against, the same kernel and launcher as ``gather_chain``'s
    device form. Its plain version on CPU tensors."""
    _check_update(table, idx, k, update)
    if not build.on_cuda(table):
        return gather_chain_plain(table, idx, k, update)
    return _gather(table, idx, k, update, device_plan(idx.shape[0], table.shape[1]))


def sweep_chain(table: torch.Tensor, idx: torch.Tensor, k: int = 1) -> torch.Tensor:
    """The select-sweep kernel on CUDA tensors, its plain version on CPU
    tensors: ``table`` (P, lanes) int32 with P a power of two, ``idx``
    (n, lanes) int32 -> (n, lanes) int32."""
    _check(table, idx, k, power_of_two=True)
    if not build.on_cuda(table):
        return sweep_chain_plain(table, idx, k)
    out = torch.empty_like(idx)
    build.extension().sweep_chain(table.contiguous(), idx.contiguous(), out, k,
                                  table_in_smem(table))
    build.count_launch("gather_probe_sweep")
    return out


def _per_op_us(fn, k_lo: int, span: int, reps: int) -> float:
    """Microseconds a step of ``fn(k)``: the median time of k = k_lo +
    span*reps less that of k = k_lo, over the steps between."""
    hi = _cuda_ms(lambda: fn(k_lo + span * reps), 7)
    lo = _cuda_ms(lambda: fn(k_lo), 7)
    return max(hi - lo, 1e-9) * 1e3 / (span * reps)


def describe(plan: GatherPlan) -> str:
    """Where a launch of ``plan`` holds the table."""
    if plan.form == "device":
        return "device memory (device: read where it lies)"
    if plan.form == "block":
        return "shared memory (block: the whole table in each block)"
    if plan.form == "multicast":
        return (f"shared memory (multicast: the lane slab in each block, a TMA multicast "
                f"load to a cluster of {plan.cluster})")
    return (f"shared memory (column: one lane's {plan.slab_rows} rows a block, filled by "
            f"loads of the table)")


def check_gather(rows: int, device) -> bool:
    """The gather alone on ``device`` against ``np.take_along_axis``."""
    tbl, idx = gather_inputs(rows)
    out = gather_chain(torch.from_numpy(tbl).to(device), torch.from_numpy(idx).to(device))
    return bool(np.array_equal(out.cpu().numpy(), np.take_along_axis(tbl, idx, axis=0)))


def check_chain(rows: int, device) -> bool:
    """Both chains on ``device`` at k = 68 and at the shortest chain the
    height's staged form is taken for, against the plain version on the
    CPU."""
    tbl, idx = (torch.from_numpy(a) for a in chain_inputs(rows))
    ok = True
    for update in ("chain", "sweep"):
        for k in sorted({68, stage_min_k(rows, tbl.shape[1])}):
            got = gather_chain(tbl.to(device), idx.to(device), k, update)
            ok &= bool(torch.equal(got.cpu(), gather_chain_plain(tbl, idx, k, update)))
    return ok


def probe_chain(rows: int, reps: int, device) -> Dict[str, object]:
    """The chain at a table of ``rows`` rows in its height's staged form and
    on the L2 line: microseconds a dependent gather of each, from k = K to
    K + CHAIN_SPAN*reps with K the height's ``stage_min_k``; the device
    microseconds of each one's k = K launch (in a CUDA graph of 100); the
    chain length where the two launches break even (a launch is its k = K
    time plus a gather's time for each step beyond); and the device
    microseconds of the plan's launch and of the L2 line's at each k of
    LAUNCH_K (one time where the plan takes the device form: the same
    launch)."""
    from dither_pie_tpu_torch.tools.time_ed_path import graph_ms

    tbl, idx = (torch.from_numpy(a).to(device) for a in chain_inputs(rows))
    lanes = tbl.shape[1]
    form = staged_form(rows, lanes)
    k_lo = stage_min_k(rows, lanes)
    staged = lambda k: gather_chain(tbl, idx, k, "chain")  # noqa: E731
    l2 = lambda k: gather_chain_l2(tbl, idx, k, "chain")  # noqa: E731
    per = _per_op_us(staged, k_lo, CHAIN_SPAN, reps)
    l2_per = _per_op_us(l2, k_lo, CHAIN_SPAN, reps)
    launch = graph_ms(lambda: staged(k_lo)) * 1e3
    l2_launch = graph_ms(lambda: l2(k_lo)) * 1e3
    gain = l2_per - per
    break_even = k_lo + (launch - l2_launch) / gain if gain > 0 else float("inf")
    launches = {}
    for k in LAUNCH_K:
        plan = gather_slab_plan(rows, rows, lanes, k, "chain")
        l2_us = graph_ms(lambda: l2(k)) * 1e3
        us = l2_us if plan.form == "device" else graph_ms(lambda: staged(k)) * 1e3
        launches[k] = {"form": plan.form, "us": us, "l2_us": l2_us}
    assert gather_slab_plan(rows, rows, lanes, k_lo, "chain").form == form
    return {"rows": rows, "form": form, "k_lo": k_lo, "us_per_op": per,
            "ns_per_row": per * 1e3 / rows, "launch_us": launch,
            "memory": describe(gather_slab_plan(rows, rows, lanes, k_lo, "chain")),
            "l2_us_per_op": l2_per, "l2_launch_us": l2_launch, "break_even_k": break_even,
            "launches": launches}


def probe_sweep(p: int, reps: int, device) -> Dict[str, object]:
    """The select sweep over ``p`` rows and the gather chain with the same
    update, on the same (8, 128) tile: microseconds a step of each (the
    gather's from the shortest chain its staged form is taken for) and of
    the gather on the L2 line, and whether their outputs are equal."""
    tbl, idx = (torch.from_numpy(a).to(device) for a in sweep_inputs(p))
    k_lo, span = SWEEP_K
    k_hi = k_lo + span * reps
    g_lo = max(k_lo, stage_min_k(p, tbl.shape[1]))
    equal = bool(torch.equal(sweep_chain(tbl, idx, k_hi),
                             gather_chain(tbl, idx, k_hi, "sweep")))
    sweep_us = _per_op_us(lambda k: sweep_chain(tbl, idx, k), k_lo, span, reps)
    gather_us = _per_op_us(lambda k: gather_chain(tbl, idx, k, "sweep"), g_lo, span, reps)
    l2_us = _per_op_us(lambda k: gather_chain_l2(tbl, idx, k, "sweep"), g_lo, span, reps)
    plan = gather_slab_plan(p, SWEEP_TILE_ROWS, tbl.shape[1], g_lo, "sweep")
    return {"p": p, "sweep_us_per_op": sweep_us, "gather_us_per_op": gather_us,
            "l2_us_per_op": l2_us, "equal": equal, "form": plan.form,
            "memory": describe(plan),
            "sweep_memory": "shared memory" if table_in_smem(tbl) else "device memory"}


def chain_line(r: Dict[str, object]) -> str:
    """A line of ``probe_chain``'s numbers."""
    k_lo = r["k_lo"]
    plan = "; ".join(
        f"k={k}: {x['form']} {x['us']:.3f} us" + ("" if x["form"] == "device" else
                                                  f" against the L2 line's {x['l2_us']:.3f}")
        for k, x in r["launches"].items())
    return (f"gather chain rows={r['rows']} ({r['form']} from k={k_lo}): {r['us_per_op']:.4f} "
            f"us a gather ({r['ns_per_row']:.4f} ns/row), table in {r['memory']}; from L2 "
            f"{r['l2_us_per_op']:.4f} us a gather; the k={k_lo} launch {r['launch_us']:.3f} us, "
            f"from L2 {r['l2_launch_us']:.3f} us; the launches break even at k = "
            f"{r['break_even_k']:.1f} (linear from k={k_lo}); the plan's launch (device = the L2 "
            f"line) {plan}")


def sweep_line(r: Dict[str, object]) -> str:
    """A line of ``probe_sweep``'s numbers."""
    return (f"select-sweep P={r['p']} ({SWEEP_TILE_ROWS}-row tile): {r['sweep_us_per_op']:.4f} "
            f"us/op; gather on the same tile: {r['gather_us_per_op']:.4f} us/op, sweep / "
            f"gather {r['sweep_us_per_op'] / r['gather_us_per_op']:.1f}x, from L2 "
            f"{r['l2_us_per_op']:.4f} us/op, outputs {'equal' if r['equal'] else 'DIFFER'}, "
            f"the sweep's table in {r['sweep_memory']}, the gather's in {r['memory']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device", file=sys.stderr)
        return 2
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    device = torch.device("cuda")
    card = card_line()
    for rows in CHECK_ROWS:
        print(f"gather rows={rows}: {'OK exact' if check_gather(rows, device) else 'WRONG'} "
              f"[{card}]")
    for rows in CHAIN_ROWS:
        print(f"gather chains rows={rows} ({staged_form(rows, LF)} from "
              f"k={stage_min_k(rows, LF)}): "
              f"{'OK exact' if check_chain(rows, device) else 'WRONG'} [{card}]", flush=True)
    for rows in LINE_ROWS:
        print(f"{chain_line(probe_chain(rows, reps, device))} [{card}]", flush=True)
    for p in SWEEP_SIZES:
        print(f"{sweep_line(probe_sweep(p, reps, device))} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
