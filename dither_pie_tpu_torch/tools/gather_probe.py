#!/usr/bin/env python3
"""Probe: a per-lane table gather against the select sweep, alone.

    python3 dither_pie_tpu_torch/tools/gather_probe.py [reps]

The wavefront scan's palette search sweeps every colour for every pixel.
An exact two-stage search (RGB-grid cell -> the cell's list of candidate
colours -> exact refine) would replace the sweep by a fetch of the pixel's
own candidates: ``out[r, l] = table[idx[r, l], l]``. This probe measures
what such a fetch costs beside the sweep, with two hand-written CUDA
kernels (``kernels/csrc/gather_probe.cu``), one thread an element:

* the gather alone, held to ``np.take_along_axis``, at tables of 64, 512
  and 4096 rows of 128 lanes (``gather rows=...: OK exact``);
* a chain of k dependent gathers, ``acc = |table[acc, l] + step| mod rows``,
  at tables of 256 to 16384 rows: microseconds a gather and nanoseconds a
  row, from a launch of k = 4 + 64*reps against one of k = 4 (the launch and
  the staging of the table cancel). The table lies in shared memory where
  it fits a block's 227 KB, in device memory (L2) above; the line says
  which;
* the select sweep over the P rows of a table on an (8, 128) tile (one
  block of 1024 threads: the scan's situation, one SM a frame),
  ``best = where((acc & (P-1)) == p, table[p], best)`` for every p, then
  ``acc = |best + acc + step| mod 255``, at P = 64, 256 and 1024, and
  beside it the gather chain on the same tile and table with the same
  update, whose output must equal the sweep's bit for bit. Their ratio is
  what a thread's own fetch saves over a sweep of P selects.

It is the port's counterpart of the JAX package's ``tools/gather_probe.py``.
Each wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor. The timing needs a CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

if __name__ == "__main__":  # run as a script: find the package beside it
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from dither_pie_tpu_torch.kernels import build  # noqa: E402
from dither_pie_tpu_torch.tools.proto_mxu_search import _cuda_ms, card_line  # noqa: E402

LF = 128  # lanes of every table and tile
SMEM_BYTES = 227 * 1024  # dynamic shared memory a block may opt in to
CHECK_ROWS = (64, 512, 4096)
CHAIN_ROWS = (256, 1024, 4096, 16384)
SWEEP_SIZES = (64, 256, 1024)
SWEEP_TILE_ROWS = 8
CHAIN_K = (4, 64)  # k = 4 against k = 4 + 64*reps
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
    """Whether the kernels stage this table in shared memory."""
    return table.numel() * 4 <= SMEM_BYTES


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


def gather_chain(table: torch.Tensor, idx: torch.Tensor, k: int = 1,
                 update: str = "none") -> torch.Tensor:
    """The gather kernel on CUDA tensors, its plain version on CPU tensors.

    ``table`` (rows, lanes) int32, ``idx`` (n, lanes) int32 -> (n, lanes)
    int32. ``update`` "none": ``table[idx, l]`` (k = 1); "chain": k times
    ``acc = |table[acc, l] + step| mod rows``; "sweep": k times
    ``acc = |table[acc & (rows-1), l] + acc + step| mod 255``, the select
    sweep's update with the fetch done by one load. Start values outside
    0..rows-1 are an error ("none", "chain"): ``torch.gather`` raises for
    them on the CPU, the kernel asserts on the card."""
    if update not in UPDATES:
        raise ValueError(f"update must be one of {UPDATES}, got {update!r}")
    if update == "none" and k != 1:
        raise ValueError('update "none" is one gather: k must be 1')
    _check(table, idx, k, power_of_two=update == "sweep")
    if not build.on_cuda(table):
        return gather_chain_plain(table, idx, k, update)
    out = torch.empty_like(idx)
    build.extension().gather_chain(table.contiguous(), idx.contiguous(), out, k,
                                   UPDATES.index(update), table_in_smem(table))
    build.LAUNCHES["gather_probe"] += 1
    return out


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
    build.LAUNCHES["gather_probe_sweep"] += 1
    return out


def _per_op_us(fn, k_lo: int, span: int, reps: int) -> float:
    """Microseconds a step of ``fn(k)``: the median time of k = k_lo +
    span*reps less that of k = k_lo, over the steps between."""
    hi = _cuda_ms(lambda: fn(k_lo + span * reps), 7)
    lo = _cuda_ms(lambda: fn(k_lo), 7)
    return max(hi - lo, 1e-9) * 1e3 / (span * reps)


def _memory(table: torch.Tensor) -> str:
    return "shared memory" if table_in_smem(table) else "device memory"


def check_gather(rows: int, device) -> bool:
    """The gather alone on ``device`` against ``np.take_along_axis``."""
    tbl, idx = gather_inputs(rows)
    out = gather_chain(torch.from_numpy(tbl).to(device), torch.from_numpy(idx).to(device))
    return bool(np.array_equal(out.cpu().numpy(), np.take_along_axis(tbl, idx, axis=0)))


def probe_chain(rows: int, reps: int, device) -> Dict[str, object]:
    """Microseconds a dependent gather at a table of ``rows`` rows."""
    tbl, idx = (torch.from_numpy(a).to(device) for a in chain_inputs(rows))
    per = _per_op_us(lambda k: gather_chain(tbl, idx, k, "chain"), *CHAIN_K, reps)
    return {"rows": rows, "us_per_op": per, "ns_per_row": per * 1e3 / rows,
            "memory": _memory(tbl)}


def probe_sweep(p: int, reps: int, device) -> Dict[str, object]:
    """The select sweep over ``p`` rows and the gather chain with the same
    update, on the same (8, 128) tile: microseconds a step of each, and
    whether their outputs are equal."""
    tbl, idx = (torch.from_numpy(a).to(device) for a in sweep_inputs(p))
    k_lo, span = SWEEP_K
    k_hi = k_lo + span * reps
    equal = bool(torch.equal(sweep_chain(tbl, idx, k_hi),
                             gather_chain(tbl, idx, k_hi, "sweep")))
    sweep_us = _per_op_us(lambda k: sweep_chain(tbl, idx, k), k_lo, span, reps)
    gather_us = _per_op_us(lambda k: gather_chain(tbl, idx, k, "sweep"), k_lo, span, reps)
    return {"p": p, "sweep_us_per_op": sweep_us, "gather_us_per_op": gather_us,
            "equal": equal, "memory": _memory(tbl)}


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
        r = probe_chain(rows, reps, device)
        print(f"gather rows={rows}: {r['us_per_op']:.4f} us/op ({r['ns_per_row']:.4f} ns/row), "
              f"table in {r['memory']} [{card}]")
    for p in SWEEP_SIZES:
        r = probe_sweep(p, reps, device)
        print(f"select-sweep P={p} ({SWEEP_TILE_ROWS}-row tile): {r['sweep_us_per_op']:.4f} "
              f"us/op; gather on the same tile: {r['gather_us_per_op']:.4f} us/op, sweep / "
              f"gather {r['sweep_us_per_op'] / r['gather_us_per_op']:.1f}x, outputs "
              f"{'equal' if r['equal'] else 'DIFFER'}, table in {r['memory']} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
