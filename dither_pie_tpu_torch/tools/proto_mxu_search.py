#!/usr/bin/env python3
"""Probe: the scored dense-palette search against the exact sweep, alone.

    python3 dither_pie_tpu_torch/tools/proto_mxu_search.py [pp] [iters]

The wavefront scan's palette search is linear in the palette size, and for
palettes of hundreds of colours it is the scan's whole time. The score form

    argmin_p |x - c_p|^2  ==  argmax_p (c_p . x - |c_p|^2 / 2)

is the alternative that ``dense_search="mxu"`` selects: the augmented
palette ``[r, g, b, -|c|^2/2]`` against ``[x_r, x_g, x_b, 1]``. This probe
runs both searches as two hand-written CUDA kernels
(``kernels/csrc/search_probe.cu``) over a synthetic working tile ``cur``
(R = 3*nb, lf) float32 with nb = 8 frames and lf = 1152 lanes, repeated
``iters`` times as the scan repeats it once a wavefront step, and prints

* the microseconds per row-step of both, ``time / (iters * nb)``, and the
  speed-up (the nb frames run on nb SMs side by side, so one repetition's
  latency is ``time / iters``);
* the flip fraction: the share of picks where the score form differs from
  the exact sweep. The two are the same function in real arithmetic; in
  float32 the score's terms reach 65,025 and 97,537.5 while the working
  values are not integers, so two colours whose distances differ by little
  can tie or swap. The flip fraction is the number that decides whether a
  faster score form (the tensor cores') may replace the exact search.

It is the port's counterpart of the JAX package's
``tools/proto_mxu_search.py``; with no arguments it probes 256 and 1024
colours. Each wrapper launches its kernel for a CUDA tensor and runs the
plain PyTorch version for a CPU tensor. The timing needs a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict

import numpy as np
import torch

if __name__ == "__main__":  # run as a script: find the package beside it
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from dither_pie_tpu_torch import convert  # noqa: E402
from dither_pie_tpu_torch.kernels import build  # noqa: E402

NB, LF = 8, 1152  # the 1080p-like tile of the packed scan: 8 frames, 1152 lanes
MAX_PALETTE = 1024  # the kernels keep the palette in shared memory


def probe_inputs(pp: int, nb: int = NB, lf: int = LF, seed: int = 0):
    """(cur (3*nb, lf) float32, palette (pp, 3) float32) as numpy arrays:
    random integer colours and a clipped normal working tile, the JAX
    probe's inputs."""
    rng = np.random.RandomState(seed)
    pal = rng.randint(0, 256, (pp, 3)).astype(np.float32)
    cur = np.clip(rng.normal(128, 60, (3 * nb, lf)), 0, 255).astype(np.float32)
    return cur, pal


def _first(values: torch.Tensor, extremum: torch.Tensor) -> torch.Tensor:
    """The least index along axis 0 whose value equals the extremum."""
    p = values.shape[0]
    iota = torch.arange(p, device=values.device)[:, None, None]
    return torch.where(values == extremum, iota, p).amin(0).to(torch.int32)


def search_exact_plain(cur: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch exact sweep: cur (3*nb, lf), palette (pp, 3) -> (nb, lf)
    int32, the first strict minimum over p of ``(dr*dr + dg*dg) + db*db``,
    one eager float32 op per step."""
    x = cur.view(3, 1, -1, cur.shape[1])  # (3, 1, nb, lf)
    diff = x - palette.t()[:, :, None, None]  # (3, pp, nb, lf)
    sq = diff * diff
    d2 = (sq[0] + sq[1]) + sq[2]
    return _first(d2, d2.amin(0))


def search_score_plain(cur: torch.Tensor, palette_aug: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch score form: cur (3*nb, lf), augmented palette (pp, 4)
    -> (nb, lf) int32, the first strict maximum over p of ``((r*x_r +
    g*x_g) + b*x_b) + n``, one eager float32 op per step (no matmul)."""
    x = cur.view(3, 1, -1, cur.shape[1])
    prod = palette_aug.t()[:3, :, None, None] * x  # (3, pp, nb, lf)
    score = ((prod[0] + prod[1]) + prod[2]) + palette_aug[:, 3, None, None]
    return _first(score, score.amax(0))


def _check(cur: torch.Tensor, palette: torch.Tensor, width: int) -> None:
    if cur.dtype != torch.float32 or cur.dim() != 2 or cur.shape[0] % 3:
        raise ValueError("cur must be a (3*nb, lf) float32 tile")
    if (palette.dtype != torch.float32 or palette.dim() != 2
            or palette.shape[1] != width or not 1 <= palette.shape[0] <= MAX_PALETTE):
        raise ValueError(f"palette must be (pp, {width}) float32, pp in 1..{MAX_PALETTE}")
    if palette.device != cur.device:
        raise ValueError(f"palette on {palette.device}, cur on {cur.device}")


def _launch(cur: torch.Tensor, palette: torch.Tensor, iters: int,
            score: bool) -> torch.Tensor:
    out = torch.empty((cur.shape[0] // 3, cur.shape[1]), dtype=torch.int32,
                      device=cur.device)
    build.extension().search_probe(cur.contiguous(), palette.contiguous(), out,
                                   iters, score)
    build.LAUNCHES["search_probe"] += 1
    return out


def search_exact(cur: torch.Tensor, palette: torch.Tensor, iters: int = 1) -> torch.Tensor:
    """The exact-sweep kernel on CUDA tensors (the search repeated ``iters``
    times in one launch), its plain version on CPU tensors."""
    _check(cur, palette, 3)
    if not build.on_cuda(cur):
        return search_exact_plain(cur, palette)
    return _launch(cur, palette, iters, score=False)


def search_score(cur: torch.Tensor, palette_aug: torch.Tensor,
                 iters: int = 1) -> torch.Tensor:
    """The score-form kernel on CUDA tensors, its plain version on CPU
    tensors; ``palette_aug`` from ``convert.augment_palette``."""
    _check(cur, palette_aug, 4)
    if not build.on_cuda(cur):
        return search_score_plain(cur, palette_aug)
    return _launch(cur, palette_aug, iters, score=True)


def flip_fraction(exact: torch.Tensor, score: torch.Tensor) -> float:
    return float((exact != score).to(torch.float64).mean().item())


def _cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() between CUDA events, after one warm-up."""
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
    return statistics.median(times)


def probe(pp: int, iters: int, device) -> Dict[str, float]:
    """Run both kernels on ``device`` (a CUDA device) at ``pp`` colours:
    their times, microseconds per row-step and the flip fraction of score
    against exact."""
    cur_np, pal_np = probe_inputs(pp)
    cur = torch.from_numpy(cur_np).to(device)
    pal = torch.from_numpy(pal_np).to(device)
    aug = convert.augment_palette(pal)
    exact_ms = _cuda_ms(lambda: search_exact(cur, pal, iters))
    score_ms = _cuda_ms(lambda: search_score(cur, aug, iters))
    flips = flip_fraction(search_exact(cur, pal, iters), search_score(cur, aug, iters))
    steps = iters * NB
    return {"pp": pp, "iters": iters, "exact_ms": exact_ms, "score_ms": score_ms,
            "exact_us_per_row_step": exact_ms * 1e3 / steps,
            "score_us_per_row_step": score_ms * 1e3 / steps,
            "flip_fraction": flips}


def main() -> int:
    if not torch.cuda.is_available():
        print("proto_mxu_search: no CUDA device", file=sys.stderr)
        return 2
    sizes = [int(sys.argv[1])] if len(sys.argv) > 1 else [256, 1024]
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for pp in sizes:
        r = probe(pp, iters, torch.device("cuda"))
        print(f"pp={pp} lf={LF} iters={iters} [{card}]")
        print(f"exact: {r['exact_us_per_row_step']:8.3f} us/row-step   score: "
              f"{r['score_us_per_row_step']:8.3f} us/row-step   speedup "
              f"{r['exact_ms'] / r['score_ms']:.2f}x")
        print(f"argmin flip fraction vs exact: {r['flip_fraction']:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
