#!/usr/bin/env python3
"""Probe: the scored dense-palette search against the exact sweep, alone.

    python3 dither_pie_tpu_torch/tools/proto_mxu_search.py [pp] [iters]

The wavefront scan's palette search is linear in the palette size, and for
palettes of hundreds of colours it is the scan's whole time. The score form

    argmin_p |x - c_p|^2  ==  argmax_p (c_p . x - |c_p|^2 / 2)

is the alternative that ``dense_search="mxu"`` selects: the augmented
palette ``[r, g, b, -|c|^2/2]`` against ``[x_r, x_g, x_b, 1]``. This probe
runs both searches as hand-written CUDA kernels
(``kernels/csrc/search_probe.cu``) over a working tile ``cur`` (R = 3*nb,
lf) float32 with nb = 8 frames and lf = 1152 lanes, repeated ``iters``
times as the scan repeats it once a wavefront step, in the scan's shape:
one frame over a cluster of n blocks, each searching a slice of the
palette, merged in rank order (n from ``ops.wavefront.cluster_size_for``
unless given). It prints

* the microseconds a repetition of both at every n in (1, 2, 4, 8) and
  the fit of that time to c_n + k * P / n over P in (64, 256, 1024), the
  scan's step model without its fold and error (``time / iters``: the nb
  frames run side by side);
* the flip fraction on two input sets: the share of picks where the score
  form differs from the exact sweep. The two are the same function in real
  arithmetic; in float32 the score's terms reach 65,025 and 97,537.5 while
  the working values are not integers, so two colours whose distances
  differ by little can tie or swap. ``probe_inputs`` are the JAX probe's
  (random integer colours, a clipped normal tile); ``kmeans_inputs`` a
  k-means palette of a synthetic photo-like frame (the port's
  ``kmeans_palette``) and that frame's pixels plus the error that
  Floyd-Steinberg carries in from their quantised neighbours, the values a
  scan searches. The flip fraction is the number that decides whether a
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
from typing import Dict, Optional

import numpy as np
import torch

if __name__ == "__main__":  # run as a script: find the package beside it
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from dither_pie_tpu_torch import convert  # noqa: E402
from dither_pie_tpu_torch.core import palette as _palette  # noqa: E402
from dither_pie_tpu_torch.kernels import build  # noqa: E402
from dither_pie_tpu_torch.ops import wavefront as _wf  # noqa: E402

NB, LF = 8, 1152  # the 1080p-like tile of the packed scan: 8 frames, 1152 lanes
MAX_PALETTE = 1024  # the kernels keep the palette in shared memory
SWEEP_SIZES = (64, 256, 1024)  # palette sizes of the n sweep and its fit
# Floyd-Steinberg's four entries (dx, dy, weight): what a pixel's working
# value folds in from its neighbours.
_FS = ((1, 0, 7 / 16), (-1, 1, 3 / 16), (0, 1, 5 / 16), (1, 1, 1 / 16))


def probe_inputs(pp: int, nb: int = NB, lf: int = LF, seed: int = 0):
    """(cur (3*nb, lf) float32, palette (pp, 3) float32) as numpy arrays:
    random integer colours and a clipped normal working tile, the JAX
    probe's inputs."""
    rng = np.random.RandomState(seed)
    pal = rng.randint(0, 256, (pp, 3)).astype(np.float32)
    cur = np.clip(rng.normal(128, 60, (3 * nb, lf)), 0, 255).astype(np.float32)
    return cur, pal


def synth_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Photo-like synthetic (h, w, 3) uint8 frame: smooth gradients, blobs
    and noise, the JAX package's benchmark frame (``bench.synth_image``)."""
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


def kmeans_inputs(pp: int, nb: int = NB, lf: int = LF, seed: int = 0,
                  device="cpu"):
    """(cur (3*nb, lf) float32, palette (pp, 3) float32) as numpy arrays:
    the port's k-means palette of pp colours (fitted on ``device``) of a
    ``synth_image`` frame of lf rows, and for frame b the column x = 64 +
    64*b of that frame, lane y its row: the pixel plus what Floyd-Steinberg
    carries in from its four earlier neighbours, each neighbour's error
    that of its own pixel against its nearest palette colour, clamped to
    0..255 as the fixed mode clamps. Non-integer values, as the scan
    searches them."""
    frame = synth_image(lf, 64 * (nb + 2), seed)
    pal = np.asarray(_palette.kmeans_palette(frame, pp, random_state=seed, device=device),
                     np.float32)
    img = frame.astype(np.float32)

    def err(x):  # (lf, 3): column x against its nearest colours
        d2 = ((img[:, x, None, :] - pal) ** 2).sum(-1)  # exact: integers
        return img[:, x] - pal[d2.argmin(-1)]

    cur = np.empty((3, nb, lf), np.float32)
    rows = np.arange(lf)
    for b in range(nb):
        x = 64 + 64 * b
        acc = img[:, x].copy()
        for dx, dy, wk in _FS:
            src = np.clip(rows - dy, 0, None)
            carried = err(x - dx)[src] * np.float32(wk)
            acc += np.where((rows >= dy)[:, None], carried, np.float32(0))
        cur[:, b] = np.clip(acc, 0, 255).T
    return cur.reshape(3 * nb, lf), pal


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


def probe_cluster_size(pp: int, n: Optional[int] = None) -> int:
    """Blocks a frame of a probe launch: ``n`` if given (one of the scan's
    cluster sizes, at most pp), else the scan's table for pp colours (the
    probe's nb = 8 clusters of up to 8 blocks are resident together)."""
    n = _wf.cluster_size_for(pp) if n is None else n
    if n not in _wf.CLUSTER_SIZES or n > pp:
        raise ValueError(f"cluster size {n} not one of {_wf.CLUSTER_SIZES} up to {pp}")
    return n


def _launch(cur: torch.Tensor, palette: torch.Tensor, iters: int, score: bool,
            n: Optional[int]) -> torch.Tensor:
    pp = palette.shape[0]
    n = probe_cluster_size(pp, n)
    out = torch.empty((cur.shape[0] // 3, cur.shape[1]), dtype=torch.int32,
                      device=cur.device)
    build.extension().search_probe(cur.contiguous(), palette.contiguous(), out,
                                   iters, score, n, list(_wf.palette_slices(pp, n)))
    build.count_launch("search_probe")
    return out


def search_exact(cur: torch.Tensor, palette: torch.Tensor, iters: int = 1,
                 n: Optional[int] = None) -> torch.Tensor:
    """The exact-sweep kernel on CUDA tensors (the search repeated ``iters``
    times in one launch, a frame over ``n`` blocks: ``probe_cluster_size``),
    its plain version on CPU tensors."""
    _check(cur, palette, 3)
    if not build.on_cuda(cur):
        return search_exact_plain(cur, palette)
    return _launch(cur, palette, iters, False, n)


def search_score(cur: torch.Tensor, palette_aug: torch.Tensor,
                 iters: int = 1, n: Optional[int] = None) -> torch.Tensor:
    """The score-form kernel on CUDA tensors, its plain version on CPU
    tensors; ``palette_aug`` from ``convert.augment_palette``."""
    _check(cur, palette_aug, 4)
    if not build.on_cuda(cur):
        return search_score_plain(cur, palette_aug)
    return _launch(cur, palette_aug, iters, True, n)


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


def card_line() -> str:
    """The card's ``name, power.limit`` as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def fit_step(times: Dict[int, Dict[int, float]]):
    """Least-squares fit of ``times[n][P]`` (us a repetition) to c_n + k *
    P / n with one slope k and an intercept c_n per n: (k, {n: c_n}, the
    largest residual)."""
    ns = sorted(times)
    pts = [(n, p / n, t) for n in ns for p, t in times[n].items()]
    a = np.zeros((len(pts), 1 + len(ns)))
    for row, (n, x, _) in enumerate(pts):
        a[row, 0] = x
        a[row, 1 + ns.index(n)] = 1.0
    y = np.array([t for _, _, t in pts])
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    return float(coef[0]), {n: float(coef[1 + i]) for i, n in enumerate(ns)}, \
        float(np.abs(a @ coef - y).max())


def sweep(iters: int, device, sizes=SWEEP_SIZES) -> Dict[str, object]:
    """Both kernels at every cluster size n in (1, 2, 4, 8) and P in
    ``sizes`` on the random inputs, each output held to the n = 1 output
    bitwise: microseconds a repetition (one launch of ``iters``
    repetitions, CUDA events) and the exact form's fit c_n + k * P / n."""
    us = {"exact": {}, "score": {}}
    for pp in sizes:
        cur_np, pal_np = probe_inputs(pp)
        cur = torch.from_numpy(cur_np).to(device)
        pal = torch.from_numpy(pal_np).to(device)
        aug = convert.augment_palette(pal)
        for form, fn, arg in (("exact", search_exact, pal), ("score", search_score, aug)):
            ref = fn(cur, arg, iters, 1)
            for n in _wf.CLUSTER_SIZES:
                if not torch.equal(fn(cur, arg, iters, n), ref):
                    raise RuntimeError(f"search probe {form} pp={pp}: n={n} != n=1")
                us[form].setdefault(n, {})[pp] = (
                    _cuda_ms(lambda: fn(cur, arg, iters, n)) * 1e3 / iters)
    k, c, resid = fit_step(us["exact"])
    return {"us_per_rep": us, "fit": {"k_us": k, "c_us": c, "max_residual_us": resid}}


def probe(pp: int, iters: int, device) -> Dict[str, float]:
    """Run both kernels on ``device`` (a CUDA device) at ``pp`` colours with
    the plan's cluster size: their times (one launch of ``iters``
    repetitions), microseconds a repetition and a row-step, and the flip
    fraction of score against exact on the random and the k-means inputs
    (the k-means palette fitted on ``device``)."""
    cur_np, pal_np = probe_inputs(pp)
    cur = torch.from_numpy(cur_np).to(device)
    pal = torch.from_numpy(pal_np).to(device)
    aug = convert.augment_palette(pal)
    exact_ms = _cuda_ms(lambda: search_exact(cur, pal, iters))
    score_ms = _cuda_ms(lambda: search_score(cur, aug, iters))
    flips = flip_fraction(search_exact(cur, pal, iters), search_score(cur, aug, iters))
    km_cur, km_pal = (torch.from_numpy(a).to(device)
                      for a in kmeans_inputs(pp, device=device))
    km_flips = flip_fraction(search_exact(km_cur, km_pal),
                             search_score(km_cur, convert.augment_palette(km_pal)))
    return {"pp": pp, "iters": iters, "n": probe_cluster_size(pp),
            "exact_ms": exact_ms, "score_ms": score_ms,
            "exact_us_per_rep": exact_ms * 1e3 / iters,
            "score_us_per_rep": score_ms * 1e3 / iters,
            "exact_us_per_row_step": exact_ms * 1e3 / (iters * NB),
            "score_us_per_row_step": score_ms * 1e3 / (iters * NB),
            "flip_fraction": flips, "flip_fraction_kmeans": km_flips}


def main() -> int:
    if not torch.cuda.is_available():
        print("proto_mxu_search: no CUDA device", file=sys.stderr)
        return 2
    sizes = [int(sys.argv[1])] if len(sys.argv) > 1 else [256, 1024]
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    card = card_line()
    dev = torch.device("cuda")
    for pp in sizes:
        r = probe(pp, iters, dev)
        print(f"pp={pp} lf={LF} iters={iters} n={r['n']} [{card}]")
        print(f"exact: {r['exact_us_per_rep']:8.3f} us a repetition   score: "
              f"{r['score_us_per_rep']:8.3f} us a repetition   speedup "
              f"{r['exact_ms'] / r['score_ms']:.2f}x")
        print(f"flip fraction of score against exact: random inputs "
              f"{r['flip_fraction']:.6f}, k-means inputs {r['flip_fraction_kmeans']:.6f}")
    sw = sweep(iters, dev)
    for form, by_n in sw["us_per_rep"].items():
        print(f"{form}, us a repetition by n: " + "; ".join(
            f"n={n} " + ", ".join(f"P={p} {t:.3f}" for p, t in by_p.items())
            for n, by_p in by_n.items()) + f" [{card}]")
    fit = sw["fit"]
    print(f"fit (exact): c_n + k * P / n, k = {fit['k_us']:.5f} us, " + ", ".join(
        f"c_{n} = {c:.4f} us" for n, c in fit["c_us"].items())
        + f" (largest residual {fit['max_residual_us']:.4f} us) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
