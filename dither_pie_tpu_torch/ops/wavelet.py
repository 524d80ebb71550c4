"""Wavelet-dither support: a single-level 2-D DWT / IDWT, the port of
``dither_pie_tpu/ops/wavelet.py``.

The filter banks (the published Daubechies / Symlet / Coiflet / biorthogonal
spline scaling coefficients, the other three filters by the quadrature
mirror relations) and the float64 numpy transform are host code and are
copied unchanged. Conventions are pywt's defaults (mode "symmetric", one
level): ``out_len = (n + L - 1) // 2``, and the caller crops the inverse
transform back to (h, w).

``dwt2`` / ``idwt2`` on tensors compute what the JAX package's
``dwt2_jnp`` / ``idwt2_jnp`` compute, over any leading dimensions at once
(the wavelet strategy hands over (B, 3, H, W) planes). Each filter is
written as a sum of its L <= 8 taps: a shifted, strided slice times one
float32 scalar, added in tap order, every multiply and every add an eager
float32 op of its own. No convolution routine is called, so no TF32 path
and no library state can enter, nothing is contracted into a multiply-add,
and the card and the CPU give the same bits. Taps that are exactly zero
(the biorthogonal banks are padded with them) are skipped.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

_SQRT2 = float(np.sqrt(2.0))

# Scaling (lowpass reconstruction) filters, lowest-index-first.
_REC_LO: Dict[str, np.ndarray] = {
    "haar": np.array([1.0, 1.0]) / _SQRT2,
    "db1": np.array([1.0, 1.0]) / _SQRT2,
    "db2": np.array([
        0.48296291314469025, 0.8365163037378079,
        0.22414386804185735, -0.12940952255092145,
    ]),
    "db4": np.array([
        0.23037781330885523, 0.7148465705525415, 0.6308807679295904,
        -0.02798376941698385, -0.18703481171888114, 0.030841381835986965,
        0.032883011666982945, -0.010597401784997278,
    ]),
    "sym2": np.array([
        0.48296291314469025, 0.8365163037378079,
        0.22414386804185735, -0.12940952255092145,
    ]),
    "sym4": np.array([
        0.03222310060404270, -0.012603967262037833, -0.09921954357684722,
        0.29785779560527736, 0.8037387518059161, 0.49761866763201545,
        -0.02963552764599851, -0.07576571478927333,
    ]),
    "coif1": np.array([
        -0.01565572813546454, -0.0727326195128539, 0.38486484686420286,
        0.8525720202122554, 0.3378976624578092, -0.0727326195128539,
    ]),
}

# Biorthogonal pairs need distinct analysis/synthesis lowpass filters.
_BIOR: Dict[str, Tuple[np.ndarray, np.ndarray]] = {
    # name: (dec_lo, rec_lo)
    "bior1.3": (
        np.array([-0.08838834764831845, 0.08838834764831845,
                  0.7071067811865476, 0.7071067811865476,
                  0.08838834764831845, -0.08838834764831845]),
        np.array([0.0, 0.0, 0.7071067811865476, 0.7071067811865476, 0.0, 0.0]),
    ),
    "bior2.2": (
        np.array([0.0, -0.1767766952966369, 0.3535533905932738,
                  1.0606601717798214, 0.3535533905932738, -0.1767766952966369]),
        np.array([0.0, 0.3535533905932738, 0.7071067811865476,
                  0.3535533905932738, 0.0, 0.0]),
    ),
}

WAVELET_CHOICES = ["haar", "db1", "db2", "db4", "sym2", "sym4", "coif1", "bior1.3", "bior2.2"]


@functools.lru_cache(maxsize=None)
def filter_bank(name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(dec_lo, dec_hi, rec_lo, rec_hi), each float64 lowest-index-first."""
    if name in _BIOR:
        dec_lo, rec_lo = _BIOR[name]
        n = len(dec_lo)
        k = np.arange(n)
        # Standard biorthogonal QMF relations (pywt convention).
        dec_hi = ((-1.0) ** (k + 1)) * rec_lo
        rec_hi = ((-1.0) ** k) * dec_lo
        return dec_lo, dec_hi, rec_lo, rec_hi
    if name not in _REC_LO:
        raise ValueError(f"unknown wavelet '{name}' (choices: {WAVELET_CHOICES})")
    rec_lo = _REC_LO[name]
    n = len(rec_lo)
    k = np.arange(n)
    dec_lo = rec_lo[::-1].copy()
    dec_hi = ((-1.0) ** (k + 1)) * rec_lo
    rec_hi = ((-1.0) ** k) * dec_lo
    return dec_lo, dec_hi, rec_lo, rec_hi


def _dwt1d_np(x: np.ndarray, dec: np.ndarray, axis: int) -> np.ndarray:
    """Single-axis DWT: symmetric (half-point) extension by L-1 each side,
    full convolution with the analysis filter, downsample at indices
    L, L+2, ... (pywt layout: out_len = floor((n + L - 1) / 2))."""
    x = np.moveaxis(x, axis, -1)
    n = x.shape[-1]
    L = len(dec)
    left = x[..., : L - 1][..., ::-1]
    right = x[..., -(L - 1):][..., ::-1]
    ext = np.concatenate([left, x, right], axis=-1)
    full = np.apply_along_axis(lambda v: np.convolve(v, dec, mode="full"), -1, ext)
    out_len = (n + L - 1) // 2
    idx = L + 2 * np.arange(out_len)
    sel = np.take(full, idx, axis=-1)
    return np.moveaxis(sel, -1, axis)


def dwt2_np(a: np.ndarray, name: str):
    """Single-level 2-D DWT -> (cA, (cH, cV, cD)); float64, pywt-style."""
    dec_lo, dec_hi, _, _ = filter_bank(name)
    a = np.asarray(a, dtype=np.float64)
    lo = _dwt1d_np(a, dec_lo, axis=0)
    hi = _dwt1d_np(a, dec_hi, axis=0)
    cA = _dwt1d_np(lo, dec_lo, axis=1)
    cH = _dwt1d_np(hi, dec_lo, axis=1)
    cV = _dwt1d_np(lo, dec_hi, axis=1)
    cD = _dwt1d_np(hi, dec_hi, axis=1)
    return cA, (cH, cV, cD)


def _idwt1d_np(lo: np.ndarray, hi: np.ndarray, rec_lo: np.ndarray,
               rec_hi: np.ndarray, axis: int) -> np.ndarray:
    lo = np.moveaxis(lo, axis, -1)
    hi = np.moveaxis(hi, axis, -1)
    m = lo.shape[-1]
    L = len(rec_lo)
    # Upsample (zeros at odd positions), full convolve, crop L-2 each side.
    up_shape = lo.shape[:-1] + (2 * m,)
    ulo = np.zeros(up_shape)
    uhi = np.zeros(up_shape)
    ulo[..., ::2] = lo
    uhi[..., ::2] = hi
    rec = (np.apply_along_axis(lambda v: np.convolve(v, rec_lo, mode="full"), -1, ulo)
           + np.apply_along_axis(lambda v: np.convolve(v, rec_hi, mode="full"), -1, uhi))
    # Standard idwt length 2m - L + 2: crop L-2 from the left.
    out = rec[..., L - 2: L - 2 + 2 * m - L + 2] if L > 2 else rec[..., : 2 * m]
    return np.moveaxis(out, -1, axis)


def idwt2_np(cA, cHVD, name: str) -> np.ndarray:
    cH, cV, cD = cHVD
    _, _, rec_lo, rec_hi = filter_bank(name)
    lo = _idwt1d_np(np.asarray(cA, np.float64), np.asarray(cV, np.float64), rec_lo, rec_hi, axis=1)
    hi = _idwt1d_np(np.asarray(cH, np.float64), np.asarray(cD, np.float64), rec_lo, rec_hi, axis=1)
    return _idwt1d_np(lo, hi, rec_lo, rec_hi, axis=0)


# ---------------------------------------------------------------------------
# Tensor twins: the wavelet strategy's transform, on the tensor's device.
# ---------------------------------------------------------------------------


def _cut(x: torch.Tensor, dim: int, start: int, stop: int, step: int = 1) -> torch.Tensor:
    """``x[..., start:stop:step, ...]`` along ``dim`` (a view)."""
    index = [slice(None)] * x.dim()
    index[dim] = slice(start, stop, step)
    return x[tuple(index)]


def _tap_sum(x: torch.Tensor, taps: Sequence[float], dim: int, starts: Sequence[int],
             length: int, step: int) -> torch.Tensor:
    """``sum_j taps[j] * x[starts[j] : starts[j] + step*length : step]``
    along ``dim``, in tap order, one float32 multiply and one float32 add a
    tap; taps equal to zero are skipped."""
    acc = None
    for tap, start in zip(taps, starts):
        tap = float(np.float32(tap))  # the float32 tap, exactly
        if tap == 0.0:
            continue
        term = _cut(x, dim, start, start + step * length, step) * tap
        acc = term if acc is None else acc + term
    if acc is None:
        shape = list(x.shape)
        shape[dim] = length
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    return acc


def _dwt1d(x: torch.Tensor, dec: np.ndarray, dim: int) -> torch.Tensor:
    """Single-axis DWT along ``dim``: symmetric half-point extension by
    L - 1, the full convolution's phase ``out[1::2][:out_len]``."""
    n = x.shape[dim]
    L = len(dec)
    left = _cut(x, dim, 0, L - 1).flip(dim)
    right = _cut(x, dim, max(n - (L - 1), 0), n).flip(dim)
    ext = torch.cat([left, x, right], dim=dim)
    out_len = (n + L - 1) // 2
    # out[1 + 2m] = sum_j ext[1 + 2m + j] * dec[L - 1 - j]
    return _tap_sum(ext, dec[::-1], dim, [1 + j for j in range(L)], out_len, 2)


def dwt2(a: torch.Tensor, name: str):
    """Single-level 2-D DWT of the last two dimensions of a float32 tensor
    (..., H, W) -> (cA, (cH, cV, cD)), each (..., (H+L-1)//2, (W+L-1)//2)."""
    if a.dtype != torch.float32 or a.dim() < 2:
        raise ValueError("dwt2 takes a float32 tensor of (..., H, W)")
    dec_lo, dec_hi, _, _ = filter_bank(name)
    lo = _dwt1d(a, dec_lo, -2)
    hi = _dwt1d(a, dec_hi, -2)
    return (_dwt1d(lo, dec_lo, -1),
            (_dwt1d(hi, dec_lo, -1),
             _dwt1d(lo, dec_hi, -1),
             _dwt1d(hi, dec_hi, -1)))


def _idwt1d(lo: torch.Tensor, hi: torch.Tensor, rec_lo: np.ndarray,
            rec_hi: np.ndarray, dim: int) -> torch.Tensor:
    """Single-axis inverse along ``dim``: zero-stuffing, the full
    convolution with each synthesis filter, the two added, cropped by
    L - 2 to the length 2m - L + 2."""
    m = lo.shape[dim]
    L = len(rec_lo)
    out_n = 2 * m - L + 2
    # rec[t] = sum_j up[t - j] * f[j] with up padded by L - 1 zeros each
    # side; the crop starts at t = L - 2, so tap j reads from 2L - 3 - j.
    starts = [2 * L - 3 - j for j in range(L)]

    def conv(sub: torch.Tensor, filt: np.ndarray) -> torch.Tensor:
        shape = list(sub.shape)
        shape[dim] = 2 * m + 2 * (L - 1)
        up = torch.zeros(shape, dtype=sub.dtype, device=sub.device)
        _cut(up, dim, L - 1, L - 1 + 2 * m, 2).copy_(sub)
        return _tap_sum(up, filt, dim, starts, out_n, 1)

    return conv(lo, rec_lo) + conv(hi, rec_hi)


def idwt2(cA: torch.Tensor, cHVD, name: str) -> torch.Tensor:
    """Inverse of ``dwt2``: (..., 2m_h - L + 2, 2m_w - L + 2); the caller
    crops it to the image."""
    cH, cV, cD = cHVD
    _, _, rec_lo, rec_hi = filter_bank(name)
    lo = _idwt1d(cA, cV, rec_lo, rec_hi, -1)
    hi = _idwt1d(cH, cD, rec_lo, rec_hi, -1)
    return _idwt1d(lo, hi, rec_lo, rec_hi, -2)
