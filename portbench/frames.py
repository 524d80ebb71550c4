"""The one generator of the benchmark's frames, driven by a traffic file.

A traffic file (``traffic/<mix>.json``) gives the frame size, the size of
the pool of distinct frames and a ``scene``: how many smooth gradients,
slow waves and moving discs a frame holds, how far the view pans from one
frame to the next and how much noise lies on top. Those counts are the same
for every seed; the seed draws only the colours, frequencies, positions and
the noise, so every seed asks for the same work.

The pool is made on the device from the seed in a few large calls (a
``torch.Generator`` on that device for the noise, numpy's ``default_rng``
for the handful of scene parameters) and comes back as host uint8 frames,
as a decoder would hand them over.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

# Frames made on the device at a time: bounds the float32 temporaries.
_CHUNK = 4


def scene_params(scene: Dict[str, Any], seed: int, h: int, w: int) -> Dict[str, np.ndarray]:
    """The seed's draw of the scene's parameters (host, float32)."""
    rng = np.random.default_rng(seed)
    n_waves, n_discs = int(scene["waves"]), int(scene["discs"])

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, size=shape).astype(np.float32)

    return {
        "base": u(48.0, 208.0, 3),
        "grad_x": u(-70.0, 70.0, 3),
        "grad_y": u(-70.0, 70.0, 3),
        "wave_f": u(0.4, 3.0, n_waves, 2),
        "wave_phase": u(0.0, 2 * math.pi, n_waves),
        "wave_speed": u(-0.08, 0.08, n_waves),
        "wave_amp": u(-28.0, 28.0, n_waves, 3),
        "disc_pos": u(0.0, 1.0, n_discs, 2) * np.array([w, h], np.float32),
        "disc_vel": u(-float(scene["disc_speed_px"]), float(scene["disc_speed_px"]), n_discs, 2),
        "disc_r": u(0.03, 0.16, n_discs) * h,
        "disc_color": u(0.0, 255.0, n_discs, 3),
        "disc_alpha": u(0.6, 1.0, n_discs),
    }


def _render(p: Dict[str, torch.Tensor], t: torch.Tensor, h: int, w: int,
            pan: torch.Tensor, noise_sigma: float, gen: torch.Generator) -> torch.Tensor:
    """Frames at times t (c,) as (c, h, w, 3) float32."""
    dev = t.device
    c = t.shape[0]
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    y = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    tt = t[:, None, None]
    gx = ((x + pan[0] * tt) / w - 0.5) * 2.0  # (c, 1, w): the panned view
    gy = ((y + pan[1] * tt) / h - 0.5) * 2.0  # (c, h, 1)
    img = (p["base"] + p["grad_x"] * gx[..., None] + p["grad_y"] * gy[..., None]
           ).expand(c, h, w, 3).clone()
    for k in range(p["wave_f"].shape[0]):
        phase = (2 * math.pi * (p["wave_f"][k, 0] * gx + p["wave_f"][k, 1] * gy)
                 + p["wave_phase"][k] + p["wave_speed"][k] * tt)
        img += torch.sin(phase)[..., None] * p["wave_amp"][k]
    for j in range(p["disc_pos"].shape[0]):
        r = p["disc_r"][j]
        span_x, span_y = w + 2 * r, h + 2 * r
        cx = torch.remainder(p["disc_pos"][j, 0] + p["disc_vel"][j, 0] * tt, span_x) - r
        cy = torch.remainder(p["disc_pos"][j, 1] + p["disc_vel"][j, 1] * tt, span_y) - r
        dist = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2)
        mask = ((r - dist) / 1.5 + 0.5).clamp(0.0, 1.0)[..., None] * p["disc_alpha"][j]
        img = img * (1.0 - mask) + p["disc_color"][j] * mask
    img += noise_sigma * torch.randn((c, h, w, 3), generator=gen, device=dev)
    return img


def make_pool(traffic: Dict[str, Any], seed: int, device: torch.device) -> np.ndarray:
    """The traffic's pool of distinct frames, (N, H, W, 3) host uint8."""
    h, w, n = int(traffic["height"]), int(traffic["width"]), int(traffic["pool"])
    scene = traffic["scene"]
    params = {k: torch.from_numpy(v).to(device)
              for k, v in scene_params(scene, seed, h, w).items()}
    pan = torch.tensor(scene["pan_px"], dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    pool = np.empty((n, h, w, 3), dtype=np.uint8)
    for lo in range(0, n, _CHUNK):
        t = torch.arange(lo, min(lo + _CHUNK, n), dtype=torch.float32, device=device)
        img = _render(params, t, h, w, pan, float(scene["noise_sigma"]), gen)
        pool[lo:lo + t.shape[0]] = img.clamp(0.0, 255.0).round().to(torch.uint8).cpu().numpy()
    return pool
