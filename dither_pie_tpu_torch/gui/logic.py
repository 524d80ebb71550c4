"""The GUI's pure functions, without tkinter: parameter clamping for the
dither settings dialog and the pixelization editor's cell-centre sampling.

``widgets.py`` re-exports them under the JAX package's names
(``dither_pie_tpu/gui/widgets.py``), and the view-model imports them from
here, so a machine without Tk can drive the view-model.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
from PIL import Image

from dither_pie_tpu_torch.utils import compute_even_dimensions


def clamp_parameters(param_info: Dict[str, Any],
                     raw: Dict[str, Any]) -> Dict[str, Any]:
    """Parse + clamp raw string values against parameter metadata:
    ints/floats clamp to [min, max]; invalid strings fall back to the
    default; choices must be members of the choice list."""
    out: Dict[str, Any] = {}
    for key, info in param_info.items():
        val = raw.get(key, info["default"])
        if info["type"] == "int":
            try:
                v = int(float(val))
            except (TypeError, ValueError):
                v = info["default"]
            v = max(info.get("min", v), min(info.get("max", v), v))
            out[key] = v
        elif info["type"] == "float":
            try:
                v = float(val)
            except (TypeError, ValueError):
                v = info["default"]
            v = max(info.get("min", v), min(info.get("max", v), v))
            out[key] = v
        else:  # choice
            sval = str(val)
            out[key] = sval if sval in [str(c) for c in info["choices"]] \
                else info["default"]
    return out


def sample_grid_from_image(image: Image.Image, target_size: int) -> np.ndarray:
    """Sample the image at cell centers into an even-dimension grid
    (the pixelize-from-view behaviour)."""
    w, h = image.size
    tw, th = compute_even_dimensions(w, h, target_size)
    arr = np.asarray(image.convert("RGB"))
    ys = ((np.arange(th) + 0.5) * h / th).astype(int).clip(0, h - 1)
    xs = ((np.arange(tw) + 0.5) * w / tw).astype(int).clip(0, w - 1)
    return arr[ys[:, None], xs[None, :]]


def sample_grid_with_geometry(image: Image.Image,
                              grid_dims: Tuple[int, int],
                              cell_size: Tuple[float, float],
                              grid_offset: Tuple[float, float] = (0.0, 0.0)
                              ) -> np.ndarray:
    """Sample cell centers of an arbitrarily scaled/offset sampling grid
    (the editor's Alt-adjusted grid). ``grid_dims`` = (tw, th) cells,
    ``cell_size`` = (cw, ch) source pixels per cell, ``grid_offset`` in
    source pixels. Out-of-image cells clamp to the border (the grid can
    overhang). With scale 1 and offset 0 this equals
    ``sample_grid_from_image``."""
    tw, th = grid_dims
    cw, ch = cell_size
    ox, oy = grid_offset
    w, h = image.size
    arr = np.asarray(image.convert("RGB"))
    ys = np.floor((np.arange(th) + 0.5) * ch + oy).astype(int).clip(0, h - 1)
    xs = np.floor((np.arange(tw) + 0.5) * cw + ox).astype(int).clip(0, w - 1)
    return arr[ys[:, None], xs[None, :]]
