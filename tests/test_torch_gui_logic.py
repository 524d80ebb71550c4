"""The GUI's pure functions in the port (``dither_pie_tpu_torch.gui.logic``,
re-exported by ``gui/widgets.py``, and ``gui.viewmodel.theme_palette``)
against the JAX package's (``dither_pie_tpu.gui.widgets``,
``dither_pie_tpu.gui.viewmodel``), on seeded inputs:

* ``clamp_parameters`` over every mode's ``get_mode_parameters`` and a grid
  of in-range, out-of-range and invalid values: equal;
* ``sample_grid_from_image`` and ``sample_grid_with_geometry`` over sizes,
  scales and offsets: bitwise;
* ``theme_palette`` over dark, light, system, unknown and None: equal.
"""

import numpy as np
import pytest
from PIL import Image

import dither_pie_tpu as jdpt
import dither_pie_tpu_torch as tdpt
from dither_pie_tpu.gui import viewmodel as jvm
from dither_pie_tpu.gui import widgets as jwidgets
from dither_pie_tpu_torch.gui import logic as tlogic
from dither_pie_tpu_torch.gui import viewmodel as tvm
from dither_pie_tpu_torch.gui import widgets as twidgets
import torch_workers  # noqa: F401

PARAM_MODES = [m.value for m in tdpt.DitherMode
               if tdpt.ImageDitherer.get_mode_parameters(m)]
CASES = ["defaults", "in_range", "below", "above", "invalid", "none", "numeric_strings"]


def _raw(info, case, rng):
    """Raw dialog values for ``case``: strings as a Tk entry holds them."""
    raw = {}
    for key, meta in info.items():
        if meta["type"] == "choice":
            choices = [str(c) for c in meta["choices"]]
            raw[key] = {"in_range": choices[rng.randint(len(choices))], "below": "nope",
                        "above": choices[-1].upper() + "x", "invalid": 3.5,
                        "none": None, "numeric_strings": choices[0]}.get(case)
            continue
        lo, hi = meta.get("min", -1e9), meta.get("max", 1e9)
        mid = lo + (hi - lo) * rng.uniform(0.1, 0.9)
        raw[key] = {"in_range": str(mid), "below": str(lo - 1000.5),
                    "above": str(hi + 1000.25), "invalid": "abc", "none": None,
                    "numeric_strings": f" {mid:.3f} " if meta["type"] == "float"
                    else f"{int(mid)}.7"}.get(case)
    if case == "defaults":
        return {}
    return raw


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", PARAM_MODES)
def test_clamp_parameters_equals_jax(mode, case):
    info = tdpt.ImageDitherer.get_mode_parameters(tdpt.DitherMode(mode))
    assert info == jdpt.ImageDitherer.get_mode_parameters(jdpt.DitherMode(mode))
    raw = _raw(info, case, np.random.RandomState(len(mode) * 7 + CASES.index(case)))
    ours = tlogic.clamp_parameters(info, raw)
    assert ours == jwidgets.clamp_parameters(info, raw)
    assert [type(v) for v in ours.values()] == [
        type(v) for v in jwidgets.clamp_parameters(info, raw).values()]
    assert twidgets.clamp_parameters is tlogic.clamp_parameters
    for key, meta in info.items():
        if meta["type"] == "choice":
            assert ours[key] in [str(c) for c in meta["choices"]] + [meta["default"]]
        else:
            assert meta.get("min", ours[key]) <= ours[key] <= meta.get("max", ours[key])


SIZES = [(37, 53), (64, 96), (120, 45), (8, 8), (211, 300)]  # (h, w)


def _image(h, w, seed):
    return Image.fromarray(np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8))


@pytest.mark.parametrize("target", [4, 16, 33, 128])
@pytest.mark.parametrize("h,w", SIZES)
def test_sample_grid_from_image_equals_jax(h, w, target):
    img = _image(h, w, h * w + target)
    ours = twidgets.sample_grid_from_image(img, target)
    theirs = jwidgets.sample_grid_from_image(img, target)
    assert ours.dtype == theirs.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("offset", [(0.0, 0.0), (3.5, -2.25), (-100.0, 50.0), (1e3, 1e3)],
                         ids=["zero", "fraction", "overhang", "outside"])
@pytest.mark.parametrize("scale", [0.5, 0.9, 1.0, 1.37, 2.0])
@pytest.mark.parametrize("h,w", SIZES[:3])
def test_sample_grid_with_geometry_equals_jax(h, w, scale, offset):
    img = _image(h, w, 11 * h + w)
    tw, th = tdpt.utils.compute_even_dimensions(w, h, 16)
    cell = (w / tw * scale, h / th * scale)
    ours = tlogic.sample_grid_with_geometry(img, (tw, th), cell, offset)
    theirs = jwidgets.sample_grid_with_geometry(img, (tw, th), cell, offset)
    assert ours.shape == (th, tw, 3)
    np.testing.assert_array_equal(ours, theirs)
    # At scale 1 and offset 0 the two samplers agree where the JAX
    # package's do (not everywhere: w / tw * (i + 0.5) and (i + 0.5) * w /
    # tw round apart).
    assert (np.array_equal(ours, tlogic.sample_grid_from_image(img, 16))
            == np.array_equal(theirs, jwidgets.sample_grid_from_image(img, 16)))


@pytest.mark.parametrize("appearance", ["dark", "light", "system", "plaid", None, " DARK ", ""])
def test_theme_palette_equals_jax(appearance):
    ours = tvm.theme_palette(appearance)
    assert ours == jvm.theme_palette(appearance)
    ours["bg"] = "#000000"  # a copy: the table is not poisoned
    assert tvm.theme_palette(appearance) == jvm.theme_palette(appearance)
