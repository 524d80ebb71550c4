"""Parameter metadata of the modes the port does not dither yet.

The CLI and the GUI build their settings from
``ImageDitherer.get_mode_parameters(mode)`` for every mode, so the port
serves the metadata before the dithering: each function returns, as a fresh
dict, what the JAX package's strategy class returns from
``get_parameter_info`` (``dither_pie_tpu/api/ditherer.py``), unchanged. When
a mode is ported, its entry moves onto its strategy class.
"""

from __future__ import annotations

from typing import Any, Dict


def wavelet() -> Dict[str, Any]:
    return {
        "wavelet": {
            "type": "choice",
            "default": "haar",
            "choices": ["haar", "db1", "db2", "db4", "sym2", "sym4", "coif1", "bior1.3", "bior2.2"],
            "label": "Wavelet Type",
            "description": "Type of wavelet basis function",
        },
        "subband_quant": {
            "type": "int",
            "default": 8,
            "min": 2,
            "max": 32,
            "label": "Subband Quantization",
            "description": "Number of quantization levels for wavelet subbands",
        },
        "seed": {
            "type": "int",
            "default": 42,
            "min": 0,
            "max": 9999,
            "label": "Random Seed",
            "description": "Seed for random threshold generation (same seed = same output)",
        },
    }


def halftone() -> Dict[str, Any]:
    return {
        "cell_size": {
            "type": "int", "default": 8, "min": 2, "max": 32,
            "label": "Cell Size",
            "description": "Distance between dot centers (smaller = finer detail)",
        },
        "angle": {
            "type": "float", "default": 45.0, "min": 0.0, "max": 90.0,
            "label": "Screen Angle",
            "description": "Rotation angle in degrees (45° is classic newspaper)",
        },
        "dot_gain": {
            "type": "float", "default": 1.0, "min": 0.5, "max": 3.0, "step": 0.1,
            "label": "Dot Gain",
            "description": "Controls dot growth (1.0 = linear, higher = more contrast)",
        },
        "min_dot_size": {
            "type": "float", "default": 0.0, "min": 0.0, "max": 0.5, "step": 0.05,
            "label": "Min Dot Size",
            "description": "Minimum dot threshold (0 = pure white possible)",
        },
        "max_dot_size": {
            "type": "float", "default": 1.0, "min": 0.5, "max": 1.0, "step": 0.05,
            "label": "Max Dot Size",
            "description": "Maximum dot threshold (1.0 = pure black possible)",
        },
        "shape": {
            "type": "choice", "default": "circle",
            "choices": ["circle", "square", "diamond"],
            "label": "Dot Shape",
            "description": "Shape of halftone dots",
        },
        "sharpness": {
            "type": "float", "default": 1.5, "min": 0.5, "max": 4.0, "step": 0.1,
            "label": "Sharpness",
            "description": "Edge sharpness (higher = crisper dots)",
        },
    }
