"""Error-diffusion kernel definitions (numeric data).

The eight classic fixed-weight kernels, value-identical to
``dither_pie_tpu/ops/ed_kernels.py`` (copied rather than imported: importing
the JAX package pulls in jax). The weights ARE the algorithms, so parity
requires the same numbers. Ostromoukhov's variable-coefficient table belongs
to the rest of the error-diffusion family and is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

KERNELS: Dict[str, Dict[str, Any]] = {
    "floyd_steinberg": {
        "weights": [(1, 0, 7), (-1, 1, 3), (0, 1, 5), (1, 1, 1)],
        "divisor": 16,
        "description": "Classic Floyd-Steinberg (4 neighbors)",
        "rows": 2,
    },
    "jjn": {
        "weights": [
            (1, 0, 7), (2, 0, 5),
            (-2, 1, 3), (-1, 1, 5), (0, 1, 7), (1, 1, 5), (2, 1, 3),
            (-2, 2, 1), (-1, 2, 3), (0, 2, 5), (1, 2, 3), (2, 2, 1),
        ],
        "divisor": 48,
        "description": "Jarvis-Judice-Ninke (12 neighbors, smooth gradients)",
        "rows": 3,
    },
    "stucki": {
        "weights": [
            (1, 0, 8), (2, 0, 4),
            (-2, 1, 2), (-1, 1, 4), (0, 1, 8), (1, 1, 4), (2, 1, 2),
            (-2, 2, 1), (-1, 2, 2), (0, 2, 4), (1, 2, 2), (2, 2, 1),
        ],
        "divisor": 42,
        "description": "Stucki (12 neighbors, photographic quality)",
        "rows": 3,
    },
    "burkes": {
        "weights": [
            (1, 0, 8), (2, 0, 4),
            (-2, 1, 2), (-1, 1, 4), (0, 1, 8), (1, 1, 4), (2, 1, 2),
        ],
        "divisor": 32,
        "description": "Burkes (7 neighbors, fast)",
        "rows": 2,
    },
    "atkinson": {
        "weights": [
            (1, 0, 1), (2, 0, 1),
            (-1, 1, 1), (0, 1, 1), (1, 1, 1),
            (0, 2, 1),
        ],
        "divisor": 8,  # only 6/8 distributed: loses 25% of the error by design
        "description": "Atkinson (6 neighbors, classic Mac look)",
        "rows": 3,
    },
    "sierra": {
        "weights": [
            (1, 0, 5), (2, 0, 3),
            (-2, 1, 2), (-1, 1, 4), (0, 1, 5), (1, 1, 4), (2, 1, 2),
            (-1, 2, 2), (0, 2, 3), (1, 2, 2),
        ],
        "divisor": 32,
        "description": "Sierra Full (10 neighbors, high quality)",
        "rows": 3,
    },
    "sierra_two_row": {
        "weights": [
            (1, 0, 4), (2, 0, 3),
            (-2, 1, 1), (-1, 1, 2), (0, 1, 3), (1, 1, 2), (2, 1, 1),
        ],
        "divisor": 16,
        "description": "Sierra Two-Row (8 neighbors, balanced)",
        "rows": 2,
    },
    "sierra_lite": {
        "weights": [
            (1, 0, 2),
            (-1, 1, 1), (0, 1, 1),
        ],
        "divisor": 4,
        "description": "Sierra Lite (4 neighbors, fastest)",
        "rows": 2,
    },
}

KERNEL_NAMES: List[str] = [
    "floyd_steinberg", "jjn", "stucki", "burkes", "atkinson",
    "sierra", "sierra_two_row", "sierra_lite",
]


def get_kernel(name: str) -> Dict[str, Any]:
    """Kernel by name; unknown names fall back to floyd_steinberg (as the
    reference's getter does)."""
    return KERNELS.get(name, KERNELS["floyd_steinberg"])


def kernel_arrays(name: str):
    """(offsets (n,2) int32, f32 pre-divided weights (n,)) for a kernel.

    Pre-division uses python-float math then f32 demotion, matching NumPy-2
    weak-scalar semantics in the reference's distribution loop.
    """
    k = get_kernel(name)
    offs = np.array([(dx, dy) for dx, dy, _ in k["weights"]], dtype=np.int32)
    wts = np.array([wgt / k["divisor"] for _, _, wgt in k["weights"]], dtype=np.float32)
    return offs, wts
