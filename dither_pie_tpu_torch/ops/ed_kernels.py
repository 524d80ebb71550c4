"""Error-diffusion kernel definitions (numeric data).

The eight classic fixed-weight kernels and Ostromoukhov's
variable-coefficient table, value-identical to
``dither_pie_tpu/ops/ed_kernels.py`` (copied rather than imported: importing
the JAX package pulls in jax). The weights ARE the algorithms, so parity
requires the same numbers.
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


# Ostromoukhov's variable-coefficient table, indexed by luminance 0..255.
# Victor Ostromoukhov, "A Simple and Efficient Error-Diffusion Algorithm"
# (SIGGRAPH 2001), transcribed from the published table.
_OSTRO_HEAD = [
    (13, 0, 5), (13, 0, 5), (21, 0, 10), (7, 0, 4), (8, 0, 5), (47, 3, 28), (23, 3, 13), (15, 3, 8),
    (22, 6, 11), (43, 15, 20), (7, 3, 3), (501, 224, 211), (249, 116, 103), (165, 80, 67), (123, 62, 49), (489, 256, 191),
    (81, 44, 31), (483, 272, 181), (60, 35, 22), (53, 32, 19), (237, 148, 83), (471, 304, 161), (3, 2, 1), (481, 314, 185),
    (354, 226, 155), (1389, 866, 685), (227, 138, 125), (267, 158, 163), (327, 188, 220), (61, 34, 45), (627, 338, 505), (1227, 638, 1075),
    (20, 10, 19), (1937, 1000, 1767), (977, 520, 855), (657, 360, 551), (71, 40, 57), (2005, 1160, 1539), (337, 200, 247), (2039, 1240, 1425),
    (257, 160, 171), (691, 440, 437), (1045, 680, 627), (301, 200, 171), (177, 120, 95), (2141, 1480, 1083), (1079, 760, 513), (725, 520, 323),
    (137, 100, 57), (2209, 1640, 855), (53, 40, 19), (2243, 1720, 741), (565, 440, 171), (2325, 1840, 579), (589, 480, 131), (981, 820, 185),
    (331, 280, 51), (1413, 1220, 255), (355, 310, 57), (1485, 1320, 231), (79, 70, 11), (314, 280, 43), (1101, 1000, 123), (42, 38, 5),
    (481, 440, 53), (229, 210, 23), (1973, 1820, 191), (991, 920, 87), (497, 466, 37), (251, 236, 19), (983, 928, 69), (61, 58, 3),
    (497, 472, 29), (251, 238, 15), (983, 952, 35), (993, 968, 27), (1003, 982, 21), (1013, 992, 19), (1023, 1002, 17), (2033, 2012, 15),
    (513, 506, 5), (1021, 1010, 7), (511, 504, 5), (1021, 1014, 5), (511, 506, 3), (511, 507, 2), (1023, 1018, 3), (2047, 2042, 3),
    (511, 508, 1), (2045, 2044, 1), (1023, 1022, 1), (2047, 2046, 1), (1535, 1534, 1), (511, 511, 0), (1535, 1535, 0), (1023, 1023, 0),
    (511, 511, 0), (511, 511, 0), (1023, 1023, 0), (1535, 1535, 0), (2047, 2047, 0), (511, 511, 0), (511, 511, 0), (511, 511, 0),
    (511, 511, 0), (1023, 1023, 0), (1023, 1023, 0), (1023, 1023, 0), (1023, 1023, 0), (1535, 1535, 0), (1535, 1535, 0), (511, 511, 0),
    (1023, 1023, 0), (1535, 1535, 0), (511, 511, 0), (511, 511, 0), (1023, 1023, 0), (1535, 1535, 0), (2047, 2047, 0), (1535, 1535, 0),
    (1023, 1023, 0), (2047, 2047, 0), (1535, 1535, 0), (1023, 1023, 0), (2047, 2047, 0), (1535, 1535, 0), (2047, 2047, 0), (2047, 2047, 0),
    (1535, 1535, 0), (1023, 1023, 0), (2047, 2047, 0), (1535, 1535, 0), (1023, 1023, 0), (2047, 2047, 0), (1535, 1535, 0), (1023, 1023, 0),
    (2047, 2047, 0), (1535, 1535, 0), (1023, 1023, 0), (1535, 1535, 0), (2047, 2047, 0), (2047, 2047, 0), (1535, 1535, 0), (1023, 1023, 0),
]
# Indices 144..255 repeat the 3-cycle (2047,2047,0), (1535,1535,0),
# (1023,1023,0) starting at (2047,...) — the published table's tail.
_OSTRO_TAIL = [
    ((2047, 2047, 0), (1535, 1535, 0), (1023, 1023, 0))[i % 3] for i in range(256 - len(_OSTRO_HEAD))
]

OSTROMOUKHOV_TABLE: List = _OSTRO_HEAD + _OSTRO_TAIL

OSTROMOUKHOV_ARRAY = np.array(OSTROMOUKHOV_TABLE, dtype=np.int32)
assert OSTROMOUKHOV_ARRAY.shape == (256, 3)
