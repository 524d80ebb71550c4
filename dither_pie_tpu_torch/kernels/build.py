"""Build and load the hand-written Hopper kernels from ``csrc/``.

``extension()`` compiles the sources in this repository at first use with
``torch.utils.cpp_extension.load`` and returns the loaded module. nvcc
builds the ``.cu`` files (which include no PyTorch header, seconds) for
``sm_90a`` with ``--fmad=false`` so that no multiply-add is contracted into
an FMA; the host compiler builds ``bindings.cpp`` against PyTorch (about
half a minute on an 8-core host). The build lands in ``_build/`` beside
this file (listed in ``.gitignore``); ninja rebuilds only what changed.

Nothing here falls back: a failed build raises, and the caller sees it.
Importing this module builds nothing and needs no CUDA.

``LAUNCHES`` counts the CUDA launches of every kernel in this process, by
name; each wrapper adds one where it launches its kernel and nowhere else
(plain-version calls are not counted). ``on_cuda`` is the one rule that
picks kernel or plain version: the tensor's device.
"""

from __future__ import annotations

import threading
from collections import Counter
from pathlib import Path
from types import ModuleType
from typing import Optional

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("bindings.cpp", "skew.cu", "skew_transpose.cu",
           "ed_scan.cu", "unskew_unpack.cu", "unskew_idx.cu", "unskew_select.cu",
           "ordered.cu", "search_probe.cu", "gather_probe.cu", "identity.cu")
EXT_NAME = "dither_pie_tpu_torch_kernels"
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false"]
CXX_FLAGS = ["-O3"]

_lock = threading.Lock()
_ext: Optional[ModuleType] = None

LAUNCHES: Counter = Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensors on {t.device} are not supported: use cuda or cpu")


def extension() -> ModuleType:
    """The compiled kernel module (``skew``, ``skew_transpose``,
    ``ed_scan``, ``unskew_unpack``, ``unskew_idx``, ``unskew_select``,
    ``ordered_fused``, ``search_probe``, ``gather_chain``, ``sweep_chain``,
    ``identity_u8``), built on the first call."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _ext = load(
                name=EXT_NAME,
                sources=[str(CSRC / s) for s in SOURCES],
                build_directory=str(BUILD_DIR),
                extra_include_paths=[str(CSRC)],
                extra_cflags=CXX_FLAGS,
                extra_cuda_cflags=NVCC_FLAGS,
                verbose=False,
            )
    return _ext
