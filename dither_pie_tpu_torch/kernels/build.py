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
"""

from __future__ import annotations

import threading
from pathlib import Path
from types import ModuleType
from typing import Optional

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("bindings.cpp", "skew.cu", "ed_scan.cu", "unskew_unpack.cu")
EXT_NAME = "dither_pie_tpu_torch_kernels"
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false"]
CXX_FLAGS = ["-O3"]

_lock = threading.Lock()
_ext: Optional[ModuleType] = None


def extension() -> ModuleType:
    """The compiled kernel module (``skew``, ``ed_scan_fixed``,
    ``unskew_unpack``), built on the first call."""
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
