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

``python3 -m dither_pie_tpu_torch.kernels.build --ptxas NAME.cu ...``
compiles the named sources alone with the same flags and prints what
ptxas reports for each kernel: registers, shared memory, spills.

``LAUNCHES`` counts the CUDA launches of every kernel in this process, by
name; each wrapper adds one with ``count_launch`` where it launches its
kernel and nowhere else (plain-version calls are not counted). ``on_cuda``
is the one rule that picks kernel or plain version: the tensor's device.
"""

from __future__ import annotations

import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path
from types import ModuleType
from typing import Optional

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("bindings.cpp", "skew.cu", "ed_scan.cu", "unskew_unpack.cu", "ordered.cu",
           "search_probe.cu", "gather_probe.cu", "identity.cu", "riemersma_scan.cu")
EXT_NAME = "dither_pie_tpu_torch_kernels"
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false"]
CXX_FLAGS = ["-O3"]

_lock = threading.Lock()
_ext: Optional[ModuleType] = None

LAUNCHES: Counter = Counter()
_launch_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to ``LAUNCHES``, under a lock: the
    video pipeline's two workers launch at once."""
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _launch_lock:
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
    """The compiled kernel module (``skew`` (K1, K6, K7), ``ed_scan``,
    ``unskew`` (K3, K5 and K9), ``ordered_fused``, ``search_probe``, ``gather_chain``, ``sweep_chain``,
    ``identity_u8``, ``riemersma_scan`` (R1)), built on the first call."""
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


def ptxas_report(names) -> str:
    """nvcc's ``-Xptxas -v`` lines for the named sources of ``csrc/``, each
    compiled alone to an object in ``_build/ptxas/`` with NVCC_FLAGS."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit: ptxas reports need nvcc")
    out_dir = BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for name in names:
        r = subprocess.run(
            [str(Path(CUDA_HOME) / "bin" / "nvcc"), *NVCC_FLAGS, "-std=c++17", "-Xptxas", "-v",
             "-I", str(CSRC), "-c", str(CSRC / name), "-o", str(out_dir / f"{name}.o")],
            capture_output=True, text=True, check=True)
        lines.append(f"{name}:\n{r.stdout}{r.stderr}")
    return "".join(lines)


if __name__ == "__main__":
    if sys.argv[1:2] != ["--ptxas"] or len(sys.argv) < 3:
        sys.exit("usage: python3 -m dither_pie_tpu_torch.kernels.build --ptxas NAME.cu ...")
    print(ptxas_report(sys.argv[2:]), end="")
