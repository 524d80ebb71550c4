"""Compile and bind the host engine ``ed_scan.cpp`` with ctypes.

``get_lib()`` compiles ``ed_scan.cpp`` (beside this file; a copy of
``dither_pie_tpu/native/ed_scan.cpp`` that differs in one comment) with
g++ at first use into ``_build/`` beside this file (listed in
``.gitignore``), under a name keyed by the source bytes, the flags and the
host CPU's feature flags, so an edit or another host builds anew. The flags are the JAX package's: ``-O3
-march=native`` with no contraction into FMA and no fast math, so both
packages' engines round alike; where the compiler refuses
``-march=native`` the build is retried without it.

Nothing here falls back: a missing compiler or a failed build raises with
the compiler's own message (there is no numpy scan behind it). Importing
this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).parent / "ed_scan.cpp"
CXX = "g++"  # the JAX package's compiler, so both engines round alike
BUILD_DIR = Path(__file__).parent / "_build"

CFLAGS = [
    "-O3",
    "-march=native",  # vectorises the float32 twins' distance loops
    "-fPIC",
    "-shared",
    # The engine is the golden reference: no contraction into FMA and no
    # fast math, so its rounding is the JAX package's.
    "-ffp-contract=off",
    "-fno-fast-math",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def _host_cpu_id() -> bytes:
    """The host CPU's feature line: a ``-march=native`` library built on
    one host can fault on another that shares the directory."""
    try:
        with open("/proc/cpuinfo", "r", encoding="utf-8") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.encode()
    except OSError:
        pass
    return (platform.machine() + platform.processor()).encode()


def cache_key(source: bytes) -> str:
    """The build's cache key: the source bytes, the flags and the host's
    CPU features."""
    return hashlib.sha256(
        source + " ".join(CFLAGS).encode() + _host_cpu_id()).hexdigest()[:16]


def compile_engine(build_dir: Optional[Path] = None) -> Path:
    """The shared library of ``SRC`` in ``build_dir`` (``BUILD_DIR``),
    compiled unless the cache holds it. Raises ``RuntimeError`` with the
    compiler's message."""
    build_dir = build_dir or BUILD_DIR
    out = build_dir / f"libed_scan_{cache_key(SRC.read_bytes())}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    errors = []
    for flags in (CFLAGS, [f for f in CFLAGS if f != "-march=native"]):
        try:
            subprocess.run([CXX, *flags, str(SRC), "-o", str(tmp)], check=True,
                           capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"no C++ compiler for the host engine ({CXX!r}): {e}") from e
        except subprocess.CalledProcessError as e:
            errors.append(f"{' '.join(e.cmd)}:\n{e.stderr}")
            continue
        os.replace(tmp, out)
        return out
    raise RuntimeError("the host engine failed to build:\n" + "\n".join(errors))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i, c_f = ctypes.c_int, ctypes.c_float
    lib.ed_fixed.argtypes = [_f32p, c_i, c_i, _f32p, c_i, _i32p, _f32p, c_i, c_i]
    lib.ed_ostromoukhov.argtypes = [_f32p, c_i, c_i, _f32p, c_i, _i32p, c_i]
    lib.ed_hybrid.argtypes = [_f32p, c_i, c_i, _f32p, c_i, c_f, c_f, c_i]
    lib.ed_perceptual.argtypes = [_f32p, c_i, c_i, _f32p, c_i, _f32p]
    lib.ed_adaptive.argtypes = [_f32p, c_i, c_i, _f32p, c_i, _u8p]
    lib.ed_riemersma.argtypes = [_f32p, c_i, c_i, _f32p, c_i, _i32p, ctypes.c_int64]
    lib.ed_fixed_f32.argtypes = [_f32p, c_i, c_i, _f32p, c_i, _i32p, _f32p, c_i, c_i]
    lib.ed_ostromoukhov_f32.argtypes = [_f32p, c_i, c_i, _f32p, c_i, _i32p, c_i]
    lib.ed_hybrid_f32.argtypes = [_f32p, c_i, c_i, _f32p, c_i, c_f, c_f, c_i]
    lib.ed_perceptual_f32.argtypes = [_f32p, c_i, c_i, _f32p, c_i, _f32p]
    lib.ed_adaptive_f32.argtypes = [_f32p, c_i, c_i, _f32p, c_i, _u8p]
    lib.ed_riemersma_f32.argtypes = [_f32p, c_i, c_i, _f32p, c_i, _i32p,
                                     ctypes.c_int64]
    for fn in ("ed_fixed", "ed_ostromoukhov", "ed_hybrid", "ed_perceptual",
               "ed_adaptive", "ed_riemersma", "ed_fixed_f32",
               "ed_ostromoukhov_f32", "ed_hybrid_f32", "ed_perceptual_f32",
               "ed_adaptive_f32", "ed_riemersma_f32"):
        getattr(lib, fn).restype = None
    return lib


def get_lib() -> ctypes.CDLL:
    """The compiled and bound engine, built on the first call. A failed
    build raises, and the next call tries again."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(compile_engine())))
    return _lib
