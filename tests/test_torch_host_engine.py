"""The port's host engine (dither_pie_tpu_torch.native, ops.ed_host,
ops.hilbert) against the JAX package's, bitwise (tolerance 0).

Both packages compile the same ed_scan.cpp (the port's copy differs in
one comment) with the same flags on this host, so every wrapper must give
the same bytes: the 8 fixed-weight variants and Ostromoukhov, row-major
and serpentine, and Riemersma, each in its float64 engine and its float32
twin, on frames of 37 x 53 and 64 x 48
made from a seed, with palettes of 2, 16, 256 and 4097 colours (4097 is
above F32_TWIN_MAX_PAL: the twins hand it to the float64 engine). Also: the
Hilbert path, a loader that raises without a compiler, and the build's
cache key.
"""

import numpy as np
import pytest

from dither_pie_tpu.ops import ed_host as jhost
from dither_pie_tpu.ops import hilbert as jhilbert
from dither_pie_tpu_torch.native import build as tbuild
from dither_pie_tpu_torch.ops import ed_host as thost
from dither_pie_tpu_torch.ops import ed_kernels as tkernels
from dither_pie_tpu_torch.ops import hilbert as thilbert
import torch_workers  # noqa: F401

SHAPES = [(37, 53), (64, 48)]
PALETTES = [2, 16, 256, 4097]


def _frame(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    grad = np.stack([255 * x / w, 255 * y / h, 128 + 100 * np.sin(x / 7 + y / 5)], -1)
    return np.clip(grad + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8).astype(
        np.float32)


def _palette(p, seed):
    return np.random.RandomState(1000 + seed).randint(0, 256, (p, 3)).astype(np.float32)


def _same(name, args, shape, p):
    h, w = shape
    frame = _frame(h, w, h + p)
    pal = _palette(p, h)
    want = getattr(jhost, name)(frame.copy(), pal, *args)
    got = getattr(thost, name)(frame.copy(), pal, *args)
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", PALETTES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("serpentine", [False, True], ids=["rows", "serpentine"])
@pytest.mark.parametrize("variant", tkernels.KERNEL_NAMES)
def test_ed_fixed_equals_jax(variant, serpentine, fast, shape, p):
    _same("ed_fixed_fast" if fast else "ed_fixed", (variant, serpentine), shape, p)


@pytest.mark.parametrize("p", PALETTES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("serpentine", [False, True], ids=["rows", "serpentine"])
def test_ed_ostromoukhov_equals_jax(serpentine, fast, shape, p):
    _same("ed_ostromoukhov_fast" if fast else "ed_ostromoukhov", (serpentine,), shape, p)


@pytest.mark.parametrize("p", PALETTES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_ed_riemersma_equals_jax(fast, shape, p):
    _same("ed_riemersma_fast" if fast else "ed_riemersma", (), shape, p)


def test_twins_hand_large_palettes_to_the_exact_engine():
    """Above F32_TWIN_MAX_PAL the float32 twin IS the float64 engine."""
    assert thost.F32_TWIN_MAX_PAL == jhost.F32_TWIN_MAX_PAL == 4096
    frame, pal = _frame(37, 53, 5), _palette(4097, 5)
    np.testing.assert_array_equal(
        thost.ed_fixed_fast(frame.copy(), pal, "stucki", True),
        thost.ed_fixed(frame.copy(), pal, "stucki", True))
    np.testing.assert_array_equal(thost.ed_riemersma_fast(frame.copy(), pal),
                                  thost.ed_riemersma(frame.copy(), pal))


@pytest.mark.parametrize("k", range(9))
def test_hilbert_path_equals_jax(k):
    n = 2 ** k
    got = thilbert.hilbert_path(n)
    assert got.dtype == np.int32 and got.shape == (n * n, 2)
    np.testing.assert_array_equal(got, jhilbert.hilbert_path(n))
    # Every cell of the square once.
    assert len({(int(r), int(c)) for r, c in got}) == n * n
    assert thilbert.next_power_of_two(n + 1) == jhilbert.next_power_of_two(n + 1)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tbuild, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tbuild, "_lib", None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tbuild.compile_engine(tmp_path / "build")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tbuild.get_lib()
    assert tbuild._lib is None  # a failed build is not cached as "no engine"


def test_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    bad = tmp_path / "ed_scan.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tbuild, "SRC", bad)
    with pytest.raises(RuntimeError, match="failed to build") as e:
        tbuild.compile_engine(tmp_path / "build")
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_cache_key_follows_the_source():
    src = tbuild.SRC.read_bytes()
    assert tbuild.cache_key(src) == tbuild.cache_key(src)
    assert tbuild.cache_key(src + b"\n") != tbuild.cache_key(src)
    assert tbuild.cache_key(src.replace(b"ed_fixed", b"ed_fixeD", 1)) != tbuild.cache_key(src)
    assert tbuild.compile_engine().name == f"libed_scan_{tbuild.cache_key(src)}.so"


def test_source_is_the_jax_packages():
    """The port's engine is the JAX package's source: line for line, but
    for one comment that names the original application's file by a path
    outside this repository."""
    from pathlib import Path

    import dither_pie_tpu.native.build as jbuild

    ours = tbuild.SRC.read_text().splitlines()
    theirs = Path(jbuild._SRC).read_text().splitlines()
    assert len(ours) == len(theirs)
    differ = [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b]
    assert len(differ) == 1 and ours[differ[0]].startswith("// Arithmetic parity notes")
    assert tbuild.CFLAGS == jbuild._CFLAGS
