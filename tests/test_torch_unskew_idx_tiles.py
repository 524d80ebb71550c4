"""K5 (``unskew_idx``) and K9 (``unskew_select``) as the index kinds of
K3's tile transpose, held on the CPU.

``unskew_unpack.cu`` runs one tile kernel for four output kinds: K3's NHWC
and planar colours and K5's uint8 and uint16 index streams. The CUDA
kernel does not run here, so this file holds what K5 is built from: its
plans (``unskew_tile_plan(..., "u8" / "u16")``) take every frame once and,
of every output row, put each byte in exactly one launched block's window,
inside the steps that block loads; and the numpy model of the kernel's walk
(``test_torch_skew_tiles.unskew_model``, the same walk by output kind)
reproduces ``unskew_idx_plain`` bit for bit on flat byte buffers, with the
stream and the output off the 16-byte boundary and random bytes around
them, every output byte written exactly once. K3's kinds stay in
``test_torch_skew_tiles.py``.

K9 is the "select" kind: K3's NHWC kind with a lookup of each loaded index
in the packed palette (``packed_palette``, the binding's packing kernel)
as it goes into the tile. Its plan is NHWC's, and the same walk ==
``unskew_select_plain`` at palettes of 1025 to 16384 colours, with
fractional entries (the float32 -> int32 cast truncates) and planted
duplicates; the model refuses to look up any entry outside the image.
Everything here is exact.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.ops import wavefront as twf
from test_torch_skew_tiles import (HS, LAYOUTS, PLAN_SHAPES, SMEM_STATIC_MAX, UNSKEW_U, WS,
                                   check_unskew_cover, hold_unskew, packed_palette)
import torch_workers  # noqa: F401

KINDS = ("u8", "u16")


def select_palette(name: str) -> np.ndarray:
    """The K9 test palettes by name: P colours, fractional entries (12.9,
    255.5, 0.3 truncate), and with "dup" duplicates planted at both ends."""
    p = int(name.split("-")[0][1:])
    rng = np.random.RandomState(p)
    pal = rng.uniform(0.0, 256.0, (p, 3)).astype(np.float32)
    pal = np.minimum(pal, np.float32(255.99))
    pal[:3] = [[12.9, 255.5, 0.3], [255.5, 12.9, 0.0], [0.3, 0.3, 255.0]]
    if "dup" in name:
        pal[p - 1] = pal[0]
        pal[p // 2] = pal[1]
        pal[1::7] = pal[0::7][:len(pal[1::7])]
    return pal


SELECT_PALETTES = ("p1025-frac", "p16384-dup")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,h,w,s", PLAN_SHAPES)
def test_index_plans_cover_every_row_once(b, h, w, s, kind):
    """Every frame once, and of every output row (its start at any phase of
    a sector a uint8 or uint16 row can have) each byte in exactly one
    launched block's window, each window inside its block's steps."""
    plan = twf.unskew_tile_plan(b, h, w, s, kind)
    gx, gy, gz = plan.grid
    assert gy <= 65535 and gz <= 65535
    assert plan.threads == 256 and plan.smem_bytes <= SMEM_STATIC_MAX
    assert plan.lead == -(-31 // UNSKEW_U[kind])
    phases = (0, 1, 13, 31) if kind == "u8" else (0, 2, 14, 30)
    check_unskew_cover(plan, b, h, w, s, UNSKEW_U[kind], kind, phases)


def test_index_plans_at_1080p():
    """The plans at the index stream's shape: 16 x 1080p, s = 2."""
    u8 = twf.unskew_tile_plan(16, 1080, 1920, 2, "u8")
    assert (u8.td, u8.ty, u8.lead, u8.grid, u8.smem_bytes) == (128, 32, 31, (34, 17, 8), 21500)
    u16 = twf.unskew_tile_plan(16, 1080, 1920, 2, "u16")
    assert (u16.td, u16.ty, u16.lead, u16.grid, u16.smem_bytes) == (128, 32, 16, (34, 17, 8),
                                                                      19648)
    with pytest.raises(KeyError):
        twf.unskew_tile_plan(16, 1080, 1920, 2, "int32")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"b{v[0]}-in{v[1]}-out{v[2]}")
@pytest.mark.parametrize("s", (2, 3))
@pytest.mark.parametrize("h", HS)
def test_index_model_equals_plain(h, s, layout, kind):
    """The walk == ``unskew_idx_plain`` at every odd width, the stream 4
    bytes off the boundary where the layout asks, the output at the layout's
    offset (u16: on a 2-byte boundary)."""
    b, in_off, out_off = layout
    for w in WS:
        hold_unskew(b, h, w, s, kind, in_off - in_off % 4,
                    out_off - out_off % UNSKEW_U[kind])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("offsets", [(0, 0), (4, 1), (12, 6), (8, 15)],
                         ids=lambda v: f"in{v[0]}-out{v[1]}")
def test_index_model_across_tiles_and_longer_streams(kind, offsets):
    """Several row and step tiles, tall and wide frames, and a stream longer
    than D (K5 takes idx.size(0) >= D), at offsets off the boundary."""
    in_off, out_off = offsets
    out_off -= out_off % UNSKEW_U[kind]
    hold_unskew(2, 97, 300, 2, kind, in_off, out_off, extra_steps=5)
    hold_unskew(3, 70, 130, 3, kind, in_off, out_off)
    hold_unskew(1, 40, 520, 2, kind, in_off, out_off)


# ---------------------------------------------------------------------------
# K9: the select kind
# ---------------------------------------------------------------------------


def test_unskew_kinds_are_the_kernels():
    """``UNSKEW_KINDS`` orders the kinds as ``unskew_unpack.cu`` numbers
    them."""
    src = (build.CSRC / "unskew_unpack.cu").read_text()
    kinds = {int(v): k.lower() for k, v in re.findall(r"constexpr int KIND_(\w+) = (\d+);",
                                                      src)}
    assert [kinds[i] for i in range(len(kinds))] == list(twf.UNSKEW_KINDS)
    assert twf.UNSKEW_KINDS.index("select") == 4


@pytest.mark.parametrize("b,h,w,s", PLAN_SHAPES)
def test_select_plans_cover_every_row_once(b, h, w, s):
    """K9 plans as K3 NHWC, and of every output row (its start at any byte
    phase of a sector) each byte lies in exactly one launched block's
    window, each window from a sector boundary and inside its block's
    steps."""
    plan = twf.unskew_tile_plan(b, h, w, s, "select")
    assert plan == twf.unskew_tile_plan(b, h, w, s, "nhwc")
    assert plan.lead == 11 and plan.smem_bytes <= SMEM_STATIC_MAX
    check_unskew_cover(plan, b, h, w, s, 3, "select", (0, 1, 13, 31))


def test_select_plan_at_480p():
    """The plan at K9's main-path shape: 16 x 480p, s = 2."""
    plan = twf.unskew_tile_plan(16, 480, 854, 2, "select")
    assert (plan.td, plan.ty, plan.lead, plan.grid, plan.smem_bytes) == (128, 32, 11, (15, 8, 8),
                                                                        18860)


def test_packed_palette_truncates_as_the_plain_version():
    """The packing kernel's model == ``palette.to(int32).to(uint8)`` of the
    plain version, channel by channel."""
    pal = select_palette("p1025-frac")
    want = torch.from_numpy(pal).to(torch.int32).to(torch.uint8).numpy().astype(np.uint32)
    got = packed_palette(pal)
    assert np.array_equal(got, (want[:, 0] << 16) | (want[:, 1] << 8) | want[:, 2])
    assert got[0] == (12 << 16 | 255 << 8 | 0)


@pytest.mark.parametrize("pal", SELECT_PALETTES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"b{v[0]}-in{v[1]}-out{v[2]}")
@pytest.mark.parametrize("s", (2, 3))
@pytest.mark.parametrize("h", HS)
def test_select_model_equals_plain(h, s, layout, pal):
    """The walk == ``unskew_select_plain`` at every odd width (W <= s
    among them), the stream 4 bytes off the boundary where the layout asks,
    the output at any byte offset."""
    b, in_off, out_off = layout
    palette = select_palette(pal)
    for w in WS:
        hold_unskew(b, h, w, s, "select", in_off - in_off % 4, out_off, palette=palette)


@pytest.mark.parametrize("pal", ("p1025-frac", "p2048-dup", "p4096", "p16384-dup"))
@pytest.mark.parametrize("offsets", [(0, 0), (4, 1), (12, 7)], ids=lambda v: f"in{v[0]}-out{v[1]}")
def test_select_model_across_tiles_and_longer_streams(offsets, pal):
    """Several row and step tiles, tall and wide frames, and a stream longer
    than D, at palettes of 1025 to 16384 colours."""
    in_off, out_off = offsets
    palette = select_palette(pal)
    hold_unskew(2, 97, 300, 2, "select", in_off, out_off, extra_steps=5, palette=palette)
    hold_unskew(3, 70, 130, 3, "select", in_off, out_off, palette=palette)


def test_select_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors ``unskew_select`` is its plain version and launches
    nothing."""
    palette = torch.from_numpy(select_palette("p2048-dup"))
    idx = torch.from_numpy(np.random.RandomState(3).randint(0, 2048, (70, 3, 5)).astype(
        np.int32))
    build.reset_launch_counts()
    got = twf.unskew_select(idx, palette, 2, 5, 53)
    assert torch.equal(got, twf.unskew_select_plain(idx, palette, 2, 5, 53))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, 5, 53, 3)
    assert not build.LAUNCHES
