"""K5 (``unskew_idx``) as the index kinds of K3's tile transpose, held on
the CPU.

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
``test_torch_skew_tiles.py``. Everything here is exact.
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu_torch.ops import wavefront as twf
from test_torch_skew_tiles import (HS, LAYOUTS, PLAN_SHAPES, SMEM_STATIC_MAX, UNSKEW_U, WS,
                                   check_unskew_cover, hold_unskew)

KINDS = ("u8", "u16")


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
