"""K6 (``skew_planar_gather``) as the one-channel form of K1's tile
transpose, held on the CPU.

``skew.cu`` runs one tile kernel for NHWC frames (C = 3, K1) and for
compact planes (C = 1, K6): R planes (R, H, W) are R frames of one channel.
Neither runs here, so this file holds what K6 is built from: its tile plan
(``skew_tile_plan(..., channels=1)``) covers the (D, H) stream plane of
every plane exactly once and fits a block's static shared memory, and the
numpy model of the kernel's walk (``test_torch_skew_tiles.skew_model``,
the same walk with C = 1) reproduces ``skew_planar_plain`` bit for bit on
flat byte buffers with the tensors off the 16-byte boundary and random
bytes around them, every output byte written exactly once. The K1 cases
(C = 3) stay in ``test_torch_skew_tiles.py``. K7's cast form (uint8 planes
into a float32 stream, the float32 plan) is the same walk with a uint8
load, held to ``skew_transpose_plain(..., torch.float32)``. Everything here
is exact.
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu_torch.ops import wavefront as twf
from test_torch_skew_tiles import HS, PLAN_SHAPES, SMEM_STATIC_MAX, WS, skew_model
import torch_workers  # noqa: F401

# (R, base offset of the input, of the output): offsets off the 16-byte
# boundary stand for a contiguous slice such as planes[1:].
PLANAR_LAYOUTS = [(1, 0, 0), (5, 7, 13), (3, 13, 8), (48, 1, 3)]


def _planes(r, h, w, seed, dtype):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (r, h, w)).astype(np.uint8)
    return rng.uniform(-8.0, 263.0, (r, h, w)).astype(np.float32)


def _hold_planar(r, h, w, s, dtype, in_off, out_off, out_dtype=None):
    """The model == ``skew_planar_plain`` bitwise; with ``out_dtype``
    float32 from uint8 planes (K7's cast form, the float32 plan), ==
    ``skew_transpose_plain`` cast to float32."""
    planes = _planes(r, h, w, 5 * h + w + r, dtype)
    x = torch.from_numpy(planes)
    if out_dtype is None:
        plan = twf.skew_tile_plan(r, h, w, s, x.dtype, out_off % 32, 1)
        want = twf.skew_planar_plain(x, s).numpy()
    else:
        plan = twf.skew_tile_plan(r, h, w, s, torch.float32, out_off % 32, 1)
        want = twf.skew_transpose_plain(x, s, torch.float32).numpy()
    got = skew_model(planes[..., None], s, plan, in_off, out_off, out_dtype=out_dtype)
    assert got.dtype == want.dtype
    assert got.shape == want.shape and np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("b,h,w,s", PLAN_SHAPES)
def test_planar_plans_cover_the_plane_once(b, h, w, s):
    """Every step d lies in one step tile and, of every stream row, the row
    tiles' windows y in [k*TY - ph, (k+1)*TY - ph) (ph the row's sector
    phase, never above ``lead``) hold every y once, each inside the rows
    its block loads; the grid walks every plane."""
    d_total = twf.stream_length(h, w, s)
    for dtype, phases in ((torch.uint8, (0, 8, 13)), (torch.float32, (0, 4, 12))):
        for phase in phases:
            plan = twf.skew_tile_plan(b, h, w, s, dtype, phase, 1)
            what = f"{dtype} phase {phase}"
            gx, gy, gz = plan.grid
            assert plan.td >= 3 * twf.SKEW_TILES[dtype, 3][0], what
            assert plan.threads == 256 and plan.smem_bytes <= SMEM_STATIC_MAX, what
            assert gz == min(b, 65535) and gy <= 65535, what
            assert gy * plan.td >= d_total > (gy - 1) * plan.td, what
            assert gx * plan.ty >= h + plan.lead > (gx - 1) * plan.ty, what
            assert plan.lead == twf.skew_lead_rows(h, dtype.itemsize, phase), what
            for ph in range(plan.lead + 1):
                cover = np.zeros(h, np.int64)
                for k in range(gx):
                    lo, hi = max(0, k * plan.ty - ph), min(h, (k + 1) * plan.ty - ph)
                    cover[lo:max(lo, hi)] += 1
                    assert lo >= k * plan.ty - plan.lead, what
                assert np.all(cover == 1), what


def test_planar_plans_at_1080p():
    """K6's plans at the planar main path's shape (48 planes of 16 frames):
    tile counts, lead rows and shared memory."""
    r, h, w, s = 48, 1080, 1920, 2
    u8 = twf.skew_tile_plan(r, h, w, s, torch.uint8, 0, 1)
    assert (u8.td, u8.ty, u8.lead, u8.grid, u8.smem_bytes) == (256, 128, 24, (9, 16, 48), 43344)
    f32 = twf.skew_tile_plan(r, h, w, s, torch.float32, 0, 1)
    assert (f32.td, f32.ty, f32.lead, f32.grid, f32.smem_bytes) == (192, 32, 0, (34, 22, 48),
                                                                      32520)


def test_planar_plans_refuse_what_no_grid_holds():
    with pytest.raises(ValueError):
        twf.skew_tile_plan(1, 2, 256 * 65536, 2, torch.uint8, 0, 1)
    with pytest.raises(KeyError):
        twf.skew_tile_plan(1, 2, 2, 2, torch.uint8, 0, 2)


@pytest.mark.parametrize("layout", PLANAR_LAYOUTS, ids=lambda v: f"r{v[0]}-in{v[1]}-out{v[2]}")
@pytest.mark.parametrize("s", (2, 3))
@pytest.mark.parametrize("h", HS)
def test_planar_model_u8_equals_plain(h, s, layout):
    r, in_off, out_off = layout
    for w in WS:
        _hold_planar(r, h, w, s, np.uint8, in_off, out_off)


@pytest.mark.parametrize("s", (2, 3))
@pytest.mark.parametrize("h", HS)
def test_planar_model_f32_equals_plain(h, s):
    for (r, in_off, out_off), w in zip(PLANAR_LAYOUTS * 2, WS):
        _hold_planar(r, h, w, s, np.float32, in_off - in_off % 4, out_off - out_off % 4)


@pytest.mark.parametrize("layout", PLANAR_LAYOUTS, ids=lambda v: f"r{v[0]}-in{v[1]}-out{v[2]}")
@pytest.mark.parametrize("s", (2, 3))
@pytest.mark.parametrize("h", HS)
def test_planar_model_u8_to_f32_equals_plain(h, s, layout):
    """K7's cast form on planes (uint8 at any offset, a float32 stream on a
    4-byte boundary)."""
    r, in_off, out_off = layout
    for w in WS:
        _hold_planar(r, h, w, s, np.uint8, in_off, out_off - out_off % 4, np.float32)


@pytest.mark.parametrize("case", [
    (2, 300, 70, 2, np.uint8), (5, 300, 70, 3, np.float32), (1, 129, 400, 2, np.uint8),
    (3, 97, 130, 3, np.float32), (1, 260, 7, 2, np.uint8)],
    ids=lambda v: f"{v[0]}x{v[1]}x{v[2]}-s{v[3]}")
def test_planar_model_across_row_tiles(case):
    """Planes taller than one tile and wider than one step tile: tiles
    full, partial and empty, and the last row tile cut short."""
    r, h, w, s, dtype = case
    _hold_planar(r, h, w, s, dtype, 5 if dtype == np.uint8 else 4, 0)


@pytest.mark.parametrize("dtype", (np.uint8, np.float32))
def test_planar_model_of_a_batch_is_k1s_stream(dtype):
    """The 3B planes of a (3, B, H, W) batch, in the order c*B + b, give
    K1's stream of the same frames through both forms of the walk."""
    b, h, w, s = 3, 33, 21, 2
    rng = np.random.RandomState(3)
    frames = (rng.randint(0, 256, (b, h, w, 3)) if dtype == np.uint8
              else rng.uniform(-8.0, 263.0, (b, h, w, 3))).astype(dtype)
    planes = np.ascontiguousarray(frames.transpose(3, 0, 1, 2)).reshape(3 * b, h, w)
    tdt = torch.from_numpy(frames).dtype
    k6 = skew_model(planes[..., None], s, twf.skew_tile_plan(3 * b, h, w, s, tdt, 0, 1), 0, 0)
    k1 = skew_model(frames, s, twf.skew_tile_plan(b, h, w, s, tdt), 0, 0)
    assert np.array_equal(k6.view(np.uint8), k1.view(np.uint8))
