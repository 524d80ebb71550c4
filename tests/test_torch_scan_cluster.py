"""The scan's cluster plan (K2 / K8 over a thread-block cluster) on the CPU.

The CUDA scan splits a frame's palette into n contiguous slices, one per
block of a cluster, and merges the blocks' candidates in rank order. What
runs here: the pure plan (``scan_cluster_plan``, ``palette_slices``), the
shared-memory budget (``scan_smem_bytes``, ``scan_smem_plan``), and a numpy
model of the kernel's search and merge held to the first argmin / argmax
over the whole palette. The kernel itself is held to ``scan_plain`` on the
card by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

from dither_pie_tpu_torch.ops import ed_kernels
from dither_pie_tpu_torch.ops import wavefront as twf
import torch_workers  # noqa: F401

# Clusters of one scan launch that an H100 holds at once (as
# cudaOccupancyMaxActiveClusters answered for 16 x 1080p FS),
# and a tighter card.
H100 = {1: 264, 2: 66, 4: 30, 8: 15}
SMALL_CARD = {1: 40, 2: 20, 4: 8, 8: 2}

GEOMETRIES = ([twf.scan_geometry(v) for v in ed_kernels.KERNEL_NAMES]
              + [twf.scan_geometry("", m) for m in twf.MODES[1:]])
GEOM_IDS = list(ed_kernels.KERNEL_NAMES) + list(twf.MODES[1:])


@pytest.mark.parametrize("card", [H100, SMALL_CARD], ids=["h100", "small"])
@pytest.mark.parametrize("b", [1, 3, 16, 17, 33, 133])
@pytest.mark.parametrize("p", [1, 2, 3, 7, 33, 65, 256, 1023, 2049, 16384])
def test_cluster_plan_slices_and_residency(card, b, p):
    geom = twf.scan_geometry("floyd_steinberg")
    asked = []

    def capacity(plan):
        asked.append(plan.n)
        return card[plan.n]

    plan = twf.scan_cluster_plan(b, 37, p, geom, capacity=capacity)
    bounds = plan.bounds
    assert plan.n in twf.CLUSTER_SIZES and plan.n <= p
    assert len(bounds) == plan.n + 1 and bounds[0] == 0 and bounds[-1] == p
    assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))  # none empty
    lengths = np.diff(bounds)
    assert lengths.max() - lengths.min() <= 1
    assert plan.n <= twf.cluster_size_for(p)
    if plan.n > 1 and twf.scan_smem_plan(geom, 37, p, 1) is not None:
        assert b <= card[plan.n]  # every cluster resident at once
    # A larger size the table allowed was refused for residency alone.
    for n in asked:
        if n > plan.n:
            assert b > card[n]
    assert plan.smem_bytes == twf.scan_smem_bytes(geom, 37, p, plan.n, False, plan.hist_smem)


@pytest.mark.parametrize("b, n", [(1, 8), (3, 8), (17, 4), (33, 2), (133, 1)])
def test_cluster_plan_takes_every_size_on_an_h100(b, n):
    """The batch sizes chip_smoke holds: each picks its own n."""
    geom = twf.scan_geometry("floyd_steinberg")
    assert twf.cluster_size_for(1024) == 8
    plan = twf.scan_cluster_plan(b, 37, 1024, geom, capacity=lambda pl: H100[pl.n])
    assert plan.n == n


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_forced_cluster_size_ignores_residency(n):
    geom = twf.scan_geometry("floyd_steinberg")
    plan = twf.scan_cluster_plan(10_000, 1080, 256, geom, capacity=lambda pl: 1, n=n)
    assert plan.n == n and plan.bounds == twf.palette_slices(256, n)
    # Never more blocks than colours.
    assert twf.scan_cluster_plan(1, 37, 3, geom, n=n).n == min(n, 2)


def test_cluster_plan_refuses_unknown_sizes():
    geom = twf.scan_geometry("floyd_steinberg")
    with pytest.raises(ValueError):
        twf.scan_cluster_plan(1, 37, 64, geom, n=3)
    with pytest.raises(ValueError):
        twf.palette_slices(4, 8)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=GEOM_IDS)
def test_one_block_always_fits(geom):
    """The plan can always end at n = 1: the largest palette K8 takes fits one
    block beside the weight table at any height (the history moves to
    device memory), so residency never forces a failure."""
    for h in (37, 1080, 2160, 4320):
        nbytes, hist_smem = twf.scan_smem_plan(geom, h, twf.INDEX_PALETTE_MAX, 1)
        assert nbytes <= twf.SMEM_BYTES_MAX and hist_smem == (h == 37)
        plan = twf.scan_cluster_plan(10_000, h, twf.INDEX_PALETTE_MAX, geom,
                                     capacity=lambda pl: 1)
        assert plan.n == 1


def _budget(geom, h, p, n, score, hist_smem):
    """The layout written out: lut, the packed slice, the whole palette's
    colours, history, and with n > 1 the stage and the candidates."""
    c = 4 if geom.mode in ("ostromoukhov", "perceptual") else 3
    floats = 768 * (geom.mode == "ostromoukhov")
    floats += -(-(4 if score else 3) * -(-p // n) // 4) * 4
    floats += -(-3 * p // 4) * 4 if (n > 1 and p <= twf.PACKED_PALETTE_MAX) else 0
    floats += (-(-geom.ring * c * h // 4) * 4) if hist_smem else 0
    floats += 8 * h if n > 1 else 0
    return 4 * floats


@pytest.mark.parametrize("h", [37, 480, 1080, 2160])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=GEOM_IDS)
def test_smem_budget_every_variant_and_mode(geom, h):
    for p, n, score in ((32, 1, False), (256, 4, True), (1024, 8, True), (1024, 1, False),
                        (2048, 8, False), (4096, 1, False)):
        plan = twf.scan_smem_plan(geom, h, p, n, score)
        assert plan is not None
        nbytes, hist_smem = plan
        assert nbytes == _budget(geom, h, p, n, score, hist_smem) <= twf.SMEM_BYTES_MAX
        # The history moves out only where it does not fit.
        assert hist_smem == (_budget(geom, h, p, n, score, True) <= twf.SMEM_BYTES_MAX)
    # The history in shared memory at 1080p: every ring-4 and ring-8 geometry
    # at the main path's 256 colours; jjn and stucki (ring 16) keep theirs in
    # device memory.
    if h == 1080:
        assert twf.scan_smem_plan(geom, h, 256, 4)[1] == (geom.ring <= 8)


def _sliced_search(keys, bounds):
    """numpy model of the kernel: each rank's running minimum over its slice
    (strict <, first wins), then the merge of the ranks' (key, index) in rank
    order (strict <)."""
    cands = []
    for lo, hi in zip(bounds, bounds[1:]):
        best_i = lo
        for p in range(lo + 1, hi):
            if keys[p] < keys[best_i]:
                best_i = p
        cands.append((keys[best_i], best_i))
    best, best_i = cands[0]
    for k, i in cands[1:]:
        if k < best:
            best, best_i = k, i
    return best_i


@pytest.mark.parametrize("p, n", [(p, n) for p in (2, 3, 7, 33, 65, 100, 1023)
                                  for n in (1, 2, 4, 8) if n <= p])
def test_rank_order_merge_is_the_first_extremum(p, n):
    rng = np.random.RandomState(p * 10 + n)
    bounds = twf.palette_slices(p, n)
    for trial in range(40):
        # Few distinct float32 values: many exact ties, inside slices and
        # across their boundaries.
        keys = rng.randint(0, 4, p).astype(np.float32) * np.float32(0.37)
        if trial % 2 and n > 1:
            # The colour at hi_r - 1 repeated at hi_r for every boundary.
            for hi in bounds[1:-1]:
                keys[hi] = keys[hi - 1] = keys.min()
        # Exact search: first strict minimum of the distance.
        assert _sliced_search(keys, bounds) == int(np.argmin(keys))
        # Score search: the kernel keeps the first strict minimum of the
        # negated score, which is the first strict maximum of the score.
        score = keys - np.float32(0.5)
        assert _sliced_search(-score, bounds) == int(np.argmax(score))


def test_merge_keeps_the_lower_slice_on_a_boundary_tie():
    bounds = twf.palette_slices(64, 8)
    keys = np.full(64, 9.0, np.float32)
    keys[7] = keys[8] = 1.0  # colour 7 ends rank 0's slice, 8 starts rank 1's
    assert bounds[1] == 8 and _sliced_search(keys, bounds) == 7
