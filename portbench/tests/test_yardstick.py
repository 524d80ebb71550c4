"""The generator, the metric arithmetic and the roofline's counts."""

from __future__ import annotations

import json
import statistics

import numpy as np
import pytest
import torch

from portbench import frames, readers, roofline, stats
from portbench.readers import Context, idle_pct, scan_roofline_pct
from portbench.trace import Trace

from bench_cells import ROOT, tiny_cell

TRAFFIC = ROOT / "portbench" / "traffic"


@pytest.mark.parametrize("mix", ["stream-1080p", "image-1080p"])
def test_pool_repeats_from_a_seed_and_differs_across_seeds(mix):
    traffic = json.loads((TRAFFIC / f"{mix}.json").read_text())
    traffic.update(height=24, width=40, pool=7)
    cpu = torch.device("cpu")
    a = frames.make_pool(traffic, 2**31 + 7, cpu)
    b = frames.make_pool(traffic, 2**31 + 7, cpu)
    c = frames.make_pool(traffic, 2**31 + 8, cpu)
    assert a.shape == (7, 24, 40, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # Frames move: consecutive frames differ, and a frame is not flat.
    assert not np.array_equal(a[0], a[1])
    assert a[0].std() > 5.0


def test_scene_draw_has_the_same_sizes_for_every_seed():
    scene = tiny_cell("fs-km32.stream-1080p").traffic["scene"]
    shapes = [{k: v.shape for k, v in frames.scene_params(scene, s, 24, 40).items()}
              for s in (0, 1, 2**40)]
    assert shapes[0] == shapes[1] == shapes[2]


def test_rate_and_all_sample_percentile():
    assert stats.rate(300, 20.0) == 15.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    values = list(range(1, 101))  # 1..100
    assert stats.percentile(values, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / 12.5)


def test_interval_union_gaps_and_coverage():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (10, 9)]
    assert stats.union(iv) == [(0, 3), (5, 7)]
    assert stats.covered(iv, 1, 6) == 3
    assert stats.gaps(iv, -1, 8) == [(-1, 0), (3, 5), (7, 8)]


def test_idle_share_from_a_trace():
    tr = Trace(device=[("k", "kernel", 0, 20), ("k", "kernel", 10, 30),
                       ("Memcpy DtoH", "d2h", 50, 80)], window=(0, 100))
    ctx = Context(kind="stream", trace=tr, counters={"batches": 1})
    assert idle_pct(ctx, "stream") == pytest.approx(40.0)  # busy 0-30 and 50-80
    assert idle_pct(ctx, "image") is None
    assert idle_pct(Context(kind="stream", trace=Trace(window=(0, 100))), "stream") is None
    # Two cards: the busy time is the mean of each card's union.
    two = Trace(device=[("k", "kernel", 0, 20, 0), ("k", "kernel", 10, 30, 0),
                        ("k", "kernel", 0, 80, 1)], window=(0, 100), cards=2)
    assert two.busy_seconds() == pytest.approx((30 + 80) / 2 * 1e-9)


@pytest.mark.parametrize("p, flops, n_bytes, by", [
    # 16 x 1080p, s = 2, 4 weights: D = 1920 + 2*1079 = 4078 steps.
    (32, 16 * 1080 * 1920 * (24 + 256 + 3), 4078 * 3 * 16 * 1080 + 32 * 12 + 4078 * 16 * 1080 * 4,
     "bytes"),
    (256, 16 * 1080 * 1920 * (24 + 2048 + 3),
     4078 * 3 * 16 * 1080 + 256 * 12 + 4078 * 16 * 1080 * 4, "ops"),
])
def test_scan_work_at_32_and_256_colours(p, flops, n_bytes, by):
    w = roofline.scan_work(16, 1080, 1920, 2, p, 4, 1)
    assert w["steps"] == 4078
    assert w["flops"] == flops and w["bytes"] == n_bytes
    assert w["bound_s"] == max(w["ops_s"], w["bytes_s"])
    assert w["bound_s"] == (w["ops_s"] if by == "ops" else w["bytes_s"])
    # The bounds PERF.md gives for these launches: 0.1472 and 1.0275 ms.
    assert w["bound_s"] * 1e3 == pytest.approx(0.1472 if p == 32 else 1.0275, abs=1e-4)
    assert w["chain_bound_s"] == pytest.approx(4078 * 0.1e-6)


def test_scan_roofline_share_counts_each_launch_once():
    bound = roofline.scan_work(16, 1080, 1920, 2, 32, 4, 1)
    tr = Trace(device=[("void ed_scan_kernel<1>(...)", "kernel", 0, 10_000_000),
                       ("void ed_scan_kernel<1>(...)", "kernel", 20_000_000, 30_000_000),
                       ("skew_tile_kernel", "kernel", 10_000_000, 11_000_000)],
               window=(0, 40_000_000))
    ctx = Context(kind="stream", trace=tr, counters={"batches": 2}, scan=bound)
    share = scan_roofline_pct(ctx, "stream")
    assert share == pytest.approx(bound["bound_s"] / 10e-3 * 100)
    assert 0 < share < 100
    assert scan_roofline_pct(Context(kind="stream", trace=Trace(window=(0, 1)), scan=bound),
                             "stream") is None


def test_kernel_time_a_frame_leaves_copies_out():
    tr = Trace(device=[("void ed_scan_kernel<4>(...)", "kernel", 0, 20_000_000),
                       ("skew_tile_kernel", "kernel", 10_000_000, 12_000_000),
                       ("Memcpy DtoH (Device -> Pageable)", "d2h", 20_000_000, 70_000_000),
                       ("Memset (Device)", "memset", 70_000_000, 71_000_000)],
               window=(0, 80_000_000))
    for kind in ("stream", "image"):
        ctx = Context(kind=kind, trace=tr, counters={"frames": 4})
        # Two kernels overlap: each one's time counts, 22 ms over 4 frames.
        assert readers.kernel_ms_per_frame(ctx) == pytest.approx(5.5)
    assert readers.kernel_ms_per_frame(Context(kind="stream", trace=None,
                                               counters={"frames": 4})) is None
    no_kernel = Trace(device=[("Memcpy HtoD", "h2d", 0, 10)], window=(0, 10))
    assert readers.kernel_ms_per_frame(Context(kind="stream", trace=no_kernel,
                                               counters={"frames": 4})) is None


def test_rate_and_tails_per_layer_take_the_whole_window():
    lat = [0.1] * 95 + [1.0] * 5
    ctx = Context(kind="stream", trace=None, latencies=lat, seconds=50.0)
    assert readers.frames_per_s(ctx) == pytest.approx(2.0)
    assert readers.p95_ms(ctx, "stream") == pytest.approx(stats.percentile(lat, 95) * 1e3)
    assert readers.p95_ms(ctx, "image") is None
    assert readers.frames_per_s(Context(kind="image", trace=None, latencies=lat,
                                        seconds=50.0)) is None
    assert readers.frames_per_s(Context(kind="stream", trace=None, seconds=50.0)) is None


@pytest.mark.parametrize("name", ["kernel_ms_per_frame", "fps.stream_dense",
                                  "frame_p95_ms.stream_dense", "launches_per_batch.stream_dense",
                                  "scan_ms.stream_dense", "scan_roofline.stream_dense",
                                  "call_p95_ms.image"])
def test_every_reader_returns_nothing_from_an_empty_run(name):
    ctx = Context(kind="stream" if "stream" in name else "image", trace=None)
    assert readers.read_metric(name, ctx) is None
