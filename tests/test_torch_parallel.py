"""The port's data parallelism over local devices (dither_pie_tpu_torch.
parallel.{mesh,sharding,auto} and the facade's auto-mesh) against the JAX
package's and against the port's own single-device path, on the CPU.

PyTorch has one CPU device, so the port's eight-device mesh is
``[cpu] * 8`` (``auto.local_devices`` replaced, the one seam), as the JAX
tests force eight virtual CPU devices (tests/conftest.py). A repeated device
runs every line of the sharded code: the split, the padding, the per-shard
work, the reductions and the gather.

Tolerances: none. The sRGB curves equal JAX's on all 256 uint8 values after
the 8-bit maps; make_mesh's shapes and errors equal JAX's; the sharded
ordered step equals JAX's on a (4, 2) mesh bitwise, its histogram exactly;
the sharded ED step equals the port's single-device run and the golden
engine's float32 twins bitwise in all five modes; the facade with the mesh
on equals the facade with it off bitwise in every batched mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dither_pie_tpu_torch as tdpt
from dither_pie_tpu.core import colors as jcolors
from dither_pie_tpu.core.thresholds import bayer_matrix as j_bayer
from dither_pie_tpu.ops.ordered import tile_screen_device as j_tile
from dither_pie_tpu.parallel import mesh as jmesh
from dither_pie_tpu.parallel import sharding as jsharding
from dither_pie_tpu_torch.api import linkspeed as tlink
from dither_pie_tpu_torch.core import colors as tcolors
from dither_pie_tpu_torch.core.thresholds import bayer_matrix
from dither_pie_tpu_torch.ops import ordered as tord
from dither_pie_tpu_torch.ops import wavefront as twf
from dither_pie_tpu_torch.parallel import auto, mesh as tmesh, sharding as tsharding
from test_torch_ed_modes import _gates, _golden
import torch_workers  # noqa: F401

CPU = torch.device("cpu")
PAL4 = [(0, 0, 0), (255, 255, 255), (200, 40, 40), (30, 90, 200)]


@pytest.fixture
def cpu8(monkeypatch):
    """The seam at eight CPU positions; counts the sharded runs."""
    monkeypatch.setattr(auto, "local_devices", lambda device: [CPU] * 8)
    runs = []
    real_map = tsharding.Lanes.map

    def counting_map(self, work):
        runs.append(len(self.devices))
        return real_map(self, work)

    monkeypatch.setattr(tsharding.Lanes, "map", counting_map)
    return runs


def unique_palette(p, seed):
    rng = np.random.RandomState(seed)
    pal = np.unique(rng.randint(0, 256, (8 * p, 3)), axis=0)
    return pal[rng.permutation(len(pal))[:p]].astype(np.float32)


# ---------------------------------------------------------------------------
# The sRGB curves on the device (core/colors.py)
# ---------------------------------------------------------------------------

def test_curves_match_jax_on_every_u8_value():
    """The forward curve to the rounded 8-bit linear value and the inverse
    to the truncated u8, as the sharded ordered step uses them, on all 256
    inputs: equal to JAX's (float32 pow may differ by an ulp before the
    rounding)."""
    v = np.arange(256, dtype=np.float32)
    t = torch.from_numpy(v)
    c255 = torch.tensor(255.0)
    fwd_j = np.asarray(jnp.round(jnp.clip(jcolors.srgb_to_linear(jnp.asarray(v) / 255.0)
                                          * 255.0, 0, 255)))
    fwd_t = torch.round((tcolors.srgb_to_linear(t / c255) * c255).clamp(0, 255)).numpy()
    np.testing.assert_array_equal(fwd_t, fwd_j)
    inv_j = np.asarray(jnp.clip(jcolors.linear_to_srgb(jnp.clip(jnp.asarray(v) / 255.0, 0, 1))
                                * 255.0, 0, 255).astype(jnp.uint8))
    inv_t = (tcolors.linear_to_srgb((t / c255).clamp(0, 1)) * c255).clamp(0, 255)
    np.testing.assert_array_equal(inv_t.to(torch.uint8).numpy(), inv_j)
    # The host twins agree with the device curves after the same maps.
    np.testing.assert_array_equal(
        np.round(np.clip(tcolors.srgb_to_linear_np(v / np.float32(255.0)) * 255.0, 0, 255)),
        fwd_t)
    # The power branch never sees a negative base.
    assert torch.isfinite(tcolors.linear_to_srgb(torch.tensor([-1.0, 0.0, 2.0]))).all()


# ---------------------------------------------------------------------------
# make_mesh (parallel/mesh.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,names", [
    (None, ("data", "space")), ((8, 1), ("data", "space")), ((4, 2), ("data", "space")),
    ((2, 4), ("data", "space")), ((8,), ("data",)), (None, ("data",))])
def test_make_mesh_matches_jax(shape, names):
    j = jmesh.make_mesh(shape, names)
    t = tmesh.make_mesh(shape, names, devices=[CPU] * 8)
    assert t.devices.shape == j.devices.shape
    assert t.axis_names == tuple(j.axis_names)
    assert t.shape == dict(j.shape)
    assert t.size == j.size == 8
    assert all(d == CPU for d in t.devices.flat)


@pytest.mark.parametrize("shape", [(3,), (4, 4), (3, 2), (16, 1)])
def test_make_mesh_shape_errors_match_jax(shape):
    names = ("data",) if len(shape) == 1 else ("data", "space")
    with pytest.raises(ValueError, match="does not match"):
        jmesh.make_mesh(shape, names)
    with pytest.raises(ValueError, match="does not match"):
        tmesh.make_mesh(shape, names, devices=[CPU] * 8)


def test_partition_specs_and_placement():
    m = tmesh.make_mesh((4, 2), devices=[CPU] * 8)
    assert tmesh.frames_sharding(m).spec == ("data", "space", None, None)
    assert tmesh.replicated(m).spec == ()
    x = np.arange(8 * 6 * 5 * 3, dtype=np.int32).reshape(8, 6, 5, 3)
    placed = tsharding.shard_frames(m, x)
    assert len(placed.shards) == 8
    # Position (i, j) holds frames 2i..2i+1, rows 3j..3j+2.
    np.testing.assert_array_equal(placed.shards[3].numpy(), x[2:4, 3:6])
    np.testing.assert_array_equal(placed.gather().numpy(), x)
    rep = tmesh.device_put(x, tmesh.replicated(m))
    assert all(np.array_equal(s.numpy(), x) for s in rep.shards)
    with pytest.raises(ValueError, match="does not divide"):
        tsharding.shard_frames(m, x[:6, :5])
    # The data axis' pieces of a batch: one a row of the mesh.
    pieces = tmesh.axis_pieces(x, m)
    assert [p.shape[0] for p in pieces] == [2] * 4
    np.testing.assert_array_equal(pieces[2].numpy(), x[4:6])
    placed_batch = tmesh.device_put(x, tmesh.NamedSharding(m, ("data",)))
    assert all(a is b for a, b in zip(tmesh.axis_pieces(placed_batch, m),
                                      placed_batch.shards[::2]))


# ---------------------------------------------------------------------------
# The sharded ordered step against JAX's on (4, 2) meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [8, 300], ids=["p8", "p300"])
@pytest.mark.parametrize("use_gamma", [False, True], ids=["linear", "gamma"])
def test_sharded_ordered_step_matches_jax(use_gamma, p):
    b, h, w = 8, 16, 24
    rng = np.random.RandomState(3 + p)
    frames = rng.randint(0, 256, (b, h, w, 3), dtype=np.uint8)
    pal = unique_palette(p, 7)
    jm = jmesh.make_mesh((4, 2))
    jstep = jsharding.make_sharded_ordered_step(jm, use_gamma=use_gamma)
    j_out, j_hist = jstep(jsharding.shard_frames(jm, frames), jnp.asarray(pal),
                          j_tile(jnp.asarray(j_bayer("4x4")), h, w))
    tm = tmesh.make_mesh((4, 2), devices=[CPU] * 8)
    tstep = tsharding.make_sharded_ordered_step(tm, use_gamma=use_gamma)
    screen = tord.screen_for_matrix(bayer_matrix("4x4"), h, w, "cpu")
    for arg in (frames, tsharding.shard_frames(tm, frames)):
        t_out, t_hist = tstep(arg, torch.from_numpy(pal), screen)
        out = t_out.gather().numpy()
        assert out.dtype == np.uint8 and out.shape == frames.shape
        np.testing.assert_array_equal(out, np.asarray(j_out))
        np.testing.assert_array_equal(t_hist.numpy(), np.asarray(j_hist))
        assert int(t_hist.sum()) == b * h * w


def test_palette_index_is_the_first_row():
    pal = torch.tensor([[1.0, 2, 3], [9, 9, 9], [1.7, 2, 3], [0, 0, 0]])
    colours = torch.tensor([[[1, 2, 3], [0, 0, 0], [9, 9, 9]]], dtype=torch.uint8)
    assert tsharding.palette_index(colours, pal).tolist() == [[0, 3, 1]]


# ---------------------------------------------------------------------------
# The data-parallel ED step: all five modes on four positions
# ---------------------------------------------------------------------------

ED_CASES = [("fixed", {"variant": "floyd_steinberg"}), ("fixed", {"variant": "jjn"}),
            ("ostromoukhov", {}), ("hybrid", {"lum_factor": 0.7, "col_factor": 0.45}),
            ("perceptual", {}), ("adaptive", {})]


@pytest.mark.parametrize("mode,kw", ED_CASES,
                         ids=[m + "-" + kw.get("variant", "") for m, kw in ED_CASES])
def test_sharded_ed_step_bitwise(mode, kw):
    b, h, w, p = 8, 12, 17, 6
    frames = np.random.RandomState(11).randint(0, 256, (b, h, w, 3), dtype=np.uint8)
    pal = unique_palette(p, 12)
    aux = _gates(frames).astype(np.uint8) if mode == "adaptive" else None
    m = tmesh.make_mesh((4,), ("data",), devices=[CPU] * 4)
    run = tsharding.make_sharded_ed_step(m, h, w, p, b // 4, mode=mode, **kw)
    out, err = run(frames, pal, aux)
    got = out.gather().numpy()
    assert [s.shape[0] for s in out.shards] == [2] * 4
    # One device, the whole batch (perceptual's map built from the frames).
    single = twf.ed_batch_wavefront(
        torch.from_numpy(frames), torch.from_numpy(pal), mode,
        aux=None if aux is None else torch.from_numpy(aux.astype(np.float32)), **kw)
    np.testing.assert_array_equal(got, single.numpy())
    gold = np.stack([_golden(f, pal, mode, kw) for f in frames])
    np.testing.assert_array_equal(got, gold)
    want_err = np.mean([np.abs(got[i:i + 2].astype(np.float32) - frames[i:i + 2]).mean()
                        for i in range(0, b, 2)])
    assert float(err) > 0
    np.testing.assert_allclose(float(err), want_err, rtol=1e-6)


def test_sharded_ed_step_checks_its_input():
    m = tmesh.make_mesh((2,), ("data",), devices=[CPU] * 2)
    frames = np.zeros((4, 5, 6, 3), np.uint8)
    with pytest.raises(ValueError, match="aux"):
        tsharding.make_sharded_ed_step(m, 5, 6, 2, 2, mode="adaptive")(
            frames, np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="expected frames"):
        tsharding.make_sharded_ed_step(m, 5, 6, 2, 1)(frames, np.zeros((2, 3), np.float32))


# ---------------------------------------------------------------------------
# The facade: DITHER_PIE_TPU_AUTO_MESH=0 against =1, bitwise (the port's
# twins of tests/test_multihost.py's auto-mesh tests)
# ---------------------------------------------------------------------------

def _single_and_sharded(monkeypatch, d, frames):
    monkeypatch.setenv("DITHER_PIE_TPU_AUTO_MESH", "0")
    single = d.apply_dithering_batch(frames)
    monkeypatch.setenv("DITHER_PIE_TPU_AUTO_MESH", "1")
    return single, d.apply_dithering_batch(frames)


def test_auto_mesh_ed_batch_matches_single(monkeypatch, cpu8):
    """b = 10 over 8 positions: padded to 16 with the last frame, cropped."""
    frames = np.random.RandomState(5).randint(0, 256, (10, 24, 32, 3), dtype=np.uint8)
    d = tdpt.ImageDitherer(num_colors=4, dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                           palette=list(PAL4), dither_params={"variant": "floyd_steinberg"},
                           device="cpu")
    single, sharded = _single_and_sharded(monkeypatch, d, frames)
    assert cpu8 == [8]
    np.testing.assert_array_equal(sharded, single)


def test_auto_mesh_ordered_batch_matches_single(monkeypatch, cpu8):
    """b = 16 shards; b = 10 does not divide and runs on one device."""
    frames = np.random.RandomState(6).randint(0, 256, (16, 24, 32, 3), dtype=np.uint8)
    d = tdpt.ImageDitherer(num_colors=4, dither_mode=tdpt.DitherMode.BAYER,
                           palette=list(PAL4), dither_params={"size": "4x4"}, device="cpu")
    single, sharded = _single_and_sharded(monkeypatch, d, frames)
    assert cpu8 == [8]
    np.testing.assert_array_equal(sharded, single)
    odd = d.apply_dithering_batch(frames[:10])
    assert cpu8 == [8]
    np.testing.assert_array_equal(odd, single[:10])


@pytest.mark.parametrize("mode,params", [
    ("ostromoukhov", {}),
    ("hybrid", {"lum_factor": 1.0, "col_factor": 0.2}),
    ("perceptual", {}),
    ("adaptive_variance", {"var_threshold": 100.0}),
    ("wavelet", {"wavelet": "haar", "subband_quant": 8}),
    ("halftone", {"cell_size": 4}),
    ("none", {}),
    ("blue_noise", {"size": 32}),
])
def test_auto_mesh_covers_whole_strategy_surface(monkeypatch, cpu8, mode, params):
    frames = np.random.RandomState(7).randint(0, 256, (10, 24, 32, 3), dtype=np.uint8)
    d = tdpt.ImageDitherer(num_colors=4, dither_mode=tdpt.DitherMode(mode),
                           palette=list(PAL4), dither_params=dict(params), device="cpu")
    frames = frames if mode not in ("none", "blue_noise") else frames[:8]
    single, sharded = _single_and_sharded(monkeypatch, d, frames)
    assert cpu8 == [8]
    np.testing.assert_array_equal(sharded, single)


def test_auto_mesh_gamma_and_large_palettes(monkeypatch, cpu8):
    """The gamma path, 300 colours (the packed scan), and 1100 colours
    (above PACKED_PALETTE_MAX: one device)."""
    frames = np.random.RandomState(9).randint(0, 256, (4, 12, 20, 3), dtype=np.uint8)
    for colours, runs in ((300, [8]), (1100, [])):
        cpu8.clear()
        pal = [tuple(int(c) for c in row) for row in unique_palette(colours, 2)]
        d = tdpt.ImageDitherer(num_colors=colours, dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                               palette=pal, use_gamma=True,
                               dither_params={"variant": "atkinson"}, device="cpu")
        single, sharded = _single_and_sharded(monkeypatch, d, frames)
        assert cpu8 == runs
        np.testing.assert_array_equal(sharded, single)


def test_auto_mesh_dense_search_stays_on_one_device(monkeypatch, cpu8):
    """Above 64 colours a search other than the exact one runs on one
    device (the first-batch gate is a single-device decision)."""
    frames = np.random.RandomState(8).randint(0, 256, (8, 12, 16, 3)).astype(np.uint8)
    pal = unique_palette(100, 42)
    monkeypatch.setenv("DITHER_PIE_TPU_AUTO_MESH", "1")
    assert auto.maybe_sharded_ed(frames, pal, dense_search="mxu", device="cpu") is None
    assert auto.maybe_sharded_ed(frames, pal[:64], dense_search="mxu", device="cpu") is not None
    sharded = auto.maybe_sharded_ed(frames, pal, dense_search="exact", device="cpu")
    np.testing.assert_array_equal(
        sharded, twf.ed_batch_wavefront(torch.from_numpy(frames), torch.from_numpy(pal)).numpy())


def test_auto_mesh_serpentine_and_planar_stay_on_one_device(monkeypatch, cpu8):
    frames = np.random.RandomState(4).randint(0, 256, (8, 12, 16, 3), dtype=np.uint8)
    monkeypatch.setenv("DITHER_PIE_TPU_AUTO_MESH", "1")
    serp = tdpt.ImageDitherer(num_colors=4, dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                              palette=list(PAL4),
                              dither_params={"variant": "floyd_steinberg", "serpentine": "true"},
                              device="cpu")
    serp.apply_dithering_batch(frames)
    d = tdpt.ImageDitherer(num_colors=4, dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                           palette=list(PAL4), device="cpu")
    planar = d.apply_dithering_batch(np.ascontiguousarray(frames.transpose(3, 0, 1, 2)),
                                     planar=True)
    assert cpu8 == []
    np.testing.assert_array_equal(planar.transpose(1, 2, 3, 0), d.apply_dithering_batch(frames))
    assert cpu8 == [8]


# ---------------------------------------------------------------------------
# The index stream against the mesh, and the default-on rule
# ---------------------------------------------------------------------------

def test_index_stream_precedence(monkeypatch, cpu8):
    """Where the mesh may serve the batch it wins over a measured link; an
    explicit DITHER_PIE_TPU_INDEX_TRANSFER=1 and a planar batch take the
    index stream under the mesh; with the mesh off the link decides."""
    frames = np.random.RandomState(3).randint(0, 256, (8, 12, 16, 3), dtype=np.uint8)
    d = tdpt.ImageDitherer(num_colors=4, dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                           palette=list(PAL4), device="cpu")
    calls = []
    cls = tdpt.ErrorDiffusionDitherStrategy
    real = cls.dither_batch_indices
    monkeypatch.setattr(cls, "dither_batch_indices",
                        lambda self, *a, **k: calls.append(k.get("planar")) or real(self, *a, **k))
    monkeypatch.delenv("DITHER_PIE_TPU_INDEX_TRANSFER", raising=False)
    monkeypatch.setattr(tlink, "index_transfer_wins", lambda device: True)
    monkeypatch.setenv("DITHER_PIE_TPU_AUTO_MESH", "1")
    want = d.apply_dithering_batch(frames)  # the mesh, RGB
    assert calls == [] and cpu8 == [8]
    planes = np.ascontiguousarray(frames.transpose(3, 0, 1, 2))
    planar = d.apply_dithering_batch(planes, planar=True)
    assert calls == [True]
    np.testing.assert_array_equal(planar.transpose(1, 2, 3, 0), want)
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "1")  # forced: the stream
    np.testing.assert_array_equal(d.apply_dithering_batch(frames), want)
    assert calls == [True, False] and cpu8 == [8]
    monkeypatch.delenv("DITHER_PIE_TPU_INDEX_TRANSFER")
    monkeypatch.setenv("DITHER_PIE_TPU_AUTO_MESH", "0")  # no mesh: the link decides
    np.testing.assert_array_equal(d.apply_dithering_batch(frames), want)
    assert calls == [True, False, False] and cpu8 == [8]


def test_auto_mesh_default_rule(monkeypatch):
    monkeypatch.delenv("DITHER_PIE_TPU_AUTO_MESH", raising=False)
    assert auto.local_devices("cpu") == [CPU]
    assert not auto.auto_mesh_enabled("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert auto.local_devices("cuda:0") == [torch.device("cuda", i) for i in range(3)]
    assert auto.auto_mesh_enabled("cuda")
    monkeypatch.setattr(auto, "local_devices", lambda device: [CPU] * 8)
    assert auto.auto_mesh_enabled("cpu")
    monkeypatch.setenv("DITHER_PIE_TPU_AUTO_MESH", "0")
    assert not auto.auto_mesh_enabled("cpu")
    monkeypatch.setenv("DITHER_PIE_TPU_AUTO_MESH", "1")
    assert auto.auto_mesh_enabled("cpu")
    monkeypatch.setattr(auto, "local_devices", lambda device: [CPU])
    # Forced on with one device: nothing to shard over.
    assert auto.maybe_sharded_map("halftone", (1,), np.zeros((2, 4, 4, 3), np.uint8),
                                  device="cpu") is None


def test_facade_is_on_by_default_with_several_devices(monkeypatch, cpu8):
    monkeypatch.delenv("DITHER_PIE_TPU_AUTO_MESH", raising=False)
    frames = np.random.RandomState(2).randint(0, 256, (8, 8, 8, 3), dtype=np.uint8)
    d = tdpt.ImageDitherer(num_colors=4, dither_mode=tdpt.DitherMode.BAYER,
                           palette=list(PAL4), device="cpu")
    d.apply_dithering_batch(frames)
    assert cpu8 == [8]
