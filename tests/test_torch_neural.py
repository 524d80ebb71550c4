"""The port's neural pixelizer (dither_pie_tpu_torch.models) against the JAX
package's, on the CPU.

Weights come from ``random_params(seed)`` of both packages (equal bitwise)
and reach the port through ``convert.state_from_jax``; inputs come from
numpy seeds. Tolerances: single layers atol 1e-5, whole forwards
(``style_adain``, ``c2pgen_forward``, ``aliasnet_forward``, the ds4 body)
atol 1e-4 in "float32", uint8 outputs within one step. The converter
round-trips a state dict in the reference's torch layout to the JAX
package's ``convert_*_state`` (the modulated convs' raw view, VGG indices
above 19, ``running_*``), and the CPU-runnable checks of the JAX package's
``tests/test_neural.py`` (shared style, the ds4 sampling and paths, u8
input, the bf16 gate) hold for the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dither_pie_tpu.models import c2pgen as jc
from dither_pie_tpu.models import convert as jconv
from dither_pie_tpu.models import inference as jinf
from dither_pie_tpu.models import layers as jl
from dither_pie_tpu.models import param_shapes as jps
from dither_pie_tpu_torch.models import c2pgen as tc
from dither_pie_tpu_torch.models import convert as tconv
from dither_pie_tpu_torch.models import inference as tinf
from dither_pie_tpu_torch.models import layers as tl
from dither_pie_tpu_torch.models import param_shapes as tps
import torch_workers  # noqa: F401

SEED = 0
FRAMES_HW = (40, 56)  # the u8 path's frames
MAX_SIZE = 16


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, atol):
    got = got if isinstance(got, np.ndarray) else nhwc(got) if got.ndim == 4 else got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.fixture(autouse=True)
def float32_env(monkeypatch):
    for name in ("PRECISION", "U8_IN", "DS4", "DS4_STRIDE"):
        monkeypatch.delenv(f"DITHER_PIE_TPU_NEURAL_{name}", raising=False)


@pytest.fixture(scope="module")
def jparams():
    gen, alias = jps.random_params(SEED)
    return ({k: jnp.asarray(v) for k, v in gen.items()},
            {k: jnp.asarray(v) for k, v in alias.items()})


@pytest.fixture(scope="module")
def model():
    m = tinf.PixelizationModel(device="cpu")
    m.load_random(SEED)
    return m


@pytest.fixture(scope="module")
def jmodel():
    m = jinf.PixelizationModel()
    m.load_random(SEED)
    return m


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_random_params_equal_bitwise(seed):
    for ours, theirs in zip(tps.random_params(seed), jps.random_params(seed)):
        assert list(ours) == list(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype == np.float32
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_modules_hold_the_converted_shapes(model):
    gen, alias = tconv.state_from_jax(*tps.random_params(SEED))
    for net, state in ((model.gen, gen), (model.alias, alias)):
        own = net.state_dict()
        assert set(own) == set(state)
        for k, v in state.items():
            assert own[k].shape == v.shape, k
            torch.testing.assert_close(own[k], v, rtol=0, atol=0)
    # mod_conv_3..8 are loaded though the decoder never reads them.
    assert "RGBDec.mod_conv_8.weight" in model.gen.state_dict()


def _synthetic_reference_state(rng, shapes, extra):
    """A state dict in the reference's torch layout with small, distinct
    dimensions (every transpose shows), plus ``extra`` entries."""
    state = {}
    for k, s in shapes.items():
        state[k] = torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    for k, s in extra.items():
        state[k] = torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return state


GEN_TORCH_SHAPES = {
    "RGBDec.mod_conv_1.weight": (6, 5, 3, 3),
    "RGBDec.mod_conv_1.bias": (6,),
    "RGBDec.conv_1.conv.weight": (4, 6, 5, 5),
    "RGBDec.conv_1.norm.gamma": (4,),
    "MLP.model.0.fc.weight": (7, 3),
    "PBEnc.model.1.weight": (5, 9, 1, 1),
    "PBEnc.vgg.0.weight": (4, 3, 3, 3),
    "PBEnc.vgg.19.bias": (8,),
}
GEN_EXTRA = {"PBEnc.vgg.21.weight": (5, 8, 3, 3), "PBEnc.vgg.34.bias": (3,),
             "RGBEnc.model.0.norm.running_mean": (4,),
             "RGBEnc.model.0.norm.num_batches_tracked": ()}


def test_state_from_jax_round_trips_the_reference_layout():
    rng = np.random.default_rng(1)
    gen = _synthetic_reference_state(rng, GEN_TORCH_SHAPES, GEN_EXTRA)
    alias = _synthetic_reference_state(
        rng, {"RGBDec.Res_Blocks.model.0.model.0.conv.weight": (6, 5, 3, 3),
              "RGBDec.conv_3.conv.bias": (3,)},
        {"RGBEnc.model.1.norm.running_var": (5,)})
    vgg = _synthetic_reference_state(
        rng, {"features.0.weight": (4, 3, 3, 3), "features.19.bias": (8,)},
        {"features.21.weight": (5, 8, 3, 3), "classifier.0.weight": (4, 7)})
    to_np = lambda s: {k: v.numpy() for k, v in s.items()}  # noqa: E731

    ours_gen = tconv.generator_state(gen)
    ours_alias = tconv.aliasnet_state(alias)
    assert "PBEnc.vgg.21.weight" not in ours_gen and "PBEnc.vgg.34.bias" not in ours_gen
    assert not any("running_" in k or "num_batches" in k for k in [*ours_gen, *ours_alias])
    # Through the JAX package's layout and back: bitwise the same.
    back_gen, back_alias = tconv.state_from_jax(jconv.convert_generator_state(to_np(gen)),
                                                jconv.convert_aliasnet_state(to_np(alias)))
    assert set(back_gen) == set(ours_gen) and set(back_alias) == set(ours_alias)
    for ours, back in ((ours_gen, back_gen), (ours_alias, back_alias)):
        for k in ours:
            torch.testing.assert_close(back[k], ours[k], rtol=0, atol=0, msg=k)
    # The modulated conv is a raw view, not a transpose.
    jw = jconv.convert_generator_state(to_np(gen))["RGBDec.mod_conv_1.weight"]
    np.testing.assert_array_equal(jw, gen["RGBDec.mod_conv_1.weight"].numpy().reshape(3, 3, 5, 6))
    # The standalone VGG maps to PBEnc.vgg.<idx>, indices <= 19 only.
    ours_vgg = tconv.vgg19_state(vgg)
    back_vgg, _ = tconv.state_from_jax(jconv.convert_vgg19_state(to_np(vgg)), {})
    assert set(ours_vgg) == set(back_vgg) == {"PBEnc.vgg.0.weight", "PBEnc.vgg.19.bias"}
    for k in ours_vgg:
        torch.testing.assert_close(back_vgg[k], ours_vgg[k], rtol=0, atol=0)


def test_checkpoint_dir_loads_as_the_jax_package_converts(tmp_path, monkeypatch, model):
    """The three reference files (VGG taps zeroed in the generator's file:
    pixelart_vgg19.pth is authoritative) and the JAX package's .npz cache
    both load the model load_random gives."""
    gen, alias = tconv.state_from_jax(*tps.random_params(SEED))
    g_file = {k: (v * 0 if k.startswith("PBEnc.vgg.") else v) for k, v in gen.items()}
    g_file["PBEnc.vgg.21.weight"] = torch.ones(3, 3, 3, 3)
    g_file["RGBEnc.model.0.norm.running_mean"] = torch.ones(64)
    vgg = {f"features.{k.split('.')[2]}.{k.split('.')[3]}": v
           for k, v in gen.items() if k.startswith("PBEnc.vgg.")}
    vgg["features.21.weight"] = torch.ones(3, 3, 3, 3)
    a_file = dict(alias, **{"RGBEnc.model.0.norm.num_batches_tracked": torch.tensor(3)})
    pth = tmp_path / "pth"
    pth.mkdir()
    torch.save(g_file, pth / "160_net_G_A.pth")
    torch.save(vgg, pth / "pixelart_vgg19.pth")
    torch.save(a_file, pth / "alias_net.pth")

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DITHER_PIE_TPU_CKPT_DIR", str(pth))
    assert tconv.find_checkpoint_dir() == jconv.find_checkpoint_dir() == str(pth)
    m = tinf.PixelizationModel(device="cpu")
    m.load()
    for ours, want in ((m.gen, model.gen), (m.alias, model.alias)):
        for k, v in want.state_dict().items():
            torch.testing.assert_close(ours.state_dict()[k], v, rtol=0, atol=0, msg=k)

    # The JAX package converts the same files and writes its cache; a
    # directory holding only that cache loads the same weights.
    jconv.convert_checkpoints(str(pth))
    npz = tmp_path / "npz"
    npz.mkdir()
    (pth / tconv.CACHE_NAME).rename(npz / tconv.CACHE_NAME)
    gen_npz, alias_npz = tconv.convert_checkpoints(str(npz))
    for got, want in ((gen_npz, model.gen.state_dict()), (alias_npz, model.alias.state_dict())):
        assert set(got) == set(want)
        for k in got:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_missing_checkpoints_raise_the_same_error(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DITHER_PIE_TPU_CKPT_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError) as ours:
        tconv.find_checkpoint_dir()
    with pytest.raises(FileNotFoundError) as theirs:
        jconv.find_checkpoint_dir()
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(FileNotFoundError):
        tinf.PixelizationModel(device="cpu").load()


# ---------------------------------------------------------------------------
# Layers, atol 1e-5
# ---------------------------------------------------------------------------


def _rand(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def test_instance_norm():
    x = _rand(np.random.RandomState(1), 2, 9, 11, 5, lo=-3, hi=5)
    close(tl.instance_norm(nchw(x)), jl.instance_norm(jnp.asarray(x)), 1e-5)


def test_custom_layer_norm():
    rng = np.random.RandomState(2)
    x, g, b = _rand(rng, 3, 7, 6, 4, lo=-2, hi=3), _rand(rng, 4), _rand(rng, 4)
    close(tl.custom_layer_norm(nchw(x), torch.from_numpy(g), torch.from_numpy(b)),
          jl.custom_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)), 1e-5)


def _block_params(module, prefix):
    """The module's state dict as the JAX package's params under
    ``prefix``."""
    state = {f"{prefix}.{k}": v.detach().numpy() for k, v in module.state_dict().items()}
    return {k: jnp.asarray(v) for k, v in jconv.convert_aliasnet_state(state).items()}


def _init(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.rand(p.shape, generator=g) * 0.4 - 0.2)
    return module.requires_grad_(False)


@pytest.mark.parametrize("per_sample", [False, True], ids=["shared", "per_sample"])
def test_modulated_conv(per_sample):
    rng = np.random.RandomState(3)
    block = _init(tl.ModulationConvBlock(6, 5, 3), 3)
    x = _rand(rng, 3, 8, 10, 6)
    code = rng.uniform(0.5, 1.5, (3 if per_sample else 1, 6)).astype(np.float32)
    p = _block_params(block, "RGBDec.mod_conv_1")
    want = jl.modulated_conv(p, "RGBDec.mod_conv_1", jnp.asarray(x), jnp.asarray(code))
    close(block(nchw(x), torch.from_numpy(code)), want, 1e-5)


CONV_CASES = [  # (cin, cout, k, stride, pad, norm, act, pad_type)
    (3, 8, 7, 1, 3, "in", "relu", "reflect"),
    (4, 6, 4, 2, 1, "in", "relu", "reflect"),
    (6, 4, 5, 1, 2, "ln", "relu", "reflect"),
    (5, 3, 7, 1, 3, "none", "tanh", "reflect"),
    (3, 8, 3, 1, 1, "none", "relu", "zero"),
    (4, 4, 3, 1, 1, "in", "lrelu", "replicate"),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"{c[5]}-{c[6]}-{c[7]}-k{c[2]}s{c[3]}")
def test_conv_block(case):
    cin, cout, k, stride, pad, norm, act, pad_type = case
    block = _init(tl.ConvBlock(cin, cout, k, stride, pad, norm, act, pad_type), k)
    x = _rand(np.random.RandomState(k), 2, 12, 14, cin)
    want = jl.conv_block(_block_params(block, "b"), "b", jnp.asarray(x), stride, pad, norm,
                         act, pad_type)
    close(block(nchw(x)), want, 1e-5)


def test_res_blocks_and_linear_block():
    rng = np.random.RandomState(4)
    blocks = _init(tl.ResBlocks(2, 6, "in", "relu", "reflect"), 4)
    x = _rand(rng, 2, 9, 7, 6)
    want = jl.res_blocks(_block_params(blocks, "r"), "r", jnp.asarray(x), 2, "in", "relu",
                         "reflect")
    close(blocks(nchw(x)), want, 1e-5)
    lin = _init(tl.LinearBlock(5, 7, "relu"), 5)
    v = _rand(rng, 3, 5)
    close(lin(torch.from_numpy(v)),
          jl.linear_block(_block_params(lin, "l"), "l", jnp.asarray(v), "relu"), 1e-5)


def test_max_pool_and_upsample():
    x = _rand(np.random.RandomState(5), 2, 10, 14, 3)
    close(tl.max_pool_2x2(nchw(x)), jl.max_pool_2x2(jnp.asarray(x)), 0)
    close(tl.upsample_nearest_2x(nchw(x)), jl.upsample_nearest_2x(jnp.asarray(x)), 0)
    odd = _rand(np.random.RandomState(6), 1, 9, 7, 2)
    close(tl.max_pool_2x2(nchw(odd)), jl.max_pool_2x2(jnp.asarray(odd)), 0)


def test_vgg_features(model, jparams):
    x = _rand(np.random.RandomState(7), 1, 32, 40, 3)
    ours = model.gen.PBEnc.vgg(nchw(x))
    theirs = jc.vgg_features(jparams[0], jnp.asarray(x))
    assert set(ours) == set(theirs) == {"conv1_1", "conv2_1", "conv3_1", "conv4_1"}
    for name in ours:
        close(ours[name], theirs[name], 1e-5)


# ---------------------------------------------------------------------------
# Whole forwards, float32, atol 1e-4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def forwards(jparams):
    """One jitted JAX run of every whole forward at the test shapes."""
    rng = np.random.RandomState(8)
    clip = _rand(rng, 2, 32, 48, 3)
    ref = _rand(rng, 1, 32, 32, 3)
    mid = _rand(rng, 2, 24, 32, 3)
    gp, ap = jparams

    @jax.jit
    def run(clip, ref, mid):
        adain = jc.style_adain(gp, ref)
        return {"adain": adain,
                "c2pgen": jc.c2pgen_forward(gp, clip, ref),
                "c2pgen_adain": jc.c2pgen_forward(gp, clip, adain=adain),
                "alias": jc.aliasnet_forward(ap, mid),
                "alias_ds4": jc.aliasnet_forward_ds4(ap, mid)}

    out = jax.device_get(run(jnp.asarray(clip), jnp.asarray(ref), jnp.asarray(mid)))
    return clip, ref, mid, out


def test_style_adain(model, forwards):
    _, ref, _, want = forwards
    with torch.no_grad():
        close(tc.style_adain(model.gen, nchw(ref)), want["adain"], 1e-4)


def test_c2pgen_forward(model, forwards):
    clip, ref, _, want = forwards
    with torch.no_grad():
        got = tc.c2pgen_forward(model.gen, nchw(clip), nchw(ref))
        adain = tc.style_adain(model.gen, nchw(ref))
        got_adain = tc.c2pgen_forward(model.gen, nchw(clip), adain=adain)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 32, 48)
    close(got, want["c2pgen"], 1e-4)
    close(got_adain, want["c2pgen_adain"], 1e-4)


def test_aliasnet_forward(model, forwards):
    _, _, mid, want = forwards
    with torch.no_grad():
        close(tc.aliasnet_forward(model.alias, nchw(mid)), want["alias"], 1e-4)


def test_aliasnet_body_ds4(model, forwards):
    _, _, mid, want = forwards
    with torch.no_grad():
        got = tc.aliasnet_forward_ds4(model.alias, nchw(mid))
        body = tc._aliasnet_body_ds4(model.alias, nchw(mid))
    assert got.shape == (2, 3, 6, 8)
    close(got, want["alias_ds4"], 1e-4)
    close(body, want["alias_ds4"], 1e-4)


def test_batched_forward_equals_per_frame(model, forwards):
    clip, ref, _, _ = forwards
    with torch.no_grad():
        adain = tc.style_adain(model.gen, nchw(ref))
        batched = tc.c2pgen_forward(model.gen, nchw(clip), adain=adain)
        for i in range(clip.shape[0]):
            single = tc.c2pgen_forward(model.gen, nchw(clip[i:i + 1]), adain=adain)
            torch.testing.assert_close(batched[i:i + 1], single, rtol=0, atol=1e-5)


def test_modulated_conv_shared_style_equals_replicated():
    """A (1, Cin) code with B > 1 takes the dense path; it equals the
    grouped per-sample path fed the replicated code."""
    rng = np.random.RandomState(11)
    block = _init(tl.ModulationConvBlock(16, 12, 3), 11)
    x = torch.from_numpy(rng.randn(4, 16, 8, 8).astype(np.float32))
    code = torch.from_numpy(rng.rand(1, 16).astype(np.float32) + 0.5)
    torch.testing.assert_close(block(x, code), block(x, code.expand(4, 16)), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------


def test_precision_scope_restores_the_switches():
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
              torch.get_float32_matmul_precision())
    with tl.precision_scope("float32"):
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    with tl.precision_scope("tensorfloat32"):
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.backends.cudnn.benchmark is False
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
            torch.get_float32_matmul_precision()) == before
    with pytest.raises(ValueError):
        with tl.precision_scope("float16"):
            pass


def test_building_blocks_keep_float32_outside_a_scope(model):
    """A block called on its own runs in float32 (TF32 off); inside a scope
    the scope's setting holds."""
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*a, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*a, **kw)

    x = nchw(_rand(np.random.RandomState(12), 1, 16, 16, 3))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(torch.nn.functional, "conv2d", spy)
        model.gen.RGBEnc(x)
        assert seen and not any(seen)
        seen.clear()
        with tl.precision_scope("tensorfloat32"):
            model.gen.RGBEnc(x)
        assert seen and all(seen)


def test_bfloat16_mode_output_is_float32_and_close(model):
    """bfloat16 runs bf16 convs and activations with float32 norm
    statistics; its uint8 output stays within the video gate's bounds of
    float32's."""
    x = _rand(np.random.RandomState(13), 2, 32, 32, 3)
    with torch.no_grad():
        adain = model._style()
        f32 = tc.c2pgen_forward(model.gen, nchw(x), adain=adain)
        bf16 = tc.c2pgen_forward(model.gen, nchw(x), adain=adain, precision="bfloat16")
    assert bf16.dtype == torch.float32
    u8 = lambda t: tinf._to_u8(t).numpy().astype(np.int16)  # noqa: E731
    assert np.abs(u8(f32) - u8(bf16)).mean() <= model.BF16_GATE_MEAN_U8_DELTA


def test_norms_keep_float32_statistics_in_bf16():
    x = torch.from_numpy(_rand(np.random.RandomState(14), 2, 5, 40, 40, lo=-4, hi=9))
    xb = x.to(torch.bfloat16)
    got = tl.instance_norm(xb)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, tl.instance_norm(xb.float()).to(torch.bfloat16),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The u8 path and the host helpers
# ---------------------------------------------------------------------------


def test_maybe_normalize_within_an_ulp():
    vals = np.repeat(np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1), 3, axis=-1)
    host = ((vals.astype(np.float32) / 255.0) - 0.5) / 0.5
    ours = tinf._maybe_normalize(torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(ours, host, rtol=0, atol=2.5e-7)
    theirs = np.asarray(jax.jit(jinf._maybe_normalize)(jnp.asarray(vals)))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2.5e-7)
    f32 = torch.from_numpy(host)
    assert tinf._maybe_normalize(f32) is f32


def test_host_helpers_equal_the_jax_package():
    rng = np.random.RandomState(15)
    img = Image.fromarray(rng.randint(0, 256, (37, 910, 3), dtype=np.uint8))
    for fn in ("process", "process_u8"):
        np.testing.assert_array_equal(getattr(tinf, fn)(img), getattr(jinf, fn)(img))
    # round-half-even: 910 -> 912, one zero column each side.
    assert tinf.process_u8(img).shape == (1, 36, 912, 3)
    np.testing.assert_array_equal(np.asarray(tinf.greyscale(img)),
                                  np.asarray(jinf.greyscale(img)))
    for size in (12, 16, 128):
        for im in (img, img.transpose(Image.Transpose.ROTATE_90)):
            np.testing.assert_array_equal(np.asarray(tinf.resize_image_nearest(im, size)),
                                          np.asarray(jinf.resize_image_nearest(im, size)))
    out = rng.uniform(-1, 1, (1, 24, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(tinf.deprocess(out)),
                                  np.asarray(jinf.deprocess(out)))
    assert tinf.downsample4_indices(20) == jinf.downsample4_indices(20)


def test_reference_png_is_the_jax_package_copy():
    ours = Image.open(tinf._REFERENCE_PNG)
    theirs = Image.open(jinf._REFERENCE_PNG)
    assert ours.size == (256, 256)
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    assert "dither_pie_tpu_torch" in str(tinf._REFERENCE_PNG)


def test_ds4_sampling_matches_pil_bitwise():
    rng = np.random.RandomState(11)
    for h, w in ((64, 96), (52, 40), (128, 72)):
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        ref = np.asarray(tinf.deprocess_u8(img))
        ds = img[tinf.downsample4_indices(h), tinf.downsample4_indices(w), :]
        pil_ds = np.asarray(Image.fromarray(img).resize((w // 4, h // 4),
                                                        Image.Resampling.NEAREST))
        np.testing.assert_array_equal(ds, pil_ds)
        np.testing.assert_array_equal(tinf.upsample4_u8(ds), ref)


@pytest.fixture(scope="module")
def u8_batch():
    rng = np.random.RandomState(16)
    return rng.randint(0, 256, (2, *FRAMES_HW, 3), dtype=np.uint8)


@pytest.mark.parametrize("ds4,stride", [(False, False), (True, False), (True, True)],
                         ids=["dense", "ds4", "ds4-stride"])
def test_forward_u8_against_the_jax_package(model, jmodel, u8_batch, ds4, stride):
    ours = model.forward_u8(u8_batch, precision="float32", ds4=ds4, stride=stride)
    theirs = jmodel.forward_u8(u8_batch, precision="float32", ds4=ds4, stride=stride)
    assert ours.dtype == np.uint8 and ours.shape == theirs.shape
    h, w = FRAMES_HW
    assert ours.shape == ((2, h // 4, w // 4, 3) if ds4 else (2, h, w, 3))
    assert np.abs(ours.astype(np.int16) - theirs.astype(np.int16)).max() <= 1


def test_forward_array_against_the_jax_package(model, jmodel, u8_batch):
    x = tinf.process(Image.fromarray(u8_batch[0]))
    ours, theirs = model.forward_array(x), np.asarray(jmodel.forward_array(x))
    assert ours.dtype == np.float32 and ours.shape == x.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)


def test_ds4_strided_conv_matches_dense_slice(model):
    rng = np.random.RandomState(5)
    with torch.no_grad():
        for b, h, w in ((1, 32, 48), (2, 24, 40), (1, 64, 36)):
            x = nchw(rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32))
            dense = tc._aliasnet_body(model.alias, x)[:, :, 2::4, 2::4]
            strided = tc._aliasnet_body_ds4(model.alias, x)
            assert strided.shape == dense.shape
            torch.testing.assert_close(strided, dense, rtol=0, atol=1e-5)


def _frames(seed, n, hw):
    rng = np.random.RandomState(seed)
    return [Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)) for _ in range(n)]


def _fresh(model):
    """A model over the same weights with its gates unset."""
    m = tinf.PixelizationModel.__new__(tinf.PixelizationModel)
    m.__dict__.update(model.__dict__)
    m._video_prec = m._ds4_stride = None
    return m


def test_ds4_batch_path_bit_identical(model, monkeypatch):
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_PRECISION", "float32")
    frames = _frames(3, 3, FRAMES_HW)
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_DS4", "0")
    full = _fresh(model).pixelize_images_batch(frames, MAX_SIZE)
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_DS4", "1")
    ds4 = _fresh(model).pixelize_images_batch(frames, MAX_SIZE)
    for a, b in zip(full, ds4):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ds4_stride_paths(model, monkeypatch):
    """=0 forbids the strided conv, =1 forces it (within the bf16 budget of
    the dense path), unset decides on the first batch (float32 wants
    bitwise equality); either verdict reproduces its forced path."""
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_PRECISION", "float32")
    frames = _frames(9, 2, FRAMES_HW)
    m = _fresh(model)
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_DS4_STRIDE", "0")
    dense = m.pixelize_images_batch(frames, MAX_SIZE)
    assert m._ds4_stride is False
    m2 = _fresh(model)
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_DS4_STRIDE", "1")
    strided = m2.pixelize_images_batch(frames, MAX_SIZE)
    assert m2._ds4_stride is True
    for a, b in zip(dense, strided):
        d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
        assert d.mean() <= 1.0 and d.max() <= 2
    m3 = _fresh(model)
    monkeypatch.delenv("DITHER_PIE_TPU_NEURAL_DS4_STRIDE")
    auto = m3.pixelize_images_batch(frames, MAX_SIZE)
    assert m3._ds4_stride in (True, False)
    for a, b in zip(auto, strided if m3._ds4_stride else dense):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_u8_input_batch_path_matches_f32(model, monkeypatch):
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_PRECISION", "float32")
    frames = _frames(5, 2, (36, 48))
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_U8_IN", "0")
    f32_in = _fresh(model).pixelize_images_batch(frames, 12)
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_U8_IN", "1")
    u8_in = _fresh(model).pixelize_images_batch(frames, 12)
    for a, b in zip(f32_in, u8_in):
        np.testing.assert_allclose(np.asarray(a).astype(np.int16),
                                   np.asarray(b).astype(np.int16), atol=1)


def test_bf16_video_gate_selects_and_falls_back(model, monkeypatch):
    x = np.random.RandomState(7).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    m = _fresh(model)
    out = m._gated_batch_forward(x)
    assert out.dtype == np.uint8
    assert m._video_prec == "bfloat16"  # bf16 and float32 agree on the CPU

    m2 = _fresh(model)
    real_forward = m2.forward_u8

    def skewed(stacked, precision=None, **kw):
        out = real_forward(stacked, precision=precision, **kw)
        if precision == "bfloat16":
            out = np.clip(out.astype(np.int16) + 40, 0, 255).astype(np.uint8)
        return out

    monkeypatch.setattr(m2, "forward_u8", skewed)
    ref = m2._gated_batch_forward(x)
    assert m2._video_prec == "float32"
    np.testing.assert_array_equal(ref, real_forward(x, precision="float32"))

    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_PRECISION", "float32")
    m3 = _fresh(model)
    m3._gated_batch_forward(x)
    assert m3._video_prec == "float32"
    monkeypatch.setenv("DITHER_PIE_TPU_NEURAL_PRECISION", "float16")
    with pytest.raises(ValueError):
        _fresh(model)._gated_batch_forward(x)


def test_pixelize_image_against_the_jax_package(model, jmodel):
    img = _frames(17, 1, (30, 44))[0]
    ours = np.asarray(model.pixelize_image(img, 12)).astype(np.int16)
    theirs = np.asarray(jmodel.pixelize_image(img, 12)).astype(np.int16)
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= 1


def test_the_model_never_drops_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without")
    with pytest.raises(RuntimeError, match="cuda"):
        tinf.PixelizationModel()
