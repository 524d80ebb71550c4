"""K7, the transposing skew of the port (ops.wavefront.skew_transpose), on
the CPU: its plain PyTorch version held against K1's and K6's plain
versions and against the JAX package's Pallas kernel
``_skew_transpose_call`` in interpret mode, and the routing: on the card
K7 is the type pairs of K1's and K6's tile kernel (``skew.cu``), and
``skew`` / ``skew_planar`` send frames of either dtype to K1 / K6 (the
kernel's walk is held in test_torch_skew_tiles.py and
test_torch_planar_tiles.py, widths W <= s here too).

Tolerances: none. Skewing moves values and casts uint8 to float32, both
exact, so every comparison is bitwise. The JAX kernel's input shows other
rows' pixels outside the image's parallelogram (its scan masks them), so it
is compared on the parallelogram; the port's streams are compared
everywhere (they hold 0 outside).

chip_smoke.py holds the CUDA kernel to the same plain version on the card.
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu.ops import wavefront as jwf
import dither_pie_tpu as jdpt
import dither_pie_tpu_torch as tdpt
from dither_pie_tpu_torch.kernels import build
from dither_pie_tpu_torch.ops import wavefront as twf
from test_torch_skew_tiles import skew_model
import torch_workers  # noqa: F401

DTYPES = {"u8": np.uint8, "f32": np.float32}


def _frames(b, h, w, seed, dtype):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    return rng.uniform(-8.0, 263.0, (b, h, w, 3)).astype(np.float32)


def _planes(frames):
    """(B, H, W, 3) -> (3B, H, W), rows c*B + b."""
    b, h, w, _ = frames.shape
    return np.ascontiguousarray(frames.transpose(3, 0, 1, 2)).reshape(3 * b, h, w)


def _inside(h, w, s):
    """(D, H) bool: where d - s*y lies inside the image."""
    d = np.arange(twf.stream_length(h, w, s))[:, None]
    x = d - s * np.arange(h)[None, :]
    return (x >= 0) & (x < w)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("b,h,w", [(3, 13, 21), (1, 37, 53), (2, 5, 4)])
def test_plain_equals_k1_and_k6_everywhere(b, h, w, dtype, s):
    frames = _frames(b, h, w, 1, dtype)
    nhwc, planes = torch.from_numpy(frames), torch.from_numpy(_planes(frames))
    want = twf.skew_plain(nhwc, s)
    assert want.shape == (twf.stream_length(h, w, s), 3 * b, h)
    assert _same_bits(twf.skew_transpose_plain(nhwc, s), want)
    assert _same_bits(twf.skew_transpose_plain(planes, s), want)
    assert _same_bits(twf.skew_planar_plain(planes, s), want)
    # The wrappers run the plain versions on CPU tensors and launch nothing;
    # float32 frames and planes too give K1's plain stream.
    assert _same_bits(twf.skew_transpose(nhwc, s), want)
    assert _same_bits(twf.skew_transpose(planes, s), want)
    assert _same_bits(twf.skew(nhwc, s), want)
    assert _same_bits(twf.skew_planar(planes, s), want)
    assert not build.LAUNCHES


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("layout", ["nhwc", "planes"])
def test_u8_to_f32_is_the_cast_of_the_u8_stream(layout, s):
    frames = _frames(2, 9, 14, 2, np.uint8)
    x = torch.from_numpy(frames if layout == "nhwc" else _planes(frames))
    got = twf.skew_transpose(x, s, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert _same_bits(got, twf.skew_transpose_plain(x, s).to(torch.float32))
    assert _same_bits(got, twf.skew_plain(torch.from_numpy(frames), s).to(torch.float32))


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_narrow_widths(dtype, w, s):
    """W <= s: the plain version pads every row to D + s and serves any
    width; the card's tile kernel needs no view and serves them too: its
    walk (the numpy model of ``skew.cu``, with the plan K7 launches) gives
    the plain stream, NHWC and planes, in each of K7's type pairs."""
    b, h = 2, 6
    frames = _frames(b, h, w, 3, dtype)
    nhwc, planes = torch.from_numpy(frames), torch.from_numpy(_planes(frames))
    want = twf.skew_plain(nhwc, s)
    assert _same_bits(twf.skew_transpose_plain(nhwc, s), want)
    assert _same_bits(twf.skew_transpose_plain(planes, s), want)
    out_dtypes = (np.uint8, np.float32) if dtype == np.uint8 else (np.float32,)
    for out_dtype in out_dtypes:
        tdt = torch.from_numpy(np.zeros(1, out_dtype)).dtype
        for x, channels in ((frames, 3), (_planes(frames)[..., None], 1)):
            plan = twf.skew_tile_plan(x.shape[0], h, w, s, tdt, 0, channels)
            got = skew_model(x, s, plan, 0, 0, out_dtype=out_dtype)
            assert _same_bits(torch.from_numpy(got), want.to(tdt))


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("case", ["u8", "f32", "u8->f32"])
def test_plain_matches_interpreted_pallas_kernel(case, s):
    """The JAX package's ``_skew_transpose_call`` in interpret mode on its
    own stride-lemma input (rows padded to d_t + s, read again with rows of
    d_t), against the port's plain version on the parallelogram. The Pallas
    kernel always emits float32, so the port's u8 stream is cast for the
    comparison (exact)."""
    b, h, w = 2, 13, 21
    dtype = np.float32 if case == "f32" else np.uint8
    frames = _frames(b, h, w, 5, dtype)
    lf, d_t = 128, 128  # one (8, 128) tile each way
    d_total = twf.stream_length(h, w, s)
    assert d_total <= d_t
    wp = d_t + s
    x = np.pad(frames, ((0, 0), (0, lf - h), (0, wp - w), (0, 0)))
    x = x.transpose(3, 0, 1, 2).reshape(3 * b, lf * wp)[:, : lf * d_t]
    x = x.reshape(3 * b, lf, d_t)
    ref = np.asarray(jwf._skew_transpose_call(3 * b, lf, d_t, x.dtype.name, True)(x))
    assert ref.shape == (d_t, 3 * b, lf) and ref.dtype == np.float32

    out_dtype = torch.float32 if case == "u8->f32" else None
    got = twf.skew_transpose_plain(torch.from_numpy(frames), s, out_dtype)
    assert got.dtype == (torch.uint8 if case == "u8" else torch.float32)
    got = got.numpy().astype(np.float32)
    inside = np.broadcast_to(_inside(h, w, s)[:, None, :], got.shape)
    np.testing.assert_array_equal(got.view(np.uint32)[inside],
                                  ref[:d_total, :, :h].view(np.uint32)[inside])
    assert not got[~inside].any()  # the port's stream: 0 outside the image


@pytest.fixture
def on_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: ``build.on_cuda`` says
    yes and the tile launch is replaced by a stand-in that records the
    output type and channel count it was asked for, computes the plan the
    binding would check, and returns the plain stream of that type."""
    calls = []

    def launch(x, s, out_dtype):
        channels = 3 if x.dim() == 4 else 1
        twf.skew_tile_plan(x.shape[0], x.shape[1], x.shape[2], s, out_dtype, 0, channels)
        calls.append((x.dtype, out_dtype, channels))
        return twf.skew_transpose_plain(x, s, out_dtype)

    monkeypatch.setattr(build, "on_cuda", lambda t: True)
    monkeypatch.setattr(twf, "_launch_skew", launch)
    build.reset_launch_counts()
    yield calls
    build.reset_launch_counts()


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("layout", ["nhwc", "planes"])
def test_card_routes_either_dtype_to_k1_and_k6(on_card, layout, dtype):
    """On the card ``skew`` sends frames of either dtype to K1 and
    ``skew_planar`` planes to K6 (their launch keys; never K7's), in the
    frames' own type, with K1's plain stream as the result."""
    frames = _frames(2, 7, 9, 11, dtype)
    x = torch.from_numpy(frames if layout == "nhwc" else _planes(frames))
    got = twf.skew(x, 2) if layout == "nhwc" else twf.skew_planar(x, 2)
    assert _same_bits(got, twf.skew_plain(torch.from_numpy(frames), 2))
    key = "skew" if layout == "nhwc" else "skew_planar"
    assert dict(build.LAUNCHES) == {key: 1}
    tdt = torch.from_numpy(frames).dtype
    assert on_card == [(tdt, tdt, 3 if layout == "nhwc" else 1)]


@pytest.mark.parametrize("pair", ["u8", "f32", "u8->f32"])
@pytest.mark.parametrize("layout", ["nhwc", "planes"])
def test_card_skew_transpose_is_the_tile_kernel(on_card, layout, pair):
    """K7's wrapper on the card launches the tile kernel in its type pair,
    C = 3 for frames and 1 for planes, and counts under its own key."""
    frames = _frames(2, 7, 9, 12, np.float32 if pair == "f32" else np.uint8)
    x = torch.from_numpy(frames if layout == "nhwc" else _planes(frames))
    out_dtype = torch.float32 if pair == "u8->f32" else None
    got = twf.skew_transpose(x, 3, out_dtype)
    want_dtype = torch.float32 if pair != "u8" else torch.uint8
    assert _same_bits(got, twf.skew_plain(torch.from_numpy(frames), 3).to(want_dtype))
    assert dict(build.LAUNCHES) == {"skew_transpose": 1}
    assert on_card == [(x.dtype, want_dtype, 3 if layout == "nhwc" else 1)]


def test_refusals():
    with pytest.raises(ValueError, match="frames must be"):
        twf.skew_transpose(torch.zeros((2, 3, 4, 5), dtype=torch.uint8), 2)
    with pytest.raises(TypeError, match="uint8 -> uint8"):
        twf.skew_transpose(torch.zeros((2, 3, 4), dtype=torch.float32), 2,
                           out_dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8 -> uint8"):
        twf.skew_transpose(torch.zeros((2, 3, 4), dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        twf.skew_transpose(torch.zeros((2, 3, 4), dtype=torch.uint8, device="meta"), 2)


@pytest.mark.parametrize("planar", [False, True], ids=["nhwc", "planar"])
@pytest.mark.parametrize("variant", ["floyd_steinberg", "jjn"])
def test_float32_batches_are_unchanged(variant, planar):
    """float32 frames reach the stream through K1 (K6 for planes) on the
    card, as uint8 ones do; the function is K7's, so on the CPU the output
    of a float32 batch equals that of the same batch through K7's plain
    stream built by hand."""
    frames = _frames(2, 12, 18, 6, np.float32)
    pal = torch.from_numpy(np.random.RandomState(7).randint(0, 256, (16, 3)).astype(np.float32))
    geom = twf.scan_geometry(variant)
    stream = twf.skew_transpose_plain(torch.from_numpy(frames), geom.s)
    want = twf.unskew_unpack_plain(twf.scan_plain(stream, pal, geom, 18), geom.s, 12, 18,
                                   planar_out=planar)
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames, -1, 0)) if planar else frames)
    got = twf.ed_batch_wavefront(x, pal, variant=variant, planar=planar)
    assert torch.equal(got, want)


def test_float32_facade_output_equals_jax_package():
    """``apply_dithering`` hands the kernels one float32 frame (K1's float32
    form on the card). Its output equals the JAX package's bit for bit
    (both equal the golden engine's f32 twin)."""
    from PIL import Image

    rng = np.random.RandomState(8)
    img = Image.fromarray(rng.randint(0, 256, (20, 27, 3)).astype(np.uint8))
    palette = [tuple(int(v) for v in c) for c in rng.randint(0, 256, (12, 3))]
    params = {"variant": "floyd_steinberg"}
    ref = jdpt.ImageDitherer(num_colors=12, dither_mode=jdpt.DitherMode.ERROR_DIFFUSION,
                             palette=palette, dither_params=params).apply_dithering(img)
    out = tdpt.ImageDitherer(num_colors=12, dither_mode=tdpt.DitherMode.ERROR_DIFFUSION,
                             palette=palette, dither_params=params,
                             device="cpu").apply_dithering(img)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
