"""K7, the transposing skew of the port (ops.wavefront.skew_transpose), on
the CPU: its plain PyTorch version and the free stride-lemma view that the
CUDA kernel reads, held against K1's and K6's plain versions and against
the JAX package's Pallas kernel ``_skew_transpose_call`` in interpret mode.

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
    # The wrappers run the plain versions on CPU tensors and launch nothing.
    assert _same_bits(twf.skew_transpose(nhwc, s), want)
    assert _same_bits(twf.skew_transpose(planes, s), want)
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
    """W <= s: the stride lemma's row stride W - s would be <= 0, which no
    view has. The plain version pads every row to D + s and serves any
    width; the view pads the frames to W = s + 1 first and K7 masks the
    padding with the true width."""
    b, h = 2, 6
    frames = _frames(b, h, w, 3, dtype)
    nhwc, planes = torch.from_numpy(frames), torch.from_numpy(_planes(frames))
    want = twf.skew_plain(nhwc, s)
    assert _same_bits(twf.skew_transpose_plain(nhwc, s), want)
    assert _same_bits(twf.skew_transpose_plain(planes, s), want)
    inside = np.broadcast_to(_inside(h, w, s)[:, None, :], tuple(want.shape))
    for x in (nhwc, planes):
        view = twf._stride_lemma_view(x, s)
        assert view.shape[-1] == twf.stream_length(h, w, s)
        assert min(view.stride()) >= 0
        stream = view.reshape(3 * b, h, -1).permute(2, 0, 1).numpy()
        np.testing.assert_array_equal(stream[inside], want.numpy()[inside])


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("layout", ["nhwc", "planes"])
def test_view_is_free_and_shows_the_stream_on_the_parallelogram(layout, dtype, s):
    """What the CUDA kernel reads: a view of the frames' own buffer (no
    copy), whose element (r, y, d) is the pixel (y, d - s*y) inside the
    image; with the kernel's mask it is the plain version's stream."""
    b, h, w = 3, 11, 17
    frames = _frames(b, h, w, 4, dtype)
    x = torch.from_numpy(frames if layout == "nhwc" else _planes(frames))
    view = twf._stride_lemma_view(x, s)
    assert view.data_ptr() == x.data_ptr()  # the same buffer
    assert view.shape == ((3, b, h, twf.stream_length(h, w, s)) if layout == "nhwc"
                          else (3 * b, h, twf.stream_length(h, w, s)))
    stream = view.reshape(3 * b, h, -1).permute(2, 0, 1)
    inside = torch.from_numpy(_inside(h, w, s))[:, None, :]
    masked = torch.where(inside, stream, torch.zeros((), dtype=stream.dtype))
    assert _same_bits(masked.contiguous(), twf.skew_transpose_plain(x, s))


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
    """float32 frames reach the stream through K7 on the card; the function
    is the one K1 and K6 compute, so on the CPU the output of a float32
    batch equals that of the same batch through the stream built by hand."""
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
    """``apply_dithering`` hands the kernels one float32 frame (K7's path on
    the card). Its output equals the JAX package's bit for bit (both equal
    the golden engine's f32 twin)."""
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
