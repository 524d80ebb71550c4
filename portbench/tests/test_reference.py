"""The plain reference against hand-worked cases, a row-major loop, the
program's CPU path, and its control in bfloat16."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import frames
from portbench.references import error_diffusion as reference

from bench_cells import tiny_cell

CPU = torch.device("cpu")
FS = reference.fixed_entries([[1, 0, 7], [-1, 1, 3], [0, 1, 5], [1, 1, 1]], 16)
GREY = np.array([[0, 0, 0], [255, 255, 255]])


def grey(values):
    a = np.asarray(values, dtype=np.uint8)
    return np.repeat(a[None, ..., None], 3, axis=-1)  # (1, H, W, 3)


def row_major(img: np.ndarray, pal: np.ndarray, entries) -> np.ndarray:
    """The sequential scan pixel by pixel in float32 scalars: the textbook
    loop the wavefront form must equal."""
    h, w, _ = img.shape
    buf = img.astype(np.float32).copy()
    palf = pal.astype(np.float32)
    out = np.zeros_like(img)
    for y in range(h):
        for x in range(w):
            cur = np.clip(buf[y, x], np.float32(0), np.float32(255))
            diff = cur[None, :] - palf
            sq = diff * diff
            dist = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
            k = int(np.argmin(dist))  # first minimum
            out[y, x] = pal[k]
            err = cur - palf[k]
            for dx, dy, wt in entries:
                tx, ty = x + dx, y + dy
                if 0 <= tx < w and ty < h:
                    buf[ty, tx] = buf[ty, tx] + err * np.float32(wt)
    return out


def test_skew_and_weights_of_floyd_steinberg():
    assert reference.skew_of(FS) == 2
    assert [w for _, _, w in FS] == [7 / 16, 3 / 16, 5 / 16, 1 / 16]


def test_hand_worked_row():
    # 100 -> 0 (nearer than 255), error 100; the right neighbour gets
    # 100 + 100 * 7/16 = 143.75 -> 255, error -111.25; the third gets
    # 100 - 111.25 * 7/16 = 51.328125 -> 0.
    out = reference.error_diffusion(grey([[100, 100, 100]]), GREY, FS, CPU)
    assert out[0, :, :, 0].tolist() == [[0, 255, 0]]


def test_hand_worked_column():
    # Top 200 -> 255, error -55: the pixel below gets 250 - 55*5/16 =
    # 232.8125 -> 255.
    out = reference.error_diffusion(grey([[200], [250]]), GREY, FS, CPU)
    assert out[0, :, 0, 0].tolist() == [255, 255]


def test_hand_worked_clamp():
    # 100 -> 0, error 100; 250 + 43.75 = 293.75 is clamped to 255 before
    # the search, so its error is 0 and 120 stays below 127.5 -> 0 (without
    # the clamp, 120 + 38.75 * 7/16 = 136.95 -> 255).
    out = reference.error_diffusion(grey([[100, 250, 120]]), GREY, FS, CPU)
    assert out[0, :, :, 0].tolist() == [[0, 255, 0]]


def test_ties_go_to_the_first_colour():
    pal = np.array([[10, 10, 10], [30, 30, 30], [20, 20, 20]])
    out = reference.error_diffusion(grey([[20]]), pal, FS, CPU)
    assert out[0, 0, 0].tolist() == [20, 20, 20]  # exact match beats the tie
    out = reference.error_diffusion(grey([[20]]), pal[:2], FS, CPU)
    assert out[0, 0, 0].tolist() == [10, 10, 10]  # 10 and 30 tie: the first wins


@pytest.mark.parametrize("shape, p", [((5, 7), 4), ((9, 4), 16), ((3, 13), 33)])
def test_wavefront_equals_the_row_major_loop(shape, p):
    rng = np.random.default_rng(p)
    imgs = rng.integers(0, 256, (2, *shape, 3), dtype=np.uint8)
    pal = rng.integers(0, 256, (p, 3))
    pal[1] = pal[0]  # a planted duplicate: the first of the two wins
    out = reference.error_diffusion(imgs, pal, FS, CPU)
    for i in range(2):
        assert np.array_equal(out[i], row_major(imgs[i], pal, FS))


def test_palette_and_scan_equal_the_programs_cpu_path():
    from dither_pie_tpu_torch.api.ditherer import DitherMode, ImageDitherer
    from dither_pie_tpu_torch.core.palette import kmeans_palette

    cell = tiny_cell("fs-km32.stream-1080p")
    pool = frames.make_pool(cell.traffic, 12345, CPU)
    km = cell.config["kmeans"]
    pal = reference.kmeans_palette(pool[0], 16, km["random_state"], km["sample_cap"],
                                   km["iters"], CPU)
    assert np.array_equal(pal, np.asarray(kmeans_palette(pool[0], 16, device="cpu")))
    d = ImageDitherer(num_colors=16, dither_mode=DitherMode.ERROR_DIFFUSION,
                      palette=[tuple(c) for c in pal.tolist()],
                      dither_params={"variant": "floyd_steinberg", "serpentine": "false"},
                      device="cpu")
    assert np.array_equal(d.apply_dithering_batch(pool),
                          reference.error_diffusion(pool, pal, FS, CPU))


def test_control_in_bfloat16_fails_the_exact_limit():
    """The control: the reference in the nearest precision below float32
    differs from the float32 reference at the size a test holds."""
    cell = tiny_cell("fs-km256.stream-1080p", colors=64)
    pool = frames.make_pool(cell.traffic, 7, CPU)
    km = cell.config["kmeans"]
    pal = reference.kmeans_palette(pool[0], 64, km["random_state"], km["sample_cap"],
                                   km["iters"], CPU)
    ref = reference.error_diffusion(pool, pal, FS, CPU, torch.float32)
    low = reference.error_diffusion(pool, pal, FS, CPU, torch.bfloat16)
    share = np.any(low != ref, axis=-1).reshape(len(pool), -1).mean(axis=1).max()
    assert share > cell.config["limits"]["mismatch_share"]
    assert share > 0.05


def test_control_at_the_cells_size_on_the_card(card, bench):
    from portbench import cells, control

    for name in ("fs-km32.stream-1080p", "fs-km256.image-1080p"):
        cell = cells.find_cell(bench, name)
        r = control.control_readings(cell, 3, card, n_frames=4)
        assert r["mismatch_share"] > r["limit"]


def test_the_reference_imports_nothing_of_the_program():
    root = Path(reference.__file__).parents[1]
    files = sorted((root / "references").glob("*.py")) + [
        root / name for name in ("roofline.py", "stats.py", "frames.py")]
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in ("dither_pie_tpu_torch", "dither_pie_tpu",
                                               "jax", "jaxlib", "flax"), (path.name, m)


def test_lloyd_gap_hand_worked():
    pix = np.array([[0, 0, 0], [2, 2, 2], [10, 10, 10], [12, 14, 12]], dtype=np.uint8)
    # Centres at the means: no gap; the unused third colour is left out.
    assert reference.lloyd_gap(pix, np.array([[1, 1, 1], [11, 12, 11], [200, 0, 0]])) == 0.0
    # The second centre one unit low in green: its mean lies 1 away.
    assert reference.lloyd_gap(pix, np.array([[1, 1, 1], [11, 11, 11]])) == 1.0
    # A tie goes to the first colour: 6 lies as near 4 as 8, so colour 0
    # takes 0, 2 and 6 (mean 8/3) and colour 1 takes 10 and 12 and 14.
    pix = np.array([[0] * 3, [2] * 3, [6] * 3, [10] * 3, [12] * 3, [14] * 3], dtype=np.uint8)
    assert reference.lloyd_gap(pix, np.array([[4] * 3, [8] * 3])) == pytest.approx(4.0)


def test_lloyd_gap_parts_a_fit_from_its_seeds():
    """A converged fit's truncated centres lie about a unit from their
    means; the kmeans++ seeds alone lie several units off."""
    cell = tiny_cell("fs-km32.stream-1080p")
    cell.traffic.update(height=60, width=100, pool=1)
    frame0 = frames.make_pool(cell.traffic, 2**31 + 5, CPU)[0]
    km = cell.config["kmeans"]
    pix = reference.subsample(frame0, km["random_state"], km["sample_cap"])
    fit = reference.kmeans_palette(frame0, 16, km["random_state"], km["sample_cap"], 64, CPU)
    seeds = reference.kmeans_palette(frame0, 16, km["random_state"], km["sample_cap"], 0, CPU)
    assert reference.lloyd_gap(pix, fit) < 2.0
    assert reference.lloyd_gap(pix, seeds) > 2 * reference.lloyd_gap(pix, fit)


def test_palette_checks_of_the_programs_cpu_palette():
    from dither_pie_tpu_torch.core.palette import kmeans_palette

    cell = tiny_cell("fs-km32.stream-1080p")
    cell.config["palette"]["num_colors"] = 16
    frame0 = frames.make_pool(cell.traffic, 99, CPU)[0]
    ref_pal = reference.palette(frame0, cell.config, CPU)
    port = np.asarray(kmeans_palette(frame0, 16, device="cpu"), dtype=np.int64)
    got = reference.palette_checks(frame0, port, ref_pal, cell.config)
    assert got["palette_diff"] == 0.0
    assert got["palette_lloyd_gap"] <= cell.config["limits"]["palette_lloyd_gap"]
    assert reference.palette_checks(frame0, port[:8], ref_pal, cell.config)["palette_diff"] == 256
