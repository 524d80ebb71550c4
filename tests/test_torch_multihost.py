"""Multi-host sharding in the port (``parallel/multihost.py``, the host-aware
segment path of ``pipeline/video.py``, ``cli.main.process_folder``'s file
striding), on the CPU, against the JAX package's and against the single-host
runs. ffmpeg-free: the IO legs are faked; the dither path is real.

* ``host_segments`` and ``parse_shard`` equal the JAX package's;
* per-host manifests;
* a two-host segmented flow (Bayer, interleaved; Floyd-Steinberg, planar):
  host 0 finishes its share with the concat pending, host 1 concatenates,
  and the frames written across both hosts equal a single-host resume run's
  and a single-pass run's, bitwise;
* the concat waits on every manifest of this job's settings, and a held
  lock makes the late host report its share done;
* a single-host resume still concatenates at once;
* folder sharding, the out-of-range empty share included;
* the concat lock: claim and block, reclaim of a dead pid, reclaim of a
  stale remote lock;
* ``process_single_video`` with ``host_count=2`` on a host whose share is
  done returns True with no output yet;
* ``host_count > 1`` without ffmpeg, or with an unknown frame count,
  returns False.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import bench
import dither_pie_tpu_torch as tdpt
from dither_pie_tpu.parallel import multihost as jmh
from dither_pie_tpu_torch.cli.main import process_folder
from dither_pie_tpu_torch.parallel.multihost import host_segments, parse_shard
from dither_pie_tpu_torch.pipeline import ffio
from dither_pie_tpu_torch.pipeline import resume as rz
from dither_pie_tpu_torch.pipeline import video as tvideo
from dither_pie_tpu_torch.pipeline.video import VideoProcessor
import torch_workers  # noqa: F401

PAL = [(0, 0, 0), (255, 0, 0), (0, 255, 0), (255, 255, 255), (30, 90, 200)]


@pytest.fixture(autouse=True)
def rgb_path(monkeypatch):
    monkeypatch.setenv("DITHER_PIE_TPU_INDEX_TRANSFER", "0")


@pytest.mark.parametrize("n_seg", [0, 1, 3, 7, 10])
@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_host_segments_equal_jax(n_seg, count):
    union = set()
    for k in range(count):
        part = host_segments(n_seg, k, count)
        assert part == jmh.host_segments(n_seg, k, count)
        assert not (union & part)
        union |= part
    assert union == set(range(n_seg))


def test_host_segments_strided():
    assert host_segments(7, 0, 2) == {0, 2, 4, 6}
    assert host_segments(7, 1, 2) == {1, 3, 5}
    assert host_segments(3, 0, 1) == {0, 1, 2}
    for bad in ((5, 2, 2), (5, -1, 2)):
        with pytest.raises(ValueError):
            host_segments(*bad)


@pytest.mark.parametrize("spec", ["0:4", "3:8", "0:1", " 1:2", "1:2 "])
def test_parse_shard_equals_jax(spec):
    assert parse_shard(spec) == jmh.parse_shard(spec)


@pytest.mark.parametrize("spec", ["4:4", "-1:2", "1", "a:b", "1:0", "1:2:3", ""])
def test_parse_shard_refuses_as_jax(spec):
    with pytest.raises(ValueError):
        parse_shard(spec)
    with pytest.raises(ValueError):
        jmh.parse_shard(spec)


def test_per_host_manifests(tmp_path):
    out = str(tmp_path / "o.mp4")
    expect = {"input": "/a.mp4", "total_frames": 10}
    for i in (0, 1):
        Path(rz.segment_part_path(out, i)).write_text("x")
    rz.save_manifest(out, expect, {0}, host_index=0)
    rz.save_manifest(out, expect, {1}, host_index=1)
    assert rz.manifest_path(out, 1).endswith(".resume.h1.json")
    assert rz.load_manifest(out, expect, host_index=0) == {0}
    assert rz.load_manifest(out, expect, host_index=1) == {1}
    assert rz.load_all_manifests(out, expect, host_count=2) == {0, 1}
    # A manifest whose parameters differ is ignored.
    assert rz.load_all_manifests(out, {"input": "/b.mp4"}, 2) == set()
    assert not rz.all_parts_present(out, 3)
    Path(rz.segment_part_path(out, 2)).write_text("x")
    assert rz.all_parts_present(out, 3)


class RecordingWriter:
    """Stands in for ffio.FrameWriter: keeps the frames written to each
    path (``written``) and leaves a file holding their count."""

    written = {}

    def __init__(self, path, w, h, fps, **kw):
        self.path, self.frames = str(path), []
        self.planar = kw.get("planar", False)

    def write(self, frame):
        self.frames.append(np.array(frame))

    def close(self):
        RecordingWriter.written[self.path] = self.frames
        Path(self.path).write_text(f"{len(self.frames)}")
        return True


def fake_io(monkeypatch, frames, frame_count="n"):
    """ffmpeg present, a clip of ``frames`` (interleaved and planar
    readers), writes recorded by RecordingWriter."""
    h, w, _ = frames[0].shape
    monkeypatch.setattr(ffio, "ffmpeg_available", lambda: True)
    monkeypatch.setattr(ffio, "video_available", lambda: True)
    monkeypatch.setattr(
        ffio, "probe_video",
        lambda p: {"fps": 30.0, "width": w, "height": h,
                   "frame_count": len(frames) if frame_count == "n" else frame_count,
                   "duration": len(frames) / 30.0})
    monkeypatch.setattr(ffio, "read_frames",
                        lambda p, w_, h_: iter([f.copy() for f in frames]))
    monkeypatch.setattr(ffio, "read_frames_planar", lambda p, w_, h_: iter(
        [np.ascontiguousarray(f.transpose(2, 0, 1)) for f in frames]))
    monkeypatch.setattr(ffio, "read_single_frame", lambda p, i=0: frames[i].copy())
    monkeypatch.setattr(ffio, "FrameWriter", RecordingWriter)
    RecordingWriter.written = {}


def fake_concat(monkeypatch):
    """rz.concat_segments that joins the recorded part frames in segment
    order; returns the list of concatenated outputs."""
    concats = []

    def concat(output_path, n_seg, source_path=None):
        assert rz.all_parts_present(output_path, n_seg)
        frames = [f for i in range(n_seg)
                  for f in RecordingWriter.written[rz.segment_tmp_path(output_path, i)]]
        concats.append((n_seg, frames))
        Path(output_path).write_text(f"{len(frames)}")
        return True

    monkeypatch.setattr(rz, "concat_segments", concat)
    return concats


def _frames(n, h=24, w=32, seed=0):
    return [bench.synth_image(h, w, seed + i) for i in range(n)]


def _ditherer(mode, params):
    return tdpt.ImageDitherer(num_colors=len(PAL), dither_mode=tdpt.DitherMode(mode),
                              palette=list(PAL), dither_params=dict(params), device="cpu")


def _as_hwc(frames, planar):
    return [np.ascontiguousarray(f.transpose(1, 2, 0)) if planar else f for f in frames]


@pytest.mark.parametrize("mode,params,planar", [
    ("bayer", {"size": "4x4"}, False),
    ("error_diffusion", {"variant": "floyd_steinberg"}, True),
], ids=["bayer", "fs-planar"])
def test_two_host_segmented_flow(tmp_path, monkeypatch, mode, params, planar):
    """Host 0 processes its share (concat pending), host 1 finishes and the
    concat fires with every part present; the frames written across the two
    hosts equal a single-host resume run's and a single-pass run's."""
    frames = _frames(10)
    fake_io(monkeypatch, frames)
    concats = fake_concat(monkeypatch)
    d = _ditherer(mode, params)
    assert d.supports_planar_batch() == planar
    out = str(tmp_path / "out.mp4")
    # 10 frames, segment_size 3 -> 4 segments; host 0 owns {0, 2}, host 1 {1, 3}.
    vp = VideoProcessor(batch_size=4)
    assert vp.process_video_streaming("in.mp4", out, d, segment_size=3,
                                      host_index=0, host_count=2)
    assert not concats and not os.path.exists(out)
    expect = {"input": os.path.abspath("in.mp4"), "fps": 30.0, "segment_size": 3,
              "total_frames": 10,
              "settings": VideoProcessor._settings_fingerprint(d, None, None)}
    assert rz.load_manifest(out, expect, host_index=0) == {0, 2}
    assert rz.load_all_manifests(out, expect, 2) == {0, 2}

    assert vp.process_video_streaming("in.mp4", out, d, segment_size=3,
                                      host_index=1, host_count=2)
    assert len(concats) == 1 and concats[0][0] == 4
    sizes = [int(Path(rz.segment_part_path(out, i)).read_text()) for i in range(4)]
    assert sizes == [3, 3, 3, 1]
    sharded = _as_hwc(concats[0][1], planar)
    assert all(RecordingWriter.written[rz.segment_tmp_path(out, i)][0].shape[0] ==
               (3 if planar else 24) for i in range(4))

    single = str(tmp_path / "single.mp4")
    assert vp.process_video_streaming("in.mp4", single, d, resume=True, segment_size=3)
    assert len(concats) == 2 and concats[1][0] == 4
    one_pass = str(tmp_path / "one_pass.mp4")
    assert vp.process_video_streaming("in.mp4", one_pass, d)
    for name, ref in (("single-host resume", _as_hwc(concats[1][1], planar)),
                      ("single pass", _as_hwc(RecordingWriter.written[one_pass], planar))):
        assert len(ref) == len(sharded) == 10
        for i, (a, b) in enumerate(zip(sharded, ref)):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}, frame {i}")
    want = d.apply_dithering_batch(np.stack(frames))
    np.testing.assert_array_equal(np.stack(sharded), want)


def test_concat_waits_for_a_matching_manifest(tmp_path, monkeypatch):
    """A part left by a run with other settings never completes the grid:
    host 1's concat waits until host 0 reruns with this job's settings."""
    fake_io(monkeypatch, _frames(6))
    concats = fake_concat(monkeypatch)
    out = str(tmp_path / "out.mp4")
    vp = VideoProcessor(batch_size=4)
    other = tdpt.ImageDitherer(num_colors=2, dither_mode=tdpt.DitherMode.BAYER,
                               palette=[(0, 0, 0), (255, 255, 255)], device="cpu")
    d = _ditherer("bayer", {"size": "4x4"})
    assert vp.process_video_streaming("in.mp4", out, other, segment_size=3,
                                      host_index=0, host_count=2)
    assert vp.process_video_streaming("in.mp4", out, d, segment_size=3,
                                      host_index=1, host_count=2)
    assert not concats and rz.all_parts_present(out, 2)
    assert vp.process_video_streaming("in.mp4", out, d, segment_size=3,
                                      host_index=0, host_count=2)
    assert len(concats) == 1


def test_held_concat_lock_leaves_the_share_done(tmp_path, monkeypatch):
    fake_io(monkeypatch, _frames(6))
    concats = fake_concat(monkeypatch)
    out = str(tmp_path / "out.mp4")
    d = _ditherer("bayer", {"size": "4x4"})
    vp = VideoProcessor(batch_size=4)
    assert vp.process_video_streaming("in.mp4", out, d, segment_size=3,
                                      host_index=0, host_count=2)
    Path(out + ".concat.lock").write_text(f"{os.getpid()} {socket.gethostname()}")
    assert vp.process_video_streaming("in.mp4", out, d, segment_size=3,
                                      host_index=1, host_count=2)
    assert not concats and os.path.exists(out + ".concat.lock")


def test_single_host_resume_still_concats(tmp_path, monkeypatch):
    """host_count=1 keeps the original semantics: concat right away."""
    fake_io(monkeypatch, _frames(5, seed=1))
    concats = fake_concat(monkeypatch)
    d = tdpt.ImageDitherer(num_colors=2, dither_mode=tdpt.DitherMode.BAYER,
                           palette=[(0, 0, 0), (255, 255, 255)], device="cpu")
    out = str(tmp_path / "out.mp4")
    assert VideoProcessor(batch_size=4).process_video_streaming(
        "in.mp4", out, d, resume=True, segment_size=2)
    assert [n for n, _ in concats] == [3]


def _folder_config(src, out):
    return {
        "input": str(src), "output": str(out), "mode": "folder",
        "pixelization": {"enabled": False, "method": "none", "max_size": 64},
        "dithering": {"enabled": True, "mode": "bayer", "parameters": {}},
        "palette": {"source": "median_cut", "num_colors": 4, "use_gamma": False},
        "final_resize": {"enabled": False, "multiplier": 1},
    }


def test_folder_sharding(tmp_path):
    """--shard strides the folder batch's file list across hosts; the two
    shards' outputs equal the unsharded run's."""
    src, out, whole = tmp_path / "in", tmp_path / "out", tmp_path / "whole"
    src.mkdir()
    for i in range(5):
        Image.fromarray(bench.synth_image(16, 20, 30 + i)).save(src / f"im{i}.png")
    cfg = _folder_config(src, out)
    assert process_folder(dict(cfg), host_index=0, host_count=2, device="cpu")
    assert {p.name for p in out.iterdir()} == {"im0.png", "im2.png", "im4.png"}
    assert process_folder(dict(cfg), host_index=1, host_count=2, device="cpu")
    assert {p.name for p in out.iterdir()} == {f"im{i}.png" for i in range(5)}
    # An out-of-range shard with no files still succeeds (an empty share).
    assert process_folder(dict(cfg), host_index=4, host_count=5, device="cpu")
    assert process_folder(_folder_config(src, whole), device="cpu")
    for i in range(5):
        np.testing.assert_array_equal(np.asarray(Image.open(out / f"im{i}.png")),
                                      np.asarray(Image.open(whole / f"im{i}.png")))


def test_concat_lock_claim_and_block(tmp_path):
    lock = str(tmp_path / "out.mp4.concat.lock")
    assert VideoProcessor._claim_concat_lock(lock) is True
    # Live holder (this pid, this host): a second claim must lose.
    assert VideoProcessor._claim_concat_lock(lock) is False
    os.remove(lock)
    assert VideoProcessor._claim_concat_lock(lock) is True


def test_concat_lock_reclaims_dead_pid(tmp_path):
    lock = str(tmp_path / "out.mp4.concat.lock")
    # A pid that existed and is now certainly gone on this host.
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    Path(lock).write_text(f"{child.pid} {socket.gethostname()}")
    assert VideoProcessor._claim_concat_lock(lock) is True  # reclaimed
    assert Path(lock).read_text().split()[0] == str(os.getpid())


def test_concat_lock_reclaims_stale_remote(tmp_path):
    lock = str(tmp_path / "out.mp4.concat.lock")
    # A remote host's pid: its liveness is unknowable here, so only the
    # stale-age rule may reclaim it.
    Path(lock).write_text(f"12345 not-{socket.gethostname()}")
    assert VideoProcessor._claim_concat_lock(lock) is False
    old = os.path.getmtime(lock) - (VideoProcessor.CONCAT_LOCK_STALE_S + 10)
    os.utime(lock, (old, old))
    assert VideoProcessor._claim_concat_lock(lock) is True


def video_config(tmp_path):
    return {
        "input": str(tmp_path / "in.mp4"), "output": str(tmp_path / "out.mp4"),
        "mode": "video",
        "pixelization": {"enabled": False, "method": "none", "max_size": 64},
        "dithering": {"enabled": True, "mode": "bayer", "parameters": {"size": "4x4"}},
        "palette": {"source": "median_cut", "num_colors": 4, "use_gamma": False},
        "final_resize": {"enabled": False, "multiplier": 1},
    }


def test_process_single_video_host_share_done(tmp_path, monkeypatch, capsys):
    """With host_count=2 a host's share can be done before any output
    exists (here host 1's share of the one 300-frame segment is empty):
    process_single_video returns True instead of failing on the missing
    file, and host 0's call encodes the segment and concatenates."""
    fake_io(monkeypatch, _frames(7))
    concats = fake_concat(monkeypatch)
    cfg = video_config(tmp_path)
    assert tvideo.process_single_video(cfg, host_index=1, host_count=2, device="cpu")
    assert not concats and not os.path.exists(cfg["output"])
    assert "Progress: 100% - Host share complete (concat pending)" in capsys.readouterr().out
    assert tvideo.process_single_video(cfg, host_index=0, host_count=2, device="cpu")
    assert len(concats) == 1 and len(concats[0][1]) == 7
    assert os.path.exists(cfg["output"])


def test_multi_host_needs_ffmpeg_and_a_frame_count(tmp_path, monkeypatch):
    frames = _frames(4)
    d = _ditherer("bayer", {"size": "4x4"})
    out = str(tmp_path / "out.mp4")
    fake_io(monkeypatch, frames, frame_count=None)
    assert not VideoProcessor().process_video_streaming("in.mp4", out, d, host_index=1,
                                                        host_count=2)
    fake_io(monkeypatch, frames)
    monkeypatch.setattr(ffio, "ffmpeg_available", lambda: False)  # cv2 only
    assert not VideoProcessor().process_video_streaming("in.mp4", out, d, host_index=0,
                                                        host_count=2)
    assert not tvideo.process_single_video(video_config(tmp_path), host_count=2,
                                           device="cpu")
    assert RecordingWriter.written == {}
