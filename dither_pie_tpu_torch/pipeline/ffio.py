"""FFmpeg-backed video I/O: probing and raw-frame streaming.

A copy of ``dither_pie_tpu/pipeline/ffio.py`` (numpy only; the port imports
nothing of the JAX package). Frames stream through ffmpeg rawvideo pipes
straight into numpy buffers (and back out to the encoder), with no image
codec round trip a frame, which is what lets the device stay fed; OpenCV is
a video-only fallback where ffmpeg is absent. ffmpeg presence is probed
once; pipelines degrade with a clear error when it's missing.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from typing import Iterator, Optional

import numpy as np

FFMPEG = shutil.which("ffmpeg")
FFPROBE = shutil.which("ffprobe")


def ffmpeg_available() -> bool:
    return FFMPEG is not None and FFPROBE is not None


def _cv2():
    try:
        import cv2

        return cv2
    except ImportError:
        return None


def video_backend() -> Optional[str]:
    """'ffmpeg' (full fidelity: audio/subtitle copy, libx264 crf18) or
    'cv2' (video-only fallback: mp4v, no audio) or None."""
    if ffmpeg_available():
        return "ffmpeg"
    if _cv2() is not None:
        return "cv2"
    return None


def video_available() -> bool:
    return video_backend() is not None


def probe_video(video_path: str) -> dict:
    """fps / width / height / duration / frame_count via ffprobe (with the
    original application's >100-means-frame-count heuristic and fallback defaults);
    cv2 fallback when ffprobe is absent."""
    if not ffmpeg_available():
        return _probe_video_cv2(video_path)
    try:
        def run(entries):
            cmd = [FFPROBE, "-v", "error", "-select_streams", "v:0",
                   "-show_entries", f"stream={entries}",
                   "-of", "default=nokey=1:noprint_wrappers=1", video_path]
            return subprocess.run(cmd, capture_output=True, text=True,
                                  check=True).stdout.strip()

        fps_str = run("r_frame_rate")
        if "/" in fps_str:
            num, den = fps_str.split("/")
            fps = float(num) / float(den)
        else:
            fps = float(fps_str) if fps_str else 30.0

        dims = run("width,height").split("\n")
        width = int(dims[0]) if len(dims) > 0 else 1920
        height = int(dims[1]) if len(dims) > 1 else 1080

        duration = frame_count = None
        for line in run("duration,nb_frames").split("\n"):
            if line and line != "N/A":
                try:
                    val = float(line)
                    if val > 100:  # likely a frame count
                        frame_count = int(val)
                    else:
                        duration = val
                except ValueError:
                    pass
        if frame_count is None and duration is not None:
            frame_count = int(duration * fps)
        return {"fps": fps, "width": width, "height": height,
                "duration": duration, "frame_count": frame_count}
    except Exception as e:
        print(f"Warning: Could not get video info: {e}", file=sys.stderr)
        return {"fps": 30.0, "width": 1920, "height": 1080,
                "duration": None, "frame_count": None}


def _probe_video_cv2(video_path: str) -> dict:
    cv2 = _cv2()
    cap = cv2.VideoCapture(video_path)
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) or 1920
        height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) or 1080
        frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or None
        duration = frame_count / fps if frame_count else None
        return {"fps": float(fps), "width": width, "height": height,
                "duration": duration, "frame_count": frame_count}
    finally:
        cap.release()


def _read_frames_cv2(video_path: str) -> Iterator[np.ndarray]:
    cv2 = _cv2()
    cap = cv2.VideoCapture(video_path)
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                return
            yield np.ascontiguousarray(frame[:, :, ::-1])  # BGR -> RGB
    finally:
        cap.release()


def read_frames(video_path: str, width: int, height: int) -> Iterator[np.ndarray]:
    """Yield (H, W, 3) uint8 frames (ffmpeg rawvideo pipe, or cv2 fallback)."""
    if not ffmpeg_available():
        yield from _read_frames_cv2(video_path)
        return
    cmd = [FFMPEG, "-i", video_path, "-f", "rawvideo", "-pix_fmt", "rgb24",
           "-v", "error", "-"]
    frame_bytes = width * height * 3
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, bufsize=frame_bytes * 4)
    try:
        while True:
            buf = proc.stdout.read(frame_bytes)
            if len(buf) < frame_bytes:
                break
            yield np.frombuffer(buf, np.uint8).reshape(height, width, 3)
    finally:
        proc.stdout.close()
        proc.wait()


def read_frames_planar(video_path: str, width: int,
                       height: int) -> Iterator[np.ndarray]:
    """Yield (3, H, W) uint8 channel-major frames (R, G, B planes).

    ffmpeg's ``gbrp`` rawvideo output is already planar — the deinterleave
    happens inside ffmpeg's (multithreaded) scaler instead of on the card,
    and the planar layout is what the planar skew K6 reads, so no
    interleave remains between the reader and the scan. The cv2 fallback
    transposes on host."""
    if not ffmpeg_available():
        for frame in _read_frames_cv2(video_path):
            yield np.ascontiguousarray(frame.transpose(2, 0, 1))
        return
    cmd = [FFMPEG, "-i", video_path, "-f", "rawvideo", "-pix_fmt", "gbrp",
           "-v", "error", "-"]
    frame_bytes = width * height * 3
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, bufsize=frame_bytes * 4)
    try:
        while True:
            buf = proc.stdout.read(frame_bytes)
            if len(buf) < frame_bytes:
                break
            gbr = np.frombuffer(buf, np.uint8).reshape(3, height, width)
            yield gbr[[2, 0, 1]]  # gbrp plane order -> R, G, B
    finally:
        proc.stdout.close()
        proc.wait()


def read_single_frame(video_path: str, index: int = 0) -> Optional[np.ndarray]:
    """Decode one frame (by index) to an RGB array."""
    if not ffmpeg_available():
        cv2 = _cv2()
        cap = cv2.VideoCapture(video_path)
        try:
            if index:
                cap.set(cv2.CAP_PROP_POS_FRAMES, index)
            ret, frame = cap.read()
            return np.ascontiguousarray(frame[:, :, ::-1]) if ret else None
        finally:
            cap.release()
    info = probe_video(video_path)
    w, h = info["width"], info["height"]
    sel = [] if index == 0 else ["-vf", f"select=eq(n\\,{index})", "-vsync", "0"]
    cmd = [FFMPEG, "-i", video_path, *sel, "-vframes", "1",
           "-f", "rawvideo", "-pix_fmt", "rgb24", "-v", "error", "-"]
    out = subprocess.run(cmd, capture_output=True).stdout
    if len(out) < w * h * 3:
        return None
    return np.frombuffer(out[: w * h * 3], np.uint8).reshape(h, w, 3)


def encode_command(output_path: str, width: int, height: int, fps: float,
                   source_path: Optional[str] = None,
                   total_frames: Optional[int] = None,
                   in_pix_fmt: str = "rgb24"):
    """The ffmpeg encode invocation — the original application's encoder
    settings: libx264 preset medium crf 18
    yuv420p, audio (1:a?) and subtitles (1:s?) stream-copied from the
    source container, -vframes N so audio length cannot pad the video.
    Factored out so tests can pin the flags without running ffmpeg.
    ``in_pix_fmt='gbrp'`` takes planar input (the device path's native
    output layout — the interleave happens inside ffmpeg)."""
    cmd = [FFMPEG or "ffmpeg", "-y",
           "-f", "rawvideo", "-pix_fmt", in_pix_fmt,
           "-s", f"{width}x{height}", "-framerate", f"{fps:.5f}", "-i", "-"]
    if source_path:
        cmd += ["-i", source_path,
                "-map", "0:v:0", "-map", "1:a?", "-map", "1:s?"]
    cmd += ["-c:v", "libx264", "-preset", "medium", "-crf", "18",
            "-pix_fmt", "yuv420p"]
    if total_frames:
        # Prevent ffmpeg padding the video to the audio's duration.
        cmd += ["-vframes", str(total_frames)]
    if source_path:
        cmd += ["-c:a", "copy", "-c:s", "copy"]
    cmd += ["-v", "error", output_path]
    return cmd


class FrameWriter:
    """Encode raw RGB frames with libx264 (crf 18, yuv420p), mapping audio
    and subtitles from the original container with codec copy — the
    original application's encoder settings."""

    def __init__(self, output_path: str, width: int, height: int, fps: float,
                 source_path: Optional[str] = None,
                 total_frames: Optional[int] = None, planar: bool = False):
        self.width, self.height = width, height
        self.planar = planar
        self._cv2_writer = None
        self.proc = None
        if not ffmpeg_available():
            cv2 = _cv2()
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            self._cv2_writer = cv2.VideoWriter(output_path, fourcc, fps,
                                               (width, height))
            if not self._cv2_writer.isOpened():
                raise RuntimeError(f"cv2 VideoWriter failed for {output_path}")
            print("note: encoding with OpenCV fallback (mp4v, no audio); "
                  "install ffmpeg for libx264 + audio/subtitle copy",
                  file=sys.stderr)
            return
        cmd = encode_command(output_path, width, height, fps,
                             source_path, total_frames,
                             in_pix_fmt="gbrp" if planar else "rgb24")
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL)

    def write(self, frame: np.ndarray):
        """``planar=False``: (H, W, 3) interleaved. ``planar=True``:
        (3, H, W) R/G/B planes — piped to ffmpeg as gbrp with zero host
        reshuffling; the cv2 fallback interleaves on host."""
        if self.planar:
            assert frame.shape == (3, self.height, self.width) \
                and frame.dtype == np.uint8
            if self._cv2_writer is not None:
                hwc = np.ascontiguousarray(frame.transpose(1, 2, 0))
                self._cv2_writer.write(np.ascontiguousarray(hwc[:, :, ::-1]))
                return
            self.proc.stdin.write(
                np.ascontiguousarray(frame[[1, 2, 0]]).tobytes())
            return
        assert frame.shape == (self.height, self.width, 3) and frame.dtype == np.uint8
        if self._cv2_writer is not None:
            self._cv2_writer.write(np.ascontiguousarray(frame[:, :, ::-1]))
            return
        self.proc.stdin.write(frame.tobytes())

    def close(self) -> bool:
        if self._cv2_writer is not None:
            self._cv2_writer.release()
            return True
        self.proc.stdin.close()
        return self.proc.wait() == 0
