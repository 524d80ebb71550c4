"""Video pipeline: ffmpeg rawvideo streaming -> host batch assembly ->
batched dithering on the card -> streaming encode.

The port of ``dither_pie_tpu/pipeline/video.py``. Frames stream through
rawvideo pipes (``ffio.py``), are stacked into (B, H, W, 3) batches (or
(3, B, H, W) planes in the zero-copy gbrp flow) and go through
``ImageDitherer.apply_dithering_batch``: the wavefront kernels K1 -> K2 ->
K3 (K6 for planes) for error diffusion, K4 for the ordered family, the host
engine for serpentine scans and Riemersma.

Semantics kept from the original application:
  * one palette, computed from the FIRST frame, governs the whole video;
  * per-frame retry (x2) with nearest-good-frame patching on failure;
  * the encoder settings (libx264 crf18 yuv420p, -vframes N, audio +
    subtitle stream copy);
  * the progress callback protocol ``(fraction: float, message: str)``.

Where it differs from the JAX package: a tail batch runs at its own size
(the kernels take any batch, so nothing is padded); with ``overlap`` each
of the two workers runs its batches on a CUDA stream of its own; multi-host
sharding (``host_count > 1``, ROADMAP A11) and the neural pixelizer (A9)
are not ported and raise NotImplementedError.

Frame sources are pluggable: any iterator of (H, W, 3) uint8 arrays works,
so the pipeline runs without ffmpeg (the tests feed synthetic frames).
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from dither_pie_tpu_torch.api.ditherer import ImageDitherer, PixelizeMethod
from dither_pie_tpu_torch.api.profiling import stage
from dither_pie_tpu_torch.api.runtime import DeviceLike
from dither_pie_tpu_torch.pipeline import ffio
from dither_pie_tpu_torch.pipeline import resume as rz
from dither_pie_tpu_torch.pipeline.pixelize import get_neural_pixelizer, pixelize_regular

logger = logging.getLogger("dither_pie_tpu_torch")

__all__ = ["VideoProcessor", "pixelize_regular", "process_single_video", "process_frames"]


def _apply_final_resize_to_frame(arr: np.ndarray, multiplier: int,
                                 planar: bool = False) -> np.ndarray:
    """Integer nearest-neighbor upscale, even dims (yuv420p requirement).
    ``planar``: arr is (3, H, W) channel-major planes."""
    ha, wa = (1, 2) if planar else (0, 1)
    out = np.repeat(np.repeat(arr, multiplier, axis=ha), multiplier, axis=wa)
    nh, nw = out.shape[ha], out.shape[wa]
    pads = [(0, 0)] * 3
    if nh % 2 or nw % 2:
        pads[ha] = (0, nh % 2)
        pads[wa] = (0, nw % 2)
        out = np.pad(out, pads, mode="edge")
    return out


def _pixelize_frames(arrs: List[np.ndarray], method: Optional[str],
                     max_size: int) -> List[np.ndarray]:
    """Regular pixelization a frame at a time (a host resize); the neural
    pixelizer raises, as it is not ported."""
    if method == PixelizeMethod.NEURAL.value:
        get_neural_pixelizer()
    if method == PixelizeMethod.REGULAR.value:
        return [np.array(pixelize_regular(Image.fromarray(a), max_size)) for a in arrs]
    return arrs


def _prefetch(iterable: Iterable, depth: int) -> Iterator:
    """Pull from ``iterable`` on a background thread through a bounded queue
    so frame decode overlaps the dithering. Worker exceptions re-raise at
    the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()

    def worker():
        try:
            for item in iterable:
                q.put(item)
            q.put(done)
        except BaseException as e:  # propagate decode failures
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def process_frames(
    frames: Iterable[np.ndarray],
    ditherer: ImageDitherer,
    pixelize_func: Optional[Tuple[str, int]] = None,
    final_resize_multiplier: Optional[int] = None,
    batch_size: int = 16,
    progress: Optional[Callable[[float, str], None]] = None,
    total_frames: Optional[int] = None,
    retries: int = 2,
    prefetch: bool = True,
    overlap: bool = True,
    planar: bool = False,
) -> Iterator[np.ndarray]:
    """Core streaming transform: frames in -> processed frames out.

    Batches frames for the device (the last batch holds what is left);
    retries a failed batch frame by frame; patches irrecoverable frames with
    the nearest previous good frame (or the next good one at the start of
    the stream).

    ``overlap=True`` dispatches batches to a pool of two workers with up to
    two batches in flight, so one batch's transfers and kernels overlap the
    other's and the main thread decodes, pixelizes and writes meanwhile.
    On a CUDA ditherer each worker runs its batches under a CUDA stream of
    its own (PyTorch's current stream is per thread), so one batch's
    tensors are made and used on one stream; the batch's ``.cpu()`` waits
    for that stream before a frame is emitted. Results are emitted strictly
    in order either way.

    ``planar=True``: frames are (3, H, W) channel-major planes in AND out
    (the zero-copy gbrp flow, ``ffio.read_frames_planar`` /
    ``FrameWriter(planar=True)``); it needs a ditherer whose strategy has a
    planar path (``ImageDitherer.supports_planar_batch``) and no pixelize
    stage (pixelization works on interleaved images).
    """
    if planar and pixelize_func:
        raise ValueError("planar frames do not compose with a pixelize "
                         "stage; use the interleaved flow")
    if prefetch:
        frames = _prefetch(frames, depth=2 * batch_size)
    method, max_size = pixelize_func if pixelize_func else (None, 64)
    batch: List[np.ndarray] = []
    done = 0
    last_good: Optional[np.ndarray] = None
    pending_patch = 0  # leading frames that failed before any success

    def run_batch(arrs: List[np.ndarray]) -> List[Optional[np.ndarray]]:
        # Planar frames are (3, H, W); the batch axis is axis 1 (3, B, H, W).
        stacked = np.stack(arrs, axis=1) if planar else np.stack(arrs)
        try:
            with stage("video.dither_batch"):
                out = ditherer.apply_dithering_batch(stacked, planar=planar)
            return [out[:, i] if planar else out[i] for i in range(len(arrs))]
        except Exception as e:
            logger.warning(f"Batch dither failed ({e}); retrying per frame")
            results: List[Optional[np.ndarray]] = []
            for arr in arrs:
                ok = None
                for _ in range(retries):
                    try:
                        if planar:
                            ok = ditherer.apply_dithering_batch(
                                arr[:, None], planar=True)[:, 0]
                        else:
                            ok = ditherer.apply_dithering_batch(arr[None])[0]
                        break
                    except Exception as ee:
                        logger.error(f"Frame failed: {ee}", exc_info=False)
                results.append(ok)
            return results

    def emit_results(results):
        nonlocal done, last_good, pending_patch
        for res in results:
            if res is None:
                if last_good is None:
                    # Leading failure: backfilled with the first good frame.
                    pending_patch += 1
                    continue
                logger.warning("Patched failed frame from nearest good frame")
                res = last_good.copy()
            else:
                last_good = res
            emit = res
            if final_resize_multiplier:
                emit = _apply_final_resize_to_frame(emit, final_resize_multiplier,
                                                    planar=planar)
            # Backfill any leading failures with this first good frame.
            for _ in range(pending_patch):
                done += 1
                yield emit.copy()
            pending_patch = 0
            done += 1
            yield emit
            if progress and total_frames and done % 5 == 0:
                progress(0.1 + 0.8 * done / total_frames,
                         f"Processed {done}/{total_frames} frames")

    def pixelized(arrs):
        with stage("video.pixelize"):
            return _pixelize_frames(arrs, method, max_size)

    if not overlap:
        for frame in frames:
            batch.append(np.asarray(frame))
            if len(batch) >= batch_size:
                yield from emit_results(run_batch(pixelized(batch)))
                batch.clear()
        if batch:
            yield from emit_results(run_batch(pixelized(batch)))
        return

    device = getattr(ditherer, "device", None)
    local = threading.local()

    def run_on_own_stream(arrs):
        if device is None or device.type != "cuda":
            return run_batch(arrs)
        if not hasattr(local, "stream"):
            local.stream = torch.cuda.Stream(device)
        with torch.cuda.stream(local.stream):
            return run_batch(arrs)

    ex = ThreadPoolExecutor(max_workers=2, thread_name_prefix="dither-batch")
    pending: "collections.deque" = collections.deque()
    try:
        for frame in frames:
            batch.append(np.asarray(frame))
            if len(batch) >= batch_size:
                # Pixelize on the main thread, then hand the dither to the
                # pool.
                pending.append(ex.submit(run_on_own_stream, pixelized(batch)))
                batch = []
                while len(pending) > 2:
                    yield from emit_results(pending.popleft().result())
        if batch:
            pending.append(ex.submit(run_on_own_stream, pixelized(batch)))
        while pending:
            yield from emit_results(pending.popleft().result())
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def _require_one_host(host_count: int) -> None:
    if host_count > 1:
        raise NotImplementedError(
            "multi-host segment sharding is not ported yet (ROADMAP A11)")


class VideoProcessor:
    """Streaming video processing with batched dithering on the card.

    API-compatible with the original application's VideoProcessor (the
    constructor takes an optional progress callback;
    ``process_video_streaming`` takes a built ImageDitherer plus the
    pixelize tuple).
    """

    def __init__(self,
                 num_workers: Optional[int] = None,  # accepted for API parity
                 progress_callback: Optional[Callable[[float, str], None]] = None,
                 batch_size: int = 16):
        self.num_workers = num_workers
        self.progress_callback = progress_callback
        self.batch_size = batch_size

    def _report_progress(self, fraction: float, message: str):
        if self.progress_callback:
            self.progress_callback(fraction, message)

    def get_video_info(self, video_path: str) -> dict:
        return ffio.probe_video(video_path)

    def process_video_streaming(self,
                                input_path: str,
                                output_path: str,
                                ditherer: ImageDitherer,
                                pixelize_func: Optional[Tuple[str, int]] = None,
                                batch_size: Optional[int] = None,
                                final_resize_multiplier: Optional[int] = None,
                                resume: bool = False,
                                segment_size: int = 300,
                                host_index: int = 0,
                                host_count: int = 1) -> bool:
        """Decode ``input_path``, dither every frame, encode
        ``output_path``; returns success. ``resume`` takes the segmented
        path (part files and a manifest; a rerun skips finished segments).
        ``host_count > 1`` (multi-host sharding) raises
        NotImplementedError."""
        _require_one_host(host_count)
        if not ffio.video_available():
            logger.error("No video backend available (need ffmpeg on PATH, "
                         "or OpenCV as a video-only fallback)")
            return False
        if resume:
            return self._process_segmented(
                input_path, output_path, ditherer, pixelize_func,
                batch_size or self.batch_size, final_resize_multiplier, segment_size)
        try:
            info = self.get_video_info(input_path)
            fps, w, h = info["fps"], info["width"], info["height"]
            total = info.get("frame_count")
            self._report_progress(0.0, "Initializing video processing...")

            # Zero-copy planar flow: ffmpeg emits gbrp planes, the planar
            # kernels take and give planes, and the encoder takes gbrp back.
            use_planar = pixelize_func is None and ditherer.supports_planar_batch()
            reader = (ffio.read_frames_planar(input_path, w, h) if use_planar
                      else ffio.read_frames(input_path, w, h))
            writer: Optional[ffio.FrameWriter] = None
            n_written = 0

            self._report_progress(0.05, "Streaming frames...")
            for out in process_frames(
                    reader, ditherer, pixelize_func=pixelize_func,
                    final_resize_multiplier=final_resize_multiplier,
                    batch_size=batch_size or self.batch_size,
                    progress=self._report_progress, total_frames=total,
                    planar=use_planar):
                if writer is None:
                    oh, ow = out.shape[1:3] if use_planar else out.shape[:2]
                    writer = ffio.FrameWriter(output_path, ow, oh, fps,
                                              source_path=input_path,
                                              total_frames=total,
                                              planar=use_planar)
                writer.write(out)
                n_written += 1

            if writer is None:
                raise ValueError("No frames extracted from video")
            self._report_progress(0.9, "Finalizing encode...")
            ok = writer.close()
            self._report_progress(1.0, "Video processing complete!")
            return ok and n_written > 0
        except Exception as e:
            self._report_progress(1.0, f"Error: {e}")
            logger.error(f"Video processing error: {e}", exc_info=True)
            return False

    @staticmethod
    def _settings_fingerprint(ditherer: ImageDitherer, pixelize_func,
                              final_resize_multiplier) -> str:
        """Stable hash of everything that shapes the output pixels, so a
        rerun with different settings never resumes (or concatenates) stale
        part files from a previous job."""
        import hashlib
        import json as _json

        def norm(v):
            # Full values: numpy arrays stringify with '...' above 1000
            # elements under default=str, and two large settings would
            # collide.
            if isinstance(v, np.ndarray):
                return v.tolist()
            if isinstance(v, (np.integer, np.floating, np.bool_)):
                return v.item()
            if isinstance(v, dict):
                return {str(k): norm(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [norm(x) for x in v]
            return v

        payload = {
            "mode": getattr(ditherer.dither_mode, "value",
                            str(ditherer.dither_mode)),
            "num_colors": ditherer.num_colors,
            "use_gamma": ditherer.use_gamma,
            "params": norm(ditherer.dither_params),
            "palette": norm(ditherer.palette),
            "pixelize": list(pixelize_func) if pixelize_func else None,
            "resize": final_resize_multiplier,
        }
        return hashlib.md5(_json.dumps(payload, sort_keys=True,
                                       default=str).encode()).hexdigest()

    def _process_segmented(self, input_path: str, output_path: str,
                           ditherer: ImageDitherer, pixelize_func, batch_size: int,
                           final_resize_multiplier, segment_size: int) -> bool:
        """Checkpoint/resume path: encode fixed-size segments to part files
        with a manifest; re-running skips completed segments; parts are
        concatenated (stream copy) with the original audio mapped in."""
        single_pass = dict(pixelize_func=pixelize_func, batch_size=batch_size,
                           final_resize_multiplier=final_resize_multiplier)
        if not ffio.ffmpeg_available():
            logger.warning("Resume mode needs ffmpeg (segment concat); "
                           "falling back to single-pass processing")
            return self.process_video_streaming(input_path, output_path, ditherer,
                                                **single_pass)
        try:
            info = self.get_video_info(input_path)
            fps, w, h = info["fps"], info["width"], info["height"]
            total = info.get("frame_count")
            if not total:
                logger.warning("Unknown frame count; resume unavailable — "
                               "falling back to single-pass processing")
                return self.process_video_streaming(input_path, output_path, ditherer,
                                                    **single_pass)

            expect = {"input": os.path.abspath(input_path),
                      "fps": round(fps, 5), "segment_size": segment_size,
                      "total_frames": total,
                      "settings": self._settings_fingerprint(
                          ditherer, pixelize_func, final_resize_multiplier)}
            completed = rz.load_manifest(output_path, expect)
            n_seg = rz.n_segments(total, segment_size)
            if completed:
                logger.info(f"Resuming: {len(completed)}/{n_seg} segments done")

            use_planar = pixelize_func is None and ditherer.supports_planar_batch()
            reader = (ffio.read_frames_planar(input_path, w, h) if use_planar
                      else ffio.read_frames(input_path, w, h))
            frames_done = 0
            for seg, start, end in rz.plan_segments(total, segment_size, set()):
                count = end - start
                if seg in completed:
                    # Already encoded: decode and discard to stay aligned.
                    for _ in itertools.islice(reader, count):
                        pass
                    frames_done += count
                    continue
                # Encode to a tmp name and rename when complete: a part file
                # is never visible half-written.
                part = rz.segment_part_path(output_path, seg)
                tmp = rz.segment_tmp_path(output_path, seg)
                writer = None
                n_written = 0
                for out in process_frames(
                        itertools.islice(reader, count), ditherer,
                        pixelize_func=pixelize_func,
                        final_resize_multiplier=final_resize_multiplier,
                        batch_size=batch_size, planar=use_planar):
                    if writer is None:
                        oh, ow = out.shape[1:3] if use_planar else out.shape[:2]
                        writer = ffio.FrameWriter(tmp, ow, oh, fps, planar=use_planar)
                    writer.write(out)
                    n_written += 1
                if writer is None or not writer.close() or n_written != count:
                    logger.error(f"Segment {seg} failed ({n_written}/{count} frames)")
                    return False
                os.replace(tmp, part)
                completed.add(seg)
                rz.save_manifest(output_path, expect, completed)
                frames_done += count
                self._report_progress(0.05 + 0.85 * frames_done / total,
                                      f"Segment {seg + 1}/{n_seg} done")

            self._report_progress(0.92, "Concatenating segments...")
            ok = rz.concat_segments(output_path, n_seg, source_path=input_path)
            self._report_progress(1.0, "Video processing complete!" if ok else "Concat failed")
            return ok
        except Exception as e:
            self._report_progress(1.0, f"Error: {e}")
            logger.error(f"Segmented video processing error: {e}", exc_info=True)
            return False


def _log_progress(fraction: float, message: str) -> None:
    logger.info(f"[{fraction * 100:5.1f}%] {message}")


def process_single_video(config: Dict[str, Any], neural_pixelizer=None,
                         resume: bool = False, host_index: int = 0,
                         host_count: int = 1, device: DeviceLike = "cuda") -> bool:
    """Config-driven video processing on ``device``: palette from the first
    frame, then stream; progress goes to the log. ``host_count > 1`` raises
    NotImplementedError (ROADMAP A11)."""
    from dither_pie_tpu_torch.pipeline.image import build_ditherer

    _require_one_host(host_count)
    try:
        input_path = Path(config["input"])
        output_path = Path(config["output"])
        logger.info(f"Processing video: {input_path.name}")

        if not ffio.video_available():
            logger.error("No video backend available (need ffmpeg on PATH, "
                         "or OpenCV as a video-only fallback)")
            return False

        processor = VideoProcessor(progress_callback=_log_progress)
        info = processor.get_video_info(str(input_path))
        logger.info(f"Video: {info['width']}x{info['height']}, "
                    f"{info['fps']:.2f} fps, {info['frame_count']} frames")

        logger.info("Loading first frame for palette generation...")
        first = ffio.read_single_frame(str(input_path), 0)
        if first is None:
            logger.error("Could not decode first frame")
            return False

        try:
            ditherer = build_ditherer(config, Image.fromarray(first), device)
        except ValueError:
            logger.error(f"Invalid dither mode: {config['dithering']['mode']}")
            return False

        pixelize_func = None
        if config["pixelization"]["enabled"]:
            method = config["pixelization"]["method"]
            if method in (PixelizeMethod.REGULAR.value, PixelizeMethod.NEURAL.value):
                pixelize_func = (method, config["pixelization"]["max_size"])
                if method == PixelizeMethod.NEURAL.value:
                    get_neural_pixelizer()

        final_resize = (config["final_resize"]["multiplier"]
                        if config["final_resize"]["enabled"] else None)

        output_path.parent.mkdir(parents=True, exist_ok=True)
        logger.info("Processing video frames...")
        ok = processor.process_video_streaming(
            str(input_path), str(output_path), ditherer,
            pixelize_func=pixelize_func, final_resize_multiplier=final_resize,
            resume=resume)
        if ok:
            size_mb = output_path.stat().st_size / (1024 * 1024)
            logger.info(f"Video processed successfully ({size_mb:.1f} MB)")
            return True
        logger.error("Video processing failed")
        return False
    except KeyboardInterrupt:
        logger.warning("Video processing interrupted by user")
        raise
    except NotImplementedError:
        raise
    except Exception as e:
        logger.error(f"Failed to process video: {e}", exc_info=True)
        return False
