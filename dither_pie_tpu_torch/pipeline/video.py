"""Video pipeline: ffmpeg rawvideo streaming -> host batch assembly ->
batched dithering on the card -> streaming encode.

The port of ``dither_pie_tpu/pipeline/video.py``. Frames stream through
rawvideo pipes (``ffio.py``), are stacked into (B, H, W, 3) batches (or
(3, B, H, W) planes in the zero-copy gbrp flow; in page-locked host blocks
on a CUDA ditherer) and go through
``ImageDitherer.apply_dithering_batch``: the wavefront kernels K1 -> K2 ->
K3 (K6 for planes) for error diffusion, K4 for the ordered family, the host
engine for serpentine scans and Riemersma.

Semantics kept from the original application:
  * one palette, computed from the FIRST frame, governs the whole video;
  * per-frame retry (x2) with nearest-good-frame patching on failure;
  * the encoder settings (libx264 crf18 yuv420p, -vframes N, audio +
    subtitle stream copy);
  * the progress callback protocol ``(fraction: float, message: str)``.

The neural pixelizer (``pipeline/pixelize.py``, ``models/``) runs on the
ditherer's device, on the main thread: a batch of frames is one stacked
forward, and its frames reach the dither workers as numpy arrays.

Multi-host sharding (``host_count > 1``, ``parallel/multihost.py``): each
host encodes its strided share of the segment grid, and the host that sees
every part present concatenates them under an O_EXCL lock.

Where it differs from the JAX package: a tail batch runs at its own size
(the kernels take any batch, so nothing is padded); with ``overlap`` each
of the two workers runs its batches on a CUDA stream of its own.

Frame sources are pluggable: any iterator of (H, W, 3) uint8 arrays works,
so the pipeline runs without ffmpeg (the tests feed synthetic frames).
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import queue
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from dither_pie_tpu_torch.api import transfer
from dither_pie_tpu_torch.api.ditherer import ImageDitherer, PixelizeMethod
from dither_pie_tpu_torch.api.profiling import count, stage
from dither_pie_tpu_torch.api.runtime import DeviceLike
from dither_pie_tpu_torch.parallel.multihost import host_segments
from dither_pie_tpu_torch.pipeline import ffio
from dither_pie_tpu_torch.pipeline import resume as rz
from dither_pie_tpu_torch.pipeline.pixelize import get_neural_pixelizer, pixelize_regular

logger = logging.getLogger("dither_pie_tpu_torch")

__all__ = ["NeuralPixelizer", "VideoProcessor", "pixelize_regular", "process_single_video",
           "process_frames"]


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


def _pixelize_frame(arr: np.ndarray, method: Optional[str], max_size: int,
                    device: DeviceLike = "cuda") -> np.ndarray:
    if method == PixelizeMethod.REGULAR.value:
        return np.array(pixelize_regular(Image.fromarray(arr), max_size))
    if method == PixelizeMethod.NEURAL.value:
        out = get_neural_pixelizer(device=device).pixelize(Image.fromarray(arr), max_size)
        return np.array(out.convert("RGB"))
    return arr


def _pixelize_frames(arrs: List[np.ndarray], method: Optional[str], max_size: int,
                     device: DeviceLike = "cuda") -> List[np.ndarray]:
    """Pixelize a batch of frames: the neural pixelizer (on ``device``)
    stacks several frames into one forward; regular pixelization is a host
    resize a frame."""
    if method == PixelizeMethod.NEURAL.value and len(arrs) > 1:
        outs = get_neural_pixelizer(device=device).pixelize_batch(
            [Image.fromarray(a) for a in arrs], max_size)
        return [np.array(o.convert("RGB")) for o in outs]
    return [_pixelize_frame(a, method, max_size, device) for a in arrs]


def _prefetch(iterable: Iterable, depth: int) -> Iterator:
    """Pull from ``iterable`` on a background thread through a bounded queue
    so frame decode overlaps the dithering. Worker exceptions re-raise at
    the consumer. Each get is a ``video.prefetch_get`` span and adds the
    queue's depth before it to ``video.prefetch_depth``."""
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
        depth = q.qsize()
        with stage("video.prefetch_get"):
            item = q.get()
        count("video.prefetch_depth", depth)
        count("video.prefetch_gets")
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


# Threads that copy a batch's frames into its pinned block: one thread
# copies at ~5 GB/s on the H100's host, where a batch of 16 1080p frames
# took 19 ms alone; four shared by both workers, 10 ms each.
STACK_THREADS = min(4, os.cpu_count() or 1)


def _stack(arrs: List[np.ndarray], planar: bool,
           copier: Optional[ThreadPoolExecutor] = None) -> np.ndarray:
    """``np.stack`` of a batch's frames; planar frames are (3, H, W) and
    stack on axis 1, (3, B, H, W). With ``copier``: into a page-locked
    block (``transfer.pinned_array``), which ``to_device`` sends without a
    pageable copy, a frame a task on ``copier``'s threads."""
    axis = 1 if planar else 0
    if copier is None:
        return np.stack(arrs, axis=axis)
    shape = np.shape(arrs[0])
    if any(np.shape(a) != shape for a in arrs):
        raise ValueError("all input arrays must have the same shape")
    out = transfer.pinned_array(shape[:axis] + (len(arrs),) + shape[axis:],
                                np.result_type(*arrs))
    # Frame i's slot is out[i], or out[:, i] for planes: np.stack's copies.
    list(copier.map(np.copyto, np.moveaxis(out, axis, 0), arrs))
    return out


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
    tensors are made and used on one stream; the batch is stacked into a
    page-locked block and sent from it without blocking the worker
    (``api/transfer.py``), and the batch's copy back waits for that stream
    before a frame is emitted. Results are emitted strictly in order either
    way.

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
    device = getattr(ditherer, "device", None)
    batch: List[np.ndarray] = []
    done = 0
    last_good: Optional[np.ndarray] = None
    pending_patch = 0  # leading frames that failed before any success

    # On a CUDA ditherer the batches are stacked into pinned blocks.
    copier = (ThreadPoolExecutor(max_workers=STACK_THREADS, thread_name_prefix="batch-stack")
              if device is not None and device.type == "cuda" else None)

    def run_batch(arrs: List[np.ndarray], number: int) -> List[Optional[np.ndarray]]:
        with stage("video.stack", number):
            stacked = _stack(arrs, planar, copier)
        try:
            with stage("video.dither_batch", number):
                out = ditherer.apply_dithering_batch(stacked, planar=planar)
            return [out[:, i] if planar else out[i] for i in range(len(arrs))]
        except Exception as e:
            logger.warning(f"Batch dither failed ({e}); retrying per frame")
            count("video.batches_retried")
            results: List[Optional[np.ndarray]] = []
            with stage("video.retry", number):
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
                    if ok is None:
                        count("video.frames_failed")
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
                count("video.frames_patched")
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
                count("video.frames")
                yield emit.copy()
            pending_patch = 0
            done += 1
            count("video.frames")
            yield emit
            if progress and total_frames and done % 5 == 0:
                progress(0.1 + 0.8 * done / total_frames,
                         f"Processed {done}/{total_frames} frames")

    def pixelized(arrs):
        with stage("video.pixelize"):
            return _pixelize_frames(arrs, method, max_size, device or "cuda")

    numbers = itertools.count()
    if not overlap:
        try:
            for frame in frames:
                batch.append(np.asarray(frame))
                if len(batch) >= batch_size:
                    yield from emit_results(run_batch(pixelized(batch), next(numbers)))
                    batch.clear()
            if batch:
                yield from emit_results(run_batch(pixelized(batch), next(numbers)))
        finally:
            if copier is not None:
                copier.shutdown(wait=False)
        return

    local = threading.local()

    def run_on_own_stream(arrs, number):
        if device is None or device.type != "cuda":
            return run_batch(arrs, number)
        if not hasattr(local, "stream"):
            local.stream = torch.cuda.Stream(device)
        with torch.cuda.stream(local.stream):
            return run_batch(arrs, number)

    ex = ThreadPoolExecutor(max_workers=2, thread_name_prefix="dither-batch")
    pending: "collections.deque" = collections.deque()

    def submit(arrs):
        number = next(numbers)
        pending.append((number, ex.submit(run_on_own_stream, arrs, number)))

    def oldest_results():
        number, future = pending.popleft()
        with stage("video.wait", number):
            return future.result()

    try:
        for frame in frames:
            batch.append(np.asarray(frame))
            if len(batch) >= batch_size:
                # Pixelize on the main thread (the neural pixelizer's
                # forward), then hand the dither to the pool.
                submit(pixelized(batch))
                batch = []
                while len(pending) > 2:
                    yield from emit_results(oldest_results())
        if batch:
            submit(pixelized(batch))
        while pending:
            yield from emit_results(oldest_results())
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
        if copier is not None:
            copier.shutdown(wait=False)


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
        ``host_index``/``host_count`` shard the segment grid across hosts
        (``parallel/multihost.py``): host k processes segments
        ``i % host_count == k`` only, and the final concat runs on whichever
        host sees every part file present (shared filesystem). A count above
        1 implies the segmented path."""
        if not ffio.video_available():
            logger.error("No video backend available (need ffmpeg on PATH, "
                         "or OpenCV as a video-only fallback)")
            return False
        if resume or host_count > 1:
            return self._process_segmented(
                input_path, output_path, ditherer, pixelize_func,
                batch_size or self.batch_size, final_resize_multiplier, segment_size,
                host_index=host_index, host_count=host_count)
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

    # A concat of even a long video is minutes; an hour-old lock means the
    # holder is gone (crashed or SIGKILLed mid-concat).
    CONCAT_LOCK_STALE_S = 3600.0

    @classmethod
    def _claim_concat_lock(cls, lock: str) -> bool:
        """Atomically claim ``lock``, reclaiming stale locks.

        The lock file records ``pid hostname``. It is dead (and reclaimed)
        when the recorded pid no longer exists on THIS host, or when the
        file is older than CONCAT_LOCK_STALE_S on any host. Returns True
        when this process holds the lock."""
        for _ in range(2):  # initial try + one retry after reclaiming
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with os.fdopen(fd, "w") as f:
                    f.write(f"{os.getpid()} {socket.gethostname()}")
                return True
            except FileExistsError:
                pass
            try:
                stat = os.stat(lock)
                holder_pid, holder_host = None, None
                with open(lock) as f:
                    parts = f.read().split()
                    if len(parts) >= 2:
                        holder_pid, holder_host = int(parts[0]), parts[1]
            except (OSError, ValueError):
                continue  # holder finished (file gone) or mid-write: retry
            stale = (time.time() - stat.st_mtime) > cls.CONCAT_LOCK_STALE_S
            dead_local = False
            if holder_pid is not None and holder_host == socket.gethostname():
                try:
                    os.kill(holder_pid, 0)
                except ProcessLookupError:
                    dead_local = True
                except OSError:
                    pass
            if stale or dead_local:
                logger.warning(f"Reclaiming dead concat lock {lock} "
                               f"(holder pid={holder_pid} host={holder_host})")
                try:
                    os.remove(lock)
                except OSError:
                    pass
                continue
            return False
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
                           final_resize_multiplier, segment_size: int,
                           host_index: int = 0, host_count: int = 1) -> bool:
        """Checkpoint/resume path: encode fixed-size segments to part files
        with a manifest; re-running skips completed segments; parts are
        concatenated (stream copy) with the original audio mapped in.

        With ``host_count > 1`` this host processes only its strided share
        of the segment grid and records it in a per-host manifest; the
        concat runs only once every segment's part exists, so each host
        returns True when ITS share is done."""
        single_pass = dict(pixelize_func=pixelize_func, batch_size=batch_size,
                           final_resize_multiplier=final_resize_multiplier)
        if not ffio.ffmpeg_available():
            if host_count > 1:
                logger.error("Multi-host sharding needs ffmpeg "
                             "(segment encode/concat)")
                return False
            logger.warning("Resume mode needs ffmpeg (segment concat); "
                           "falling back to single-pass processing")
            return self.process_video_streaming(input_path, output_path, ditherer,
                                                **single_pass)
        try:
            info = self.get_video_info(input_path)
            fps, w, h = info["fps"], info["width"], info["height"]
            total = info.get("frame_count")
            if not total:
                if host_count > 1:
                    logger.error("Unknown frame count; cannot shard video")
                    return False
                logger.warning("Unknown frame count; resume unavailable — "
                               "falling back to single-pass processing")
                return self.process_video_streaming(input_path, output_path, ditherer,
                                                    **single_pass)

            expect = {"input": os.path.abspath(input_path),
                      "fps": round(fps, 5), "segment_size": segment_size,
                      "total_frames": total,
                      "settings": self._settings_fingerprint(
                          ditherer, pixelize_func, final_resize_multiplier)}
            completed = rz.load_manifest(output_path, expect, host_index=host_index)
            n_seg = rz.n_segments(total, segment_size)
            mine = host_segments(n_seg, host_index, host_count)
            if completed:
                logger.info(f"Resuming: {len(completed)}/{len(mine)} "
                            f"of this host's segments done")

            use_planar = pixelize_func is None and ditherer.supports_planar_batch()
            reader = (ffio.read_frames_planar(input_path, w, h) if use_planar
                      else ffio.read_frames(input_path, w, h))
            frames_done = 0
            for seg, start, end in rz.plan_segments(total, segment_size, set()):
                count = end - start
                if seg not in mine or seg in completed:
                    # Another host's segment, or already encoded: decode and
                    # discard to stay aligned.
                    for _ in itertools.islice(reader, count):
                        pass
                    frames_done += count
                    continue
                # Encode to a tmp name and rename when complete: a part file
                # is never visible half-written (other hosts gate the concat
                # on part existence).
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
                rz.save_manifest(output_path, expect, completed, host_index=host_index)
                frames_done += count
                self._report_progress(0.05 + 0.85 * frames_done / total,
                                      f"Segment {seg + 1}/{n_seg} done")

            if host_count > 1:
                return self._concat_when_complete(input_path, output_path, expect,
                                                  n_seg, host_count)
            self._report_progress(0.92, "Concatenating segments...")
            ok = rz.concat_segments(output_path, n_seg, source_path=input_path)
            self._report_progress(1.0, "Video processing complete!" if ok else "Concat failed")
            return ok
        except Exception as e:
            self._report_progress(1.0, f"Error: {e}")
            logger.error(f"Segmented video processing error: {e}", exc_info=True)
            return False

    def _concat_when_complete(self, input_path: str, output_path: str, expect: Dict,
                              n_seg: int, host_count: int) -> bool:
        """A multi-host job's last step on this host: concatenate only when
        every segment is covered by a manifest MATCHING this job's settings
        fingerprint and its part exists (stale parts of an older run with
        other settings are never concatenated), and only under the concat
        lock (two hosts can finish at once; the loser reports its share
        done). True when this host's share is done or the concat
        succeeded."""
        covered = rz.load_all_manifests(output_path, expect, host_count)
        if covered != set(range(n_seg)) or not rz.all_parts_present(output_path, n_seg):
            logger.info("This host's segments are done; waiting on "
                        "other hosts' parts before concat")
            self._report_progress(1.0, "Host share complete (concat pending)")
            return True
        # The lock is reclaimable: a holder that died mid-concat (dead local
        # pid, or a lock older than the stale age from any host) would
        # otherwise block every future rerun.
        lock = output_path + ".concat.lock"
        if not self._claim_concat_lock(lock):
            logger.info("Another host is concatenating")
            self._report_progress(1.0, "Host share complete (concat in progress)")
            return True
        try:
            self._report_progress(0.92, "Concatenating segments...")
            ok = rz.concat_segments(output_path, n_seg, source_path=input_path)
        finally:
            try:
                os.remove(lock)
            except OSError:
                pass
        self._report_progress(1.0, "Video processing complete!" if ok else "Concat failed")
        return ok


class NeuralPixelizer:
    """The original application's video-level neural pixelizer: a thin
    wrapper of the process-wide pixelizer of ``device``
    (``pipeline/pixelize.get_neural_pixelizer``). Distinct from
    ``models.pixelizer.NeuralPixelizer``, which it wraps."""

    def __init__(self, device: DeviceLike = "cuda"):
        self._impl = get_neural_pixelizer(device=device)

    def pixelize(self, image: Image.Image, max_size: int) -> Image.Image:
        return self._impl.pixelize(image, max_size)


def process_single_video(config: Dict[str, Any], neural_pixelizer=None,
                         resume: bool = False, host_index: int = 0,
                         host_count: int = 1, device: DeviceLike = "cuda") -> bool:
    """Config-driven video processing on ``device``: palette from the first
    frame, then stream, with the command line's progress bar.
    ``host_index``/``host_count`` shard the segment grid across hosts
    (CLI ``--shard INDEX:COUNT``; see ``parallel/multihost.py``)."""
    from dither_pie_tpu_torch.cli.main import CLIProgressCallback
    from dither_pie_tpu_torch.pipeline.image import build_ditherer

    try:
        input_path = Path(config["input"])
        output_path = Path(config["output"])
        logger.info(f"Processing video: {input_path.name}")

        if not ffio.video_available():
            logger.error("No video backend available (need ffmpeg on PATH, "
                         "or OpenCV as a video-only fallback)")
            return False

        cb = CLIProgressCallback()
        processor = VideoProcessor(progress_callback=cb.update)
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
                if method == PixelizeMethod.NEURAL.value and neural_pixelizer is None:
                    logger.info("Loading neural pixelization models...")
                    get_neural_pixelizer(device=ditherer.device)

        final_resize = (config["final_resize"]["multiplier"]
                        if config["final_resize"]["enabled"] else None)

        output_path.parent.mkdir(parents=True, exist_ok=True)
        logger.info("Processing video frames...")
        with cb:
            ok = processor.process_video_streaming(
                str(input_path), str(output_path), ditherer,
                pixelize_func=pixelize_func, final_resize_multiplier=final_resize,
                resume=resume, host_index=host_index, host_count=host_count)
        if ok:
            if output_path.exists():
                size_mb = output_path.stat().st_size / (1024 * 1024)
                logger.info(f"Video processed successfully ({size_mb:.1f} MB)")
            else:
                # Multi-host: this host's share is done; the final concat
                # runs on whichever host sees every part present.
                logger.info("Host share complete (final concat pending on "
                            "other hosts)")
            return True
        logger.error("Video processing failed")
        return False
    except KeyboardInterrupt:
        logger.warning("Video processing interrupted by user")
        raise
    except Exception as e:
        logger.error(f"Failed to process video: {e}", exc_info=True)
        return False
