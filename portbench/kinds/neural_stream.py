"""Traffic kind "neural_stream": a decoded clip through ``process_frames``
with the neural pixelize stage.

The "stream" kind's closed loop (the pool's frame i mod N the moment the
pipeline asks, stopping on the first batch boundary once the window's
seconds have passed; batch from the traffic, overlap and prefetch on), with
``pixelize_func=("neural", max_size)``: the main thread pixelizes each
batch through the process-wide neural pixelizer, the two workers dither.

The pixelizer is the program's, ``NeuralPixelizer.from_model`` over a
``PixelizationModel`` on ``load_random(weights_seed)``, installed with
``install_neural_pixelizer`` as the README installs other weights, behind
a tee of this benchmark: the tee hands every call on unchanged and keeps
a reference to the pixelized frames at the kept positions, nothing else.
The ditherer comes from frame 0 as the other kinds build it. No switch of
the program is set: the precision and the ds4 stride are what its
first-batch gates lock, inside the warm-up.

The check (``check``): the palette as the error-diffusion cells check it;
the kept pixelized frames against the reference's pixelization of the
same inputs (``references/pixelization.py``, float32); the kept final
frames against the reference's error diffusion of the program's own
pixelized frames to the reference's palette, bitwise; the gates' verdicts
against the configuration's; frames missing or patched.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import neural_work
from portbench.kinds import System, Window, launch_total, optional_span, stream, sync

# The scan reads the pixelized uint8 frames as they come.
SCAN_INPUT_BYTES = 1


class Tee:
    """The program's pixelizer, every call handed on unchanged; while
    ``keep`` is set, the outputs at the kept positions (counted from 0 over
    the frames pixelized since) are kept by reference."""

    def __init__(self, pixelizer):
        self.inner = pixelizer
        self.keep: Optional[Callable[[int], bool]] = None
        self.at = 0
        self.kept: Dict[int, Any] = {}

    @property
    def device(self):
        return self.inner.device

    def record(self, keep: Optional[Callable[[int], bool]]) -> None:
        self.keep, self.at, self.kept = keep, 0, {}

    def _seen(self, outs: List[Any]) -> List[Any]:
        if self.keep is not None:
            self.kept.update((self.at + k, o) for k, o in enumerate(outs)
                             if self.keep(self.at + k))
        self.at += len(outs)
        return outs

    def pixelize(self, image, max_size: int):
        return self._seen([self.inner.pixelize(image, max_size)])[0]

    def pixelize_batch(self, images, max_size: int):
        return self._seen(self.inner.pixelize_batch(images, max_size))


@dataclass
class Neural:
    """The kind's own pieces of the system under test."""

    model: Any
    tee: Tee
    max_size: int
    frame_flops: int


@dataclass
class NeuralWindow(Window):
    pixelized: Dict[int, np.ndarray] = field(default_factory=dict)
    frame_flops: int = 0


def setup(config: Dict[str, Any], traffic: Dict[str, Any], pool: np.ndarray,
          device: torch.device, lines: List[str], pieces: Dict[str, float]) -> System:
    from dither_pie_tpu_torch.models.inference import PixelizationModel
    from dither_pie_tpu_torch.models.pixelizer import NeuralPixelizer
    from dither_pie_tpu_torch.pipeline.pixelize import install_neural_pixelizer

    system = stream.setup(config, traffic, pool, device, lines, pieces)
    t = time.perf_counter()
    model = PixelizationModel(device=device)
    model.load_random(int(config["neural"]["weights_seed"]))
    tee = Tee(NeuralPixelizer.from_model(model))
    install_neural_pixelizer(tee)
    pieces["weights_s"] = time.perf_counter() - t
    max_size = int(config["pixelization"]["max_size"])
    h, w = neural_work.net_input(pool.shape[1], pool.shape[2], max_size)
    system.inputs = Neural(model=model, tee=tee, max_size=max_size,
                           frame_flops=neural_work.frame_flops(h, w))
    lines.append(f"neural input {h}x{w}, {system.inputs.frame_flops / 1e12:.6f} TFLOP a frame")
    return system


def _frames(system: System, source, batch: int):
    from dither_pie_tpu_torch.pipeline.video import process_frames

    return process_frames(source, system.ditherer, batch_size=batch,
                          pixelize_func=("neural", system.inputs.max_size))


def warm(system: System, pool: np.ndarray, traffic: Dict[str, Any]) -> None:
    """The warm-up batches, the first of which runs the gates."""
    batch = int(traffic["batch"])
    for _ in _frames(system, iter(pool[:batch * int(traffic["warmup_batches"])]), batch):
        pass


def window(system: System, pool: np.ndarray, traffic: Dict[str, Any], seconds: float,
           keep: Callable[[int], bool], span: Optional[str] = None) -> NeuralWindow:
    batch = int(traffic["batch"])
    win = NeuralWindow(seconds=seconds, frame_flops=system.inputs.frame_flops)
    n = pool.shape[0]
    tee = system.inputs.tee

    def source():
        i = 0
        while not (i % batch == 0 and time.perf_counter() >= win.start + seconds):
            win.handed.append(time.perf_counter())
            yield pool[i % n]
            i += 1

    launches0 = launch_total()
    tee.record(keep)
    try:
        with optional_span(span):
            win.start = time.perf_counter()
            for j, out in enumerate(_frames(system, source(), batch)):
                win.done.append(time.perf_counter())
                if keep(j):
                    win.kept[j] = np.array(out)
            sync(system.ditherer.device)
    finally:
        kept = tee.kept
        tee.record(None)
    win.pixelized = {j: np.array(im.convert("RGB")) for j, im in kept.items()}
    win.launches = launch_total() - launches0
    return win


latencies = stream.latencies
failed = stream.failed
profile = stream.profile


def end_to_end(win: Window, setup_s: float) -> Dict[str, float]:
    return {"setup_s": setup_s}


def counters(win: NeuralWindow, traffic: Dict[str, Any]) -> Dict[str, int]:
    return {**stream.counters(win, traffic), "frame_flops": win.frame_flops}


def scan_launch(traffic: Dict[str, Any]):
    return int(traffic["batch"]), SCAN_INPUT_BYTES


def _worst(pairs, far_steps: int):
    """The worst frame's mean |a - b| and share of pixels with a channel
    more than ``far_steps`` apart (255 and 1 where the shapes differ)."""
    mean = far = 0.0
    for a, b in pairs:
        if a.shape != b.shape:
            return 255.0, 1.0
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        mean = max(mean, float(d.mean()))
        far = max(far, float((d.max(-1) > far_steps).mean()))
    return mean, far


def check(config: Dict[str, Any], ref, pool: np.ndarray, system: System, win: NeuralWindow,
          device: torch.device) -> Dict[str, Dict[str, float]]:
    """Every number compared, each beside its limit (``config["limits"]``;
    their reasons in ``config["limit_reasons"]``)."""
    ref_pal = ref.palette(pool[0], config, device)
    values = dict(ref.palette_checks(pool[0], system.palette, ref_pal, config))
    n = pool.shape[0]
    wanted = sorted({j % n for j in win.kept})
    ref_px = dict(zip(wanted, ref.pixelize(pool[wanted], config, device))) if wanted else {}
    missing = [j for j in win.kept if j not in win.pixelized]
    mean, far = _worst(((win.pixelized[j], ref_px[j % n]) for j in win.kept
                        if j in win.pixelized), int(config["neural"]["far_steps"]))
    worst = 1.0 if not win.kept or missing else 0.0
    kept = sorted(j for j in win.kept if j in win.pixelized)
    for lo in range(0, len(kept), 64):
        part = kept[lo:lo + 64]
        px = np.stack([win.pixelized[j] for j in part])
        for j, expected in zip(part, ref.dither(px, ref_pal, config, device)):
            out = win.kept[j]
            share = 1.0 if out.shape != expected.shape else float(
                np.any(out != expected, axis=-1).mean())
            worst = max(worst, share)
    model = system.inputs.model
    values.update(
        neural_mean_u8_delta=mean if win.kept else 255.0,
        neural_far_share=far if win.kept else 1.0,
        neural_gate_f32=0.0 if model._video_prec == config["neural"]["precision"] else 1.0,
        ds4_stride_mismatch=0.0 if model._ds4_stride == config["neural"]["ds4_stride"] else 1.0,
        mismatch_share=worst,
        frames_missing=float(len(win.handed) - len(win.done) + win.failed_calls),
        frames_patched=float(win.patched))
    limits = config["limits"]
    return {name: {"value": values[name], "limit": float(limits[name])} for name in limits}
