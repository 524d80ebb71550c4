"""Compatibility alias for the original application's ``video_processor``
module."""

from dither_pie_tpu_torch.pipeline.video import (  # noqa: F401
    NeuralPixelizer, VideoProcessor, pixelize_regular, process_frames)
