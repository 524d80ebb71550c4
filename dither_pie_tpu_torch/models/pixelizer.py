"""The neural pixelizer facade over ``inference.PixelizationModel``."""

from __future__ import annotations

from typing import Optional

from PIL import Image

from dither_pie_tpu_torch.api.runtime import DeviceLike
from dither_pie_tpu_torch.models.inference import PixelizationModel


class NeuralPixelizer:
    """Loads the released checkpoints (``checkpoint_dir``, else the search
    of ``convert.find_checkpoint_dir``) on ``device``; ``from_model`` wraps
    a model already loaded (random weights, for one)."""

    def __init__(self, checkpoint_dir: Optional[str] = None, device: DeviceLike = "cuda"):
        self._model = PixelizationModel(checkpoint_dir=checkpoint_dir, device=device)
        self._model.load()

    @classmethod
    def from_model(cls, model: PixelizationModel) -> "NeuralPixelizer":
        pix = cls.__new__(cls)
        pix._model = model
        return pix

    @property
    def device(self):
        return self._model.device

    def pixelize(self, image: Image.Image, max_size: int) -> Image.Image:
        return self._model.pixelize_image(image, max_size)

    def pixelize_batch(self, images, max_size: int):
        """Batched neural pixelization of same-size frames (the video path)."""
        return self._model.pixelize_images_batch(images, max_size)
