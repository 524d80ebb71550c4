"""Single-image pipeline: load -> pixelize -> palette -> dither -> final
resize -> save, driven by a validated config (``api/config.py``). The port
of ``dither_pie_tpu/pipeline/image.py``; the neural pixelizer, the
ditherer and the k-means palette run on ``device`` ("cuda" unless the
caller asks for the CPU).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Tuple

from PIL import Image

from dither_pie_tpu_torch.api.config import ConfigValidationError
from dither_pie_tpu_torch.api.ditherer import (
    ColorReducer,
    DitherMode,
    ImageDitherer,
    PaletteSource,
    PixelizeMethod,
)
from dither_pie_tpu_torch.api.runtime import DeviceLike
from dither_pie_tpu_torch.pipeline.pixelize import get_neural_pixelizer, pixelize_regular
from dither_pie_tpu_torch.utils import PaletteManager

logger = logging.getLogger("dither_pie_tpu_torch")

RGB = Tuple[int, int, int]


def setup_palette_from_config(palette_config: Dict[str, Any], source_image: Image.Image,
                              device: DeviceLike = "cuda") -> Tuple[List[RGB], int]:
    """Build the palette per config; returns (palette, actual color count).

    Custom and predefined palettes override num_colors with their own
    length, as the original application does.
    """
    source = palette_config["source"]
    num_colors = palette_config["num_colors"]
    is_custom = False

    if source == PaletteSource.MEDIAN_CUT.value:
        logger.info(f"Generating palette: {source} ({num_colors} colors)")
        palette = ColorReducer.reduce_colors(source_image, num_colors)
    elif source == PaletteSource.KMEANS.value:
        logger.info(f"Generating palette: {source} ({num_colors} colors)")
        palette = ColorReducer.generate_kmeans_palette(source_image, num_colors,
                                                       random_state=42, device=device)
    elif source == PaletteSource.UNIFORM.value:
        logger.info(f"Generating palette: {source} ({num_colors} colors)")
        palette = ColorReducer.generate_uniform_palette(num_colors)
    elif source.startswith("file:"):
        file_path = source[5:]
        if not Path(file_path).exists():
            raise ConfigValidationError(f"Palette source image not found: {file_path}")
        logger.info(f"Extracting palette from: {file_path} ({num_colors} colors)")
        ref_image = Image.open(file_path).convert("RGB")
        palette = ColorReducer.generate_kmeans_palette(ref_image, num_colors,
                                                       random_state=42, device=device)
    else:
        name = source[7:] if source.startswith("custom:") else source
        mgr = PaletteManager()
        pal = mgr.get_palette(name)
        if pal is None:
            raise ConfigValidationError(
                f"Custom palette not found: {name}" if source.startswith("custom:")
                else f"Unknown palette source: {source}")
        palette = [mgr._hex_to_rgb(c) for c in pal["colors"]]
        is_custom = True
        logger.info(f"Loading custom palette: {name} ({len(palette)} colors)")

    actual = len(palette) if is_custom else num_colors
    logger.info(f"Palette ready with {len(palette)} colors")
    return palette, actual


def apply_pixelization(image: Image.Image, pix_config: Dict[str, Any],
                       device: DeviceLike = "cuda") -> Image.Image:
    """Pixelize per config; the neural pixelizer runs on ``device``."""
    if not pix_config.get("enabled"):
        return image
    method = pix_config["method"]
    max_size = pix_config["max_size"]
    if method == PixelizeMethod.REGULAR.value:
        return pixelize_regular(image, max_size)
    if method == PixelizeMethod.NEURAL.value:
        return get_neural_pixelizer(device=device).pixelize(image, max_size)
    return image


def apply_final_resize(image: Image.Image, multiplier: int) -> Image.Image:
    w, h = image.size
    return image.resize((w * multiplier, h * multiplier), Image.Resampling.NEAREST)


def build_ditherer(config: Dict[str, Any], source_image: Image.Image,
                   device: DeviceLike = "cuda") -> ImageDitherer:
    """An ImageDitherer on ``device`` (palette included) from a validated
    config."""
    palette, actual_num_colors = setup_palette_from_config(config["palette"], source_image,
                                                           device)
    dither_mode = DitherMode(config["dithering"]["mode"])
    return ImageDitherer(
        num_colors=actual_num_colors,
        dither_mode=dither_mode,
        palette=palette,
        use_gamma=config["palette"]["use_gamma"],
        dither_params=config["dithering"].get("parameters", {}),
        device=device,
    )


def process_single_image(config: Dict[str, Any], device: DeviceLike = "cuda") -> bool:
    """Full image pipeline per validated config on ``device``; returns
    success."""
    try:
        input_path = Path(config["input"])
        output_path = Path(config["output"])

        logger.info(f"Loading image: {input_path.name}")
        image = Image.open(input_path).convert("RGB")
        logger.info(f"Image size: {image.size[0]}x{image.size[1]}")

        processed = apply_pixelization(image, config["pixelization"], device)
        if processed is not image:
            logger.info(f"Pixelized to {processed.size[0]}x{processed.size[1]}")

        if config["dithering"]["enabled"]:
            mode = config["dithering"]["mode"]
            logger.info(f"Applying dithering: {mode}")
            try:
                ditherer = build_ditherer(config, processed, device)
            except ValueError:
                logger.error(f"Invalid dither mode: {mode}")
                return False
            processed = ditherer.apply_dithering(processed)
            logger.info("Dithering complete")

        if config["final_resize"]["enabled"]:
            multiplier = config["final_resize"]["multiplier"]
            processed = apply_final_resize(processed, multiplier)
            logger.info(f"Resized to {processed.size[0]}x{processed.size[1]}")

        output_path.parent.mkdir(parents=True, exist_ok=True)
        logger.info(f"Saving to: {output_path}")
        processed.save(output_path)
        size_kb = output_path.stat().st_size / 1024
        logger.info(f"Image saved successfully ({size_kb:.1f} KB)")
        return True

    except KeyboardInterrupt:
        logger.warning("Image processing interrupted by user")
        raise
    except Exception as e:
        logger.error(f"Failed to process image: {e}", exc_info=True)
        return False
