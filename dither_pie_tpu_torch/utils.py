"""Support utilities of the pipelines and the command line: palette files
and hex colours, lospec import, even output dimensions, file validation,
RGB images and the file extensions the config's mode detection and the
command line's folder mode read.

A copy of ``dither_pie_tpu/utils.py`` (framework-free; the port imports
nothing of the JAX package). The palette set is the port's copy of the
built-in palettes (``core/builtin_palettes.py``); ``import_lospec_palette``
needs the network.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from PIL import Image

RGB = Tuple[int, int, int]

__all__ = [
    "IMAGE_EXTENSIONS",
    "VIDEO_EXTENSIONS",
    "PaletteManager",
    "compute_even_dimensions",
    "default_palette_file",
    "ensure_rgb",
    "estimate_video_memory_usage",
    "get_image_info",
    "hex_to_rgb",
    "import_lospec_palette",
    "load_palettes_from_file",
    "palette_from_hex_list",
    "rgb_to_hex",
    "save_palettes_to_file",
    "validate_image_file",
    "validate_video_file",
]

_BUILTIN_SENTINEL = "<builtin>"

VIDEO_EXTENSIONS = {".mp4", ".avi", ".mov", ".mkv", ".wmv", ".flv", ".webm", ".m4v"}
IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".gif", ".bmp", ".tiff", ".webp"}


def hex_to_rgb(hex_color: str) -> RGB:
    """``"#a1b2c3"`` or ``"a1b2c3"`` -> ``(161, 178, 195)``."""
    s = hex_color.lstrip("#")
    return tuple(int(s[i:i + 2], 16) for i in (0, 2, 4))


def rgb_to_hex(rgb: RGB) -> str:
    """``(161, 178, 195)`` -> ``"#a1b2c3"``."""
    return f"#{rgb[0]:02x}{rgb[1]:02x}{rgb[2]:02x}"


def palette_from_hex_list(hex_list: List[str]) -> List[RGB]:
    return [hex_to_rgb(h) for h in hex_list]


def default_palette_file() -> str:
    """A user palette.json in the working directory if there is one, else
    the built-in set."""
    if os.path.exists("palette.json"):
        return "palette.json"
    return _BUILTIN_SENTINEL


def load_palettes_from_file(filepath: Optional[str] = None) -> List[Dict]:
    filepath = filepath or default_palette_file()
    if filepath == _BUILTIN_SENTINEL:
        from dither_pie_tpu_torch.core.builtin_palettes import builtin_palette_list

        return builtin_palette_list()
    if not os.path.exists(filepath):
        return []
    try:
        with open(filepath, "r", encoding="utf-8") as f:
            palettes = json.load(f)
        return palettes if isinstance(palettes, list) else []
    except (OSError, ValueError) as e:
        print(f"Error loading palettes: {e}")
        return []


def save_palettes_to_file(palettes: List[Dict], filepath: str = "palette.json"):
    with open(filepath, "w", encoding="utf-8") as f:
        json.dump(palettes, f, indent=4)


def import_lospec_palette(url: str) -> Optional[Dict]:
    """Import a palette from a lospec.com URL (requires network access)."""
    try:
        import requests

        slug = url.rstrip("/").split("/")[-1]
        api_url = f"https://lospec.com/palette-list/{slug}.json"
        response = requests.get(api_url, timeout=10)
        response.raise_for_status()
        data = response.json()
        colors = [hex_to_rgb(f"#{c}") for c in data.get("colors", [])]
        if not colors:
            return None
        return {"name": data.get("name", slug),
                "colors": [rgb_to_hex(c) for c in colors]}
    except Exception as e:
        print(f"Error importing from Lospec: {e}")
        return None


def compute_even_dimensions(orig_w: int, orig_h: int, max_size: int) -> Tuple[int, int]:
    """Target dims: smaller side ~= max_size, both even (libx264/yuv420p)."""
    if orig_w >= orig_h:
        target_h = max_size if max_size % 2 == 0 else max_size - 1
        target_w = int(round((orig_w / orig_h) * target_h))
        if target_w % 2 != 0:
            target_w += 1
    else:
        target_w = max_size if max_size % 2 == 0 else max_size - 1
        target_h = int(round((orig_h / orig_w) * target_w))
        if target_h % 2 != 0:
            target_h += 1
    return target_w, target_h


def estimate_video_memory_usage(width: int, height: int, frame_count: int) -> float:
    """Rough MB estimate: 3 B/px RGB x1.5 overhead."""
    bytes_per_frame = width * height * 3 * 1.5
    return (bytes_per_frame * frame_count) / (1024 * 1024)


def validate_video_file(filepath: str) -> bool:
    ext = os.path.splitext(filepath)[1].lower()
    return ext in VIDEO_EXTENSIONS and os.path.exists(filepath)


def validate_image_file(filepath: str) -> bool:
    ext = os.path.splitext(filepath)[1].lower()
    return ext in IMAGE_EXTENSIONS and os.path.exists(filepath)


def get_image_info(filepath: str) -> Optional[Dict]:
    try:
        with Image.open(filepath) as img:
            return {"width": img.width, "height": img.height,
                    "mode": img.mode, "format": img.format}
    except Exception as e:
        print(f"Error getting image info: {e}")
        return None


def ensure_rgb(image: Image.Image) -> Image.Image:
    if image.mode != "RGB":
        return image.convert("RGB")
    return image


class PaletteManager:
    """CRUD over a palette.json file (a list of {name, colors: [#hex]});
    without one, the built-in set."""

    def __init__(self, filepath: Optional[str] = None):
        self.filepath = filepath or default_palette_file()
        self.palettes: List[Dict] = []
        self.load()

    @staticmethod
    def _hex_to_rgb(hex_color: str) -> RGB:
        return hex_to_rgb(hex_color)

    def load(self):
        self.palettes = load_palettes_from_file(self.filepath)

    def save(self):
        # The built-in set is never written back; edits go to a local
        # palette.json.
        if self.filepath == _BUILTIN_SENTINEL:
            self.filepath = "palette.json"
        save_palettes_to_file(self.palettes, self.filepath)

    def add_palette(self, name: str, colors: List[str]):
        for pal in self.palettes:
            if pal["name"] == name:
                pal["colors"] = colors
                self.save()
                return
        self.palettes.append({"name": name, "colors": colors})
        self.save()

    def remove_palette(self, name: str):
        self.palettes = [p for p in self.palettes if p["name"] != name]
        self.save()

    def get_palette(self, name: str) -> Optional[Dict]:
        for pal in self.palettes:
            if pal["name"] == name:
                return pal
        return None

    def get_palette_colors_rgb(self, name: str) -> Optional[List[RGB]]:
        pal = self.get_palette(name)
        return palette_from_hex_list(pal["colors"]) if pal else None

    def list_palette_names(self) -> List[str]:
        return [p["name"] for p in self.palettes]
