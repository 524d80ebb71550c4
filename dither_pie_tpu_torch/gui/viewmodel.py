"""Headless view-model for the GUI: every state transition and processing
callback of the app, with no tkinter import.

The tk layer (``gui/app.py``) is widget glue: dialogs gather inputs,
threads keep the UI live, and every decision (state machine, caches,
palette options, preview generation and supersession, adoption,
persistence) lives here, where it is driven end to end without a display.
It is the JAX package's view-model (``dither_pie_tpu/gui/viewmodel.py``)
case for case, on the port's ditherer: the display state machine
current/pixelized/dithered, the pixelization cache keyed (method,
max_size, md5 of sampled pixels), the 30-entry preview LRU keyed
(palette, gamma, mode, params) with generation tokens, and the last
palette/gamma recorded for the later video apply.

The device is resolved once, in the constructor (``"cuda"`` by default;
CUDA on a machine without a card raises), and every ditherer, k-means
palette and neural pixelizer the view-model asks for runs on it.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from dither_pie_tpu_torch.api.config_manager import ConfigManager
from dither_pie_tpu_torch.api.ditherer import ColorReducer, DitherMode, ImageDitherer
from dither_pie_tpu_torch.api.runtime import DeviceLike, resolve_device
from dither_pie_tpu_torch.pipeline.pixelize import pixelize_regular
from dither_pie_tpu_torch.utils import PaletteManager, import_lospec_palette

PREVIEW_CACHE_SIZE = 30

# ttk colour palettes for the persisted theme.appearance_mode key. Plain
# ttk has no appearance modes, so the equivalent surface is a style palette
# the app applies at startup (gui/app.py:_apply_theme). The decision lives
# here so it is testable without a display.
_THEME_PALETTES: Dict[str, Dict[str, str]] = {
    "dark": {
        "bg": "#2b2b2b", "fg": "#e6e6e6", "field": "#3c3f41",
        "button": "#3c3f41", "accent": "#4a6ea9", "canvas": "#1e1e1e",
    },
    "light": {
        "bg": "#f2f2f2", "fg": "#1a1a1a", "field": "#ffffff",
        "button": "#e6e6e6", "accent": "#9cb8e0", "canvas": "#ffffff",
    },
}


def theme_palette(appearance_mode: Optional[str]) -> Dict[str, str]:
    """Colour palette for a theme.appearance_mode value.

    "dark" / "light" map directly; "system" maps to LIGHT (with no
    display-server query available headlessly, tk's native look is light,
    the closest analogue of follow-the-OS). Unknown values fall back to the
    config default ("dark")."""
    mode = (appearance_mode or "").strip().lower()
    if mode == "system":
        mode = "light"
    return dict(_THEME_PALETTES.get(mode, _THEME_PALETTES["dark"]))


class AppViewModel:
    """All app state + processing logic, headless, on one device."""

    def __init__(self, config: Optional[ConfigManager] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.config = config or ConfigManager()

        # Display state machine: current | pixelized | dithered.
        self.current_image: Optional[Image.Image] = None
        self.pixelized_image: Optional[Image.Image] = None
        self.dithered_image: Optional[Image.Image] = None
        self.display_state = "current"
        self.video_path: Optional[str] = None
        self.last_palette: Optional[List[Tuple[int, int, int]]] = None
        self.last_gamma = False
        self.dither_parameters: Dict[str, Dict[str, Any]] = {}

        # Settings (the tk layer syncs its vars into these).
        self.mode: str = self.config.get("defaults", "dither_mode",
                                         default="bayer")
        self.num_colors: int = self.config.get("defaults", "num_colors",
                                               default=16)
        self.use_gamma: bool = self.config.get("defaults", "use_gamma",
                                               default=False)
        self.pixelize_max_size: int = self.config.get(
            "defaults", "pixelize_max_size", default=128)
        self.final_resize_multiplier: int = self.config.get(
            "defaults", "final_resize_multiplier", default=2)

        self._pixelize_cache: Dict[Tuple, Image.Image] = {}
        self._preview_cache: "OrderedDict[str, Image.Image]" = OrderedDict()
        self._preview_generation = 0

    # ------------------------------------------------------------- sources

    def active_source(self) -> Optional[Image.Image]:
        return self.pixelized_image or self.current_image

    def load_image(self, path: str) -> Image.Image:
        self.config.set_last_dir("image", str(Path(path).parent))
        self.config.add_recent_file(path)
        self.current_image = Image.open(path).convert("RGB")
        self.pixelized_image = None
        self.dithered_image = None
        self.video_path = None
        self.display_state = "current"
        return self.current_image

    def load_video(self, path: str) -> Image.Image:
        """First frame becomes the working image; raises on decode failure."""
        from dither_pie_tpu_torch.pipeline import ffio

        frame = ffio.read_single_frame(path, 0)
        if frame is None:
            raise ValueError("Could not decode first frame")
        self.config.set_last_dir("video", str(Path(path).parent))
        self.video_path = path
        self.current_image = Image.fromarray(frame)
        self.pixelized_image = None
        self.dithered_image = None
        self.display_state = "current"
        return self.current_image

    def random_video_frame(self, idx: Optional[int] = None
                           ) -> Tuple[Image.Image, int, int]:
        """Decode frame ``idx`` (random when None) of the open video."""
        if not self.video_path:
            raise ValueError("No video open")
        import random

        from dither_pie_tpu_torch.pipeline import ffio

        info = ffio.probe_video(self.video_path)
        n = info.get("frame_count") or 100
        if idx is None:
            idx = random.randint(0, max(0, n - 1))
        frame = ffio.read_single_frame(self.video_path, idx)
        if frame is None:
            raise ValueError(f"Could not decode frame {idx}")
        self.current_image = Image.fromarray(frame)
        self.pixelized_image = None
        self.dithered_image = None
        self.display_state = "current"
        return self.current_image, idx, n

    # -------------------------------------------------------- pixelization

    def _pixelize_key(self, method: str, max_size: int) -> Tuple:
        arr = np.asarray(self.current_image)
        sample = arr[:: max(1, arr.shape[0] // 16),
                     :: max(1, arr.shape[1] // 16)]
        digest = hashlib.md5(sample.tobytes()).hexdigest()
        return (method, max_size, digest)

    def cached_pixelize(self, method: str,
                        max_size: Optional[int] = None
                        ) -> Optional[Image.Image]:
        """Cache lookup only (the neural path checks before spawning its
        worker thread)."""
        if self.current_image is None:
            return None
        key = self._pixelize_key(method, max_size or self.pixelize_max_size)
        return self._pixelize_cache.get(key)

    def pixelize(self, method: str,
                 max_size: Optional[int] = None) -> Image.Image:
        """Pixelize the current image (synchronous; the tk layer threads the
        neural call). Updates the cache and display state."""
        if self.current_image is None:
            raise ValueError("No image open")
        max_size = max_size or self.pixelize_max_size
        key = self._pixelize_key(method, max_size)
        if key not in self._pixelize_cache:
            if method == "regular":
                out = pixelize_regular(self.current_image, max_size)
            elif method == "neural":
                from dither_pie_tpu_torch.pipeline.pixelize import \
                    get_neural_pixelizer

                out = get_neural_pixelizer(device=self.device).pixelize(
                    self.current_image, max_size)
            else:
                raise ValueError(f"unknown pixelize method: {method}")
            self._pixelize_cache[key] = out
        self.set_pixelized(self._pixelize_cache[key])
        return self.pixelized_image

    def set_pixelized(self, img: Image.Image) -> None:
        """Adopt an externally produced pixelization (pixel editor)."""
        self.pixelized_image = img
        self.dithered_image = None
        self.display_state = "pixelized"

    # ------------------------------------------------------------ dithering

    def params_for_mode(self, mode: Optional[str] = None) -> Dict[str, Any]:
        from dither_pie_tpu_torch.gui.logic import clamp_parameters

        mode = mode or self.mode
        info = ImageDitherer.get_mode_parameters(DitherMode(mode))
        if not info:
            return {}
        return clamp_parameters(info, self.dither_parameters.get(mode, {}))

    def build_ditherer(self, palette, num_colors) -> ImageDitherer:
        return ImageDitherer(num_colors=num_colors,
                             dither_mode=DitherMode(self.mode),
                             palette=palette,
                             use_gamma=self.use_gamma,
                             dither_params=self.params_for_mode(),
                             device=self.device)

    def palette_options(self, source_img: Image.Image
                        ) -> List[Tuple[str, List[Tuple[int, int, int]]]]:
        """(label, palette) choices: generated + palette.json entries."""
        n = int(self.num_colors)
        opts = [
            ("Median Cut", ColorReducer.reduce_colors(source_img, n)),
            ("K-means", ColorReducer.generate_kmeans_palette(
                source_img, n, device=self.device)),
            ("Uniform", ColorReducer.generate_uniform_palette(n)),
        ]
        mgr = PaletteManager()
        for pal in mgr.palettes:
            opts.append((pal["name"], mgr.get_palette_colors_rgb(pal["name"])))
        return opts

    def preview_cache_key(self, label: str, colors) -> str:
        params = self.params_for_mode()
        return (f"{label}|{colors}|{self.use_gamma}|{self.mode}|"
                f"{sorted(params.items())}")

    def get_cached_preview(self, key: str) -> Optional[Image.Image]:
        if key in self._preview_cache:
            self._preview_cache.move_to_end(key)
            return self._preview_cache[key]
        return None

    def begin_preview(self) -> int:
        """New preview generation token; older in-flight previews are
        superseded and will not commit."""
        self._preview_generation += 1
        return self._preview_generation

    def render_preview(self, label: str, colors,
                       source_img: Image.Image) -> Image.Image:
        """Synchronously dither the preview (the tk layer runs this on a
        worker thread)."""
        ditherer = self.build_ditherer(list(colors), len(colors))
        return ditherer.apply_dithering(source_img)

    def commit_preview(self, generation: int, key: str,
                       preview: Image.Image) -> bool:
        """Insert into the LRU unless a newer selection superseded this
        generation. Returns whether the preview is current."""
        if generation != self._preview_generation:
            return False
        self._preview_cache[key] = preview
        while len(self._preview_cache) > PREVIEW_CACHE_SIZE:
            self._preview_cache.popitem(last=False)
        return True

    def adopt_preview(self, colors, preview: Image.Image) -> None:
        """'Apply Selected': the preview becomes the dithered image and the
        palette/gamma are recorded for a later 'Apply to Video'."""
        self.dithered_image = preview
        self.last_palette = list(colors)
        self.last_gamma = self.use_gamma
        self.display_state = "dithered"

    # ---------------------------------------------------------------- save

    def result_image(self) -> Optional[Image.Image]:
        """Latest result with the final x-multiplier NEAREST resize."""
        img = self.dithered_image or self.active_source()
        if img is None:
            return None
        mult = max(1, int(self.final_resize_multiplier))
        if mult > 1:
            img = img.resize((img.size[0] * mult, img.size[1] * mult),
                             Image.Resampling.NEAREST)
        return img

    def save_result(self, path: str) -> bool:
        img = self.result_image()
        if img is None:
            return False
        img.save(path)
        return True

    def result_size_note(self) -> str:
        img = self.dithered_image or self.active_source()
        if img is None:
            return ""
        mult = max(1, int(self.final_resize_multiplier))
        w, h = img.size
        return f"result: {w * mult}x{h * mult}"

    # -------------------------------------------------------------- toggle

    def toggle_state(self) -> Optional[Tuple[str, Image.Image]]:
        states = [("current", self.current_image),
                  ("pixelized", self.pixelized_image),
                  ("dithered", self.dithered_image)]
        avail = [(name, img) for name, img in states if img is not None]
        if not avail:
            return None
        names = [name for name, _ in avail]
        try:
            nxt = (names.index(self.display_state) + 1) % len(names)
        except ValueError:
            nxt = 0
        name, img = avail[nxt]
        self.display_state = name
        return name, img

    # ------------------------------------------------------------ palettes

    def import_lospec(self, url: str) -> Optional[Dict[str, Any]]:
        pal = import_lospec_palette(url)
        if pal is None:
            return None
        PaletteManager().add_palette(pal["name"], pal["colors"])
        return pal

    def kmeans_palette_from_image(self, path: str
                                  ) -> List[Tuple[int, int, int]]:
        img = Image.open(path).convert("RGB")
        return ColorReducer.generate_kmeans_palette(img, int(self.num_colors),
                                                    device=self.device)

    def save_palette(self, name: str, colors_rgb) -> None:
        from dither_pie_tpu_torch.utils import rgb_to_hex

        PaletteManager().add_palette(
            name, [c if isinstance(c, str) else rgb_to_hex(c)
                   for c in colors_rgb])

    # --------------------------------------------------------------- video

    def video_apply_args(self, out_path: str):
        """(ditherer, pixelize_func, final_resize_multiplier) for the video
        run, from the recorded last palette/gamma; raises when the
        prerequisites (open video, applied palette) are missing. As in the
        JAX package, the video is pixelized "regular" whenever the preview
        was pixelized, also after a neural pixelize (ROADMAP C16)."""
        if not self.video_path:
            raise ValueError("No video open")
        if self.last_palette is None:
            raise ValueError("Apply dithering to the preview frame first "
                             "(the same palette is used for the video)")
        ditherer = self.build_ditherer(list(self.last_palette),
                                       len(self.last_palette))
        pixelize_func = None
        if self.pixelized_image is not None:
            pixelize_func = ("regular", int(self.pixelize_max_size))
        mult = max(1, int(self.final_resize_multiplier))
        return ditherer, pixelize_func, (mult if mult > 1 else None)

    def apply_to_video(self, out_path: str, progress_callback=None) -> bool:
        """Run the full video pipeline with the recorded settings
        (synchronous; the tk layer threads it)."""
        from dither_pie_tpu_torch.pipeline.video import VideoProcessor

        ditherer, pixelize_func, mult = self.video_apply_args(out_path)
        proc = VideoProcessor(progress_callback=progress_callback)
        return proc.process_video_streaming(
            self.video_path, out_path, ditherer,
            pixelize_func=pixelize_func, final_resize_multiplier=mult)

    # ------------------------------------------------------------ persist

    def persist_settings(self) -> None:
        self.config.set("defaults", "num_colors", int(self.num_colors))
        self.config.set("defaults", "dither_mode", self.mode)
        self.config.set("defaults", "pixelize_max_size",
                        int(self.pixelize_max_size))
        self.config.set("defaults", "final_resize_multiplier",
                        int(self.final_resize_multiplier))
        self.config.set("defaults", "use_gamma", bool(self.use_gamma))
        self.config.save()
