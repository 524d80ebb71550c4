"""Persisted application preferences (GUI window state, defaults, recents).

A copy of ``dither_pie_tpu/api/config_manager.py`` (json only; the port
imports nothing of the JAX package), the original application's
``config_manager`` surface: nested-key get/set over a JSON file with
recursive default-merging, geometry helpers, last-used directories, and a
bounded recent-files list.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List


DEFAULT_CONFIG: Dict[str, Any] = {
    "window": {
        "geometry": "1200x800",
        "state": "normal",
    },
    "theme": {
        "appearance_mode": "dark",
        "color_theme": "blue",
    },
    "defaults": {
        "num_colors": 16,
        "dither_mode": "bayer",
        "pixelize_max_size": 128,
        "final_resize_multiplier": 2,
        "use_gamma": False,
    },
    "paths": {
        "last_image_dir": "",
        "last_video_dir": "",
        "last_palette_dir": "",
    },
    "ui": {
        "show_tooltips": True,
        "spinner": "dots",
    },
    "pixelization_editor": {
        "geometry": "",
        "grid_color": "#808080",
        "brush_size": 1,
        "dialog_width": 760,
        "dialog_height": 560,
        "dialog_x": None,
        "dialog_y": None,
    },
    "recent_files": [],
}


def _merge(default: Dict, loaded: Dict) -> Dict:
    """Recursively merge loaded values over defaults."""
    out = copy.deepcopy(default)
    for k, v in loaded.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


class ConfigManager:
    """JSON-backed preference store with varargs nested-key access."""

    def __init__(self, config_file: str = "config.json"):
        self.config_file = config_file
        self.config = copy.deepcopy(DEFAULT_CONFIG)
        self.load()

    def load(self):
        if os.path.exists(self.config_file):
            try:
                with open(self.config_file, "r", encoding="utf-8") as f:
                    loaded = json.load(f)
                if isinstance(loaded, dict):
                    self.config = _merge(DEFAULT_CONFIG, loaded)
            except Exception as e:
                print(f"Error loading config: {e}")

    def save(self):
        try:
            with open(self.config_file, "w", encoding="utf-8") as f:
                json.dump(self.config, f, indent=4)
        except Exception as e:
            print(f"Error saving config: {e}")

    def get(self, *keys, default: Any = None) -> Any:
        node = self.config
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                return default
            node = node[k]
        return node

    _MISSING = object()

    def set(self, *keys_and_value, value: Any = _MISSING):
        """Set a nested key. Accepts both the original application's keyword
        form ``set("a", "b", value=v)`` and the positional
        ``set("a", "b", v)``."""
        if value is not ConfigManager._MISSING:
            keys = list(keys_and_value)
        else:
            *keys, value = keys_and_value
        node = self.config
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    # -- convenience helpers of the original application's surface --

    def get_window_geometry(self) -> str:
        return self.get("window", "geometry", default="1200x800")

    def set_window_geometry(self, geometry: str):
        self.set("window", "geometry", geometry)

    def get_last_dir(self, kind: str) -> str:
        return self.get("paths", f"last_{kind}_dir", default="")

    def set_last_dir(self, kind: str, path: str):
        self.set("paths", f"last_{kind}_dir", path)

    def add_recent_file(self, path: str, max_entries: int = 10):
        recents: List[str] = [p for p in self.get("recent_files", default=[])
                              if p != path and os.path.exists(p)]
        recents.insert(0, path)
        self.set("recent_files", recents[:max_entries])

    def get_recent_files(self) -> List[str]:
        return [p for p in self.get("recent_files", default=[]) if os.path.exists(p)]
