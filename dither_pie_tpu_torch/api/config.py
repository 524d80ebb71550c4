"""JSON config schema, validation, and normalization.

The port of ``dither_pie_tpu/api/config.py``'s validation (the CLI's parser
is not ported). The config format is the public batch-processing API of
the original application: required input/output, optional mode
(auto-detected), pixelization / dithering / palette / final_resize sections
with deep defaulting, palette sources accepting builtin generators,
``file:<image>``, ``custom:<name>``, or a bare palette.json name, and paths
resolved relative to the config file.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict

from dither_pie_tpu_torch.api.ditherer import DitherMode, PaletteSource, PixelizeMethod
from dither_pie_tpu_torch.utils import IMAGE_EXTENSIONS, VIDEO_EXTENSIONS, PaletteManager

logger = logging.getLogger(__name__)

VALID_MODES = ["image", "video", "folder"]

# Schema surface used for unknown-section/key warnings: one aggregated
# warning line for a misspelled section or key (non-fatal, so forward-compat
# configs keep loading).
KNOWN_TOP_LEVEL_KEYS = {
    "input", "output", "mode",
    "pixelization", "dithering", "palette", "final_resize",
}
KNOWN_SECTION_KEYS = {
    "pixelization": {"enabled", "method", "max_size"},
    "dithering": {"enabled", "mode", "parameters"},
    "palette": {"source", "num_colors", "use_gamma"},
    "final_resize": {"enabled", "multiplier"},
}


def _warn_unknown_keys(config: Dict[str, Any]) -> None:
    """Emit ONE aggregated warning for unrecognized sections/keys (non-fatal).

    Keys starting with ``_`` are comment/annotation keys by convention
    (every shipped example uses ``"_comment"``) and are exempt — warning on
    them would train users to ignore the typo warning this exists for.
    """
    unknown = [f"'{k}'" for k in config
               if k not in KNOWN_TOP_LEVEL_KEYS and not k.startswith("_")]
    for section, known in KNOWN_SECTION_KEYS.items():
        sec = config.get(section)
        if isinstance(sec, dict):
            unknown.extend(f"'{section}.{k}'" for k in sec
                           if k not in known and not k.startswith("_"))
    if unknown:
        logger.warning(
            "Ignoring unknown config %s: %s (known sections: pixelization, "
            "dithering, palette, final_resize — check for typos)",
            "entry" if len(unknown) == 1 else "entries", ", ".join(sorted(unknown)))


VALID_PIXELIZATION_METHODS = [m.value for m in PixelizeMethod]
VALID_PALETTE_SOURCES = [s.value for s in PaletteSource]
VALID_DITHER_MODES = [m.value for m in DitherMode]


class ConfigValidationError(Exception):
    """Raised when config validation fails."""


def validate_config(config: Dict[str, Any], config_path: Path,
                    skip_input_check: bool = False) -> Dict[str, Any]:
    """Validate + normalize a raw config dict (aggregated error reporting)."""
    errors = []
    _warn_unknown_keys(config)

    if "input" not in config:
        errors.append("Missing required field: 'input'")
    if "output" not in config:
        errors.append("Missing required field: 'output'")

    mode = config.get("mode")
    if mode and mode not in VALID_MODES:
        errors.append(f"Invalid mode: '{mode}'. Must be one of: {VALID_MODES}")

    if "pixelization" in config:
        pix = config["pixelization"]
        if not isinstance(pix, dict):
            errors.append("'pixelization' must be an object/dictionary")
        else:
            if "method" in pix and pix["method"] not in VALID_PIXELIZATION_METHODS:
                errors.append(
                    f"Invalid pixelization method: '{pix['method']}'. "
                    f"Must be one of: {VALID_PIXELIZATION_METHODS}")
            if "max_size" in pix:
                try:
                    if int(pix["max_size"]) <= 0:
                        errors.append("'pixelization.max_size' must be positive")
                except (ValueError, TypeError):
                    errors.append("'pixelization.max_size' must be an integer")

    if "dithering" in config:
        dith = config["dithering"]
        if not isinstance(dith, dict):
            errors.append("'dithering' must be an object/dictionary")
        elif "mode" in dith and dith["mode"] not in VALID_DITHER_MODES:
            errors.append(f"Invalid dither mode: '{dith['mode']}'. "
                          f"Must be one of: {VALID_DITHER_MODES}")

    if "palette" in config:
        pal = config["palette"]
        if not isinstance(pal, dict):
            errors.append("'palette' must be an object/dictionary")
        else:
            if "source" in pal:
                source = pal["source"]
                is_valid = (source in VALID_PALETTE_SOURCES
                            or source.startswith("file:")
                            or source.startswith("custom:"))
                if not is_valid:
                    is_valid = source in PaletteManager().list_palette_names()
                if not is_valid:
                    errors.append(f"Invalid palette source: '{source}'")
            if "num_colors" in pal:
                try:
                    if int(pal["num_colors"]) <= 0:
                        errors.append("'palette.num_colors' must be positive")
                except (ValueError, TypeError):
                    errors.append("'palette.num_colors' must be an integer")

    if "final_resize" in config:
        resize = config["final_resize"]
        if not isinstance(resize, dict):
            errors.append("'final_resize' must be an object/dictionary")
        elif "multiplier" in resize:
            try:
                if int(resize["multiplier"]) <= 0:
                    errors.append("'final_resize.multiplier' must be positive")
            except (ValueError, TypeError):
                errors.append("'final_resize.multiplier' must be an integer")

    if errors:
        raise ConfigValidationError(
            "Configuration validation failed:\n" + "\n".join(f"  • {e}" for e in errors))

    # Resolve paths relative to the config file.
    config_dir = config_path.parent
    for key in ("input", "output"):
        p = Path(config[key])
        if not p.is_absolute():
            p = (config_dir / p).resolve()
        config[key] = str(p)

    if not skip_input_check and not Path(config["input"]).exists():
        raise ConfigValidationError(f"Input file/directory not found: {config['input']}")

    # Deep defaults.
    config.setdefault("mode", None)
    config.setdefault("pixelization", {"enabled": False})
    config.setdefault("dithering", {"enabled": True, "mode": DitherMode.BAYER.value,
                                    "parameters": {}})
    config.setdefault("palette", {"source": PaletteSource.MEDIAN_CUT.value,
                                  "num_colors": 16, "use_gamma": False})
    config.setdefault("final_resize", {"enabled": False, "multiplier": 2})

    config["pixelization"].setdefault("enabled", False)
    config["pixelization"].setdefault("method", PixelizeMethod.REGULAR.value)
    config["pixelization"].setdefault("max_size", 128)

    config["dithering"].setdefault("enabled", True)
    config["dithering"].setdefault("mode", "bayer")
    config["dithering"].setdefault("parameters", {})

    config["palette"].setdefault("source", PaletteSource.MEDIAN_CUT.value)
    config["palette"].setdefault("num_colors", 16)
    config["palette"].setdefault("use_gamma", False)

    config["final_resize"].setdefault("enabled", False)
    config["final_resize"].setdefault("multiplier", 2)

    return config


def load_config(config_path: Path, skip_input_check: bool = False) -> Dict[str, Any]:
    try:
        with open(config_path, "r", encoding="utf-8") as f:
            config = json.load(f)
    except json.JSONDecodeError as e:
        raise ConfigValidationError(
            f"Invalid JSON in config file:\n  Line {e.lineno}: {e.msg}")
    except Exception as e:
        raise ConfigValidationError(f"Failed to load config file: {e}")
    return validate_config(config, config_path, skip_input_check=skip_input_check)


def detect_mode(input_path: Path) -> str:
    """'image', 'video', or 'folder' by path type / extension."""
    if input_path.is_dir():
        return "folder"
    ext = input_path.suffix.lower()
    if ext in VIDEO_EXTENSIONS:
        return "video"
    if ext in IMAGE_EXTENSIONS:
        return "image"
    raise ConfigValidationError(f"Cannot determine mode for file extension: {ext}")
