"""Compatibility alias for the original application's ``config_manager``
module."""

from dither_pie_tpu_torch.api.config_manager import ConfigManager  # noqa: F401
