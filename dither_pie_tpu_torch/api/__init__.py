"""Public API layer: the ImageDitherer facade, strategies and device policy."""
