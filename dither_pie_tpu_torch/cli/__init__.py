"""The command line: ``python -m dither_pie_tpu_torch.cli <config.json>
[input_override]`` (``main.py``)."""
