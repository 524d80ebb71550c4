"""The Tk GUI over the port's ditherer: ``viewmodel.py`` (every decision,
headless, no tkinter), ``logic.py`` (its pure helpers, no tkinter),
``widgets.py`` and ``app.py`` (tkinter glue). ``python -m
dither_pie_tpu_torch`` with no arguments starts it."""
