"""Entry router: arguments -> the command line (``cli/main.py``); no
arguments -> the GUI (``gui/app.py``) on the card, as the JAX package's
router does."""

import sys


def main():
    if len(sys.argv) > 1:
        from dither_pie_tpu_torch.cli.main import main as cli_main

        sys.exit(cli_main())
    try:
        from dither_pie_tpu_torch.gui.app import launch_gui
    except ModuleNotFoundError as e:
        if e.name not in ("tkinter", "_tkinter"):
            raise
        sys.exit(f"Cannot start GUI ({e}): this Python has no Tk. Use the command line: "
                 "python -m dither_pie_tpu_torch <config.json> [input] [--device cpu]")
    launch_gui()


if __name__ == "__main__":
    main()
