"""Entry router: arguments -> the command line (``cli/main.py``); no
arguments -> the GUI, which the port does not have yet (ROADMAP A12b), so
it says so and exits 1."""

import sys


def main():
    if len(sys.argv) > 1:
        from dither_pie_tpu_torch.cli.main import main as cli_main

        sys.exit(cli_main())
    print("The GUI is not ported to dither_pie_tpu_torch yet (ROADMAP A12b); "
          "run the command line: python -m dither_pie_tpu_torch <config.json> [input]",
          file=sys.stderr)
    sys.exit(1)


if __name__ == "__main__":
    main()
