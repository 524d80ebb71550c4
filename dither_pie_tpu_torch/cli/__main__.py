"""`python -m dither_pie_tpu_torch.cli <config.json> [input_override]`."""

import sys

from dither_pie_tpu_torch.cli.main import main

sys.exit(main())
