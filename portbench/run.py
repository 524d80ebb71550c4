"""Run one cell of BENCHMARK.json once on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints the run's set-up by piece, the card's
readings and the scan's bounds on earlier lines, then one JSON object as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: every number compared beside its limit, which also close
standard error. Exits with another code than 0 and prints no result where
no CUDA device is visible, where the cell asks for more cards than there
are, and where a module of JAX or of the JAX package was loaded.

Every ``DITHER_PIE_TPU_*`` variable is removed from the environment first,
so the program runs as its users run it by default; then the cell's
configuration sets its own ``env`` map, before torch or the program is
imported.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def process_age_s() -> float:
    """Seconds since this process started, from /proc (0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def main(argv=None) -> int:
    t_start = _T0 - process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import cells

    try:
        cell = cells.find_cell(cells.load_benchmark(), args.workload)
        env = cells.environment(cell.config)
    except cells.RunError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    for key in [k for k in os.environ if k.startswith("DITHER_PIE_TPU_")]:
        del os.environ[key]
    os.environ.update(env)

    t = time.perf_counter()
    import torch

    from portbench import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"cuda available={torch.cuda.is_available()}, "
              f"devices={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import dither_pie_tpu_torch.pipeline.image  # noqa: F401
    import dither_pie_tpu_torch.pipeline.video  # noqa: F401
    import_s = time.perf_counter() - t
    bench = cells.load_benchmark()

    try:
        result, lines = harness.run(bench, cell, args.seed % (1 << 63), args.seconds,
                                    bool(args.trace), torch.device("cuda", 0), t_start,
                                    import_s)
    except harness.RunError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 1
    bad = harness.forbidden_loaded()
    if bad:
        print(f"no result: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 1
    for line in lines:
        print(line)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
