"""Run cells several times, one process after another, and print spreads.

    python3 portbench/sets.py --workload <cell> [--workload <cell> ...]
        --seeds 11,12,13 [--sets 2] [--seconds S] [--trace 0|1] [--out FILE]

Each run is ``portbench/run.py`` in a process of its own, with the given
seed; ``--sets 2`` runs the seed list twice, set after set, so that the two
sets hold the same seeds. Every run's result line, return code, the lines
before it and the end of its standard error go to ``--out`` (JSON lines).
At the end, for each cell, set and metric: the values, the median, and the
spread (quartile distance over the median, ``stats.spread``), and how many
runs came out correct.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import stats  # noqa: E402
from portbench.cells import load_benchmark  # noqa: E402


def one_run(workload: str, seed: int, seconds: float, trace: int, timeout: float) -> dict:
    cmd = [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    lines = out.strip().splitlines()
    result = None
    if rc == 0 and lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    return {"workload": workload, "seed": seed, "trace": trace, "seconds": seconds, "rc": rc,
            "wall_s": time.perf_counter() - t, "result": result, "lines": lines[:-1][-12:],
            "stderr_tail": err[-3000:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=400.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    seconds = args.seconds or load_benchmark()["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    out = open(args.out, "a") if args.out else None
    try:
        for wl in args.workload:
            for k in range(args.sets):
                for seed in seeds:
                    r = one_run(wl, seed, seconds, args.trace, args.timeout)
                    r["set"] = k
                    runs.append(r)
                    res = r["result"] or {}
                    vals = {m: round(v["value"], 4) for m, v in res.get("metrics", {}).items()}
                    print(f"{wl} set={k} seed={seed} rc={r['rc']} correct={res.get('correct')} "
                          f"wall={r['wall_s']:.1f}s {vals}", flush=True)
                    if r["rc"] != 0 or not res.get("correct"):
                        print("  " + "\n  ".join(r["lines"][-6:]), flush=True)
                        print("  stderr: " + r["stderr_tail"][-1500:], flush=True)
                    if out:
                        out.write(json.dumps(r) + "\n")
                        out.flush()
    finally:
        if out:
            out.close()
    for wl in args.workload:
        for k in range(args.sets):
            rs = [r for r in runs if r["workload"] == wl and r["set"] == k and r["result"]]
            names = sorted({m for r in rs for m in r["result"]["metrics"]})
            print(f"== {wl} set {k}: {len(rs)} results, "
                  f"{sum(bool(r['result']['correct']) for r in rs)} correct")
            for m in names:
                v = [r["result"]["metrics"][m]["value"] for r in rs
                     if m in r["result"]["metrics"]]
                sp = stats.spread(v) if len(v) >= 2 else float("nan")
                print(f"   {m}: median {statistics.median(v):.6g} spread {sp:.5f} values "
                      f"{[round(x, 5) for x in v]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
