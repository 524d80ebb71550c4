"""The port's tests' intra-op thread rule (``tests/torch_workers.py``): each
xdist worker takes its share of the cores it can see, one thread at least,
and a run without xdist keeps torch's default. The rule is held as a pure
function, through ``share_cores`` with a stand-in environment and setter,
and through its import-time call in a fresh interpreter, so this file never
changes its own worker's threads."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_workers


@pytest.mark.parametrize("cores, workers, want", [
    (8, 6, 1),    # -n 6 on 8 cores
    (4, 8, 1),    # more workers than cores
    (32, 4, 8),
    (8, 1, 8),
    (7, 2, 3),
])
def test_worker_threads(cores, workers, want):
    assert torch_workers.worker_threads(cores, workers) == want


@pytest.mark.parametrize("workers", ["1", "6", "64"])
def test_an_xdist_worker_takes_its_share(workers):
    calls, environ = [], {"PYTEST_XDIST_WORKER_COUNT": workers}
    got = torch_workers.share_cores(environ, calls.append)
    want = max(1, len(os.sched_getaffinity(0)) // int(workers))
    assert got == want and calls == [want]
    assert environ == {"PYTEST_XDIST_WORKER_COUNT": workers, "OMP_NUM_THREADS": str(want)}


@pytest.mark.parametrize("environ", [{}, {"PYTEST_XDIST_WORKER_COUNT": ""}, {"OMP_NUM_THREADS": "3"}],
                         ids=["unset", "empty", "omp-only"])
def test_without_xdist_nothing_changes(environ):
    before, threads = dict(environ), torch.get_num_threads()
    assert torch_workers.share_cores(environ) is None
    assert environ == before and torch.get_num_threads() == threads


PROBE = ("import json, os, torch; before = torch.get_num_threads(); import torch_workers; "
         "print(json.dumps([before, torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')]))")


@pytest.mark.parametrize("workers", [None, "2", "64"], ids=lambda v: f"workers{v}")
def test_the_import_applies_the_rule(workers):
    """The import-time call, in a fresh interpreter: under xdist torch and
    the subprocesses' OpenMP run the worker's share; alone, neither changes."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTEST_XDIST_WORKER_COUNT", "OMP_NUM_THREADS")}
    if workers is not None:
        env["PYTEST_XDIST_WORKER_COUNT"] = workers
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=Path(__file__).parent, env=env,
                         capture_output=True, text=True, check=True).stdout
    before, after, omp = json.loads(out.splitlines()[-1])
    if workers is None:
        assert (after, omp) == (before, None)
    else:
        want = max(1, len(os.sched_getaffinity(0)) // int(workers))
        assert (after, omp) == (want, str(want))
