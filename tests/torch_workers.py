"""One intra-op thread rule for the port's tests under pytest-xdist.

Each xdist worker starts torch with an intra-op thread a core, so ``n``
workers on ``c`` cores run ``n * c`` OpenMP threads that spin against one
another on every small CPU op. Every ``test_torch_*.py`` imports this module,
which gives each worker its share of the cores it can see: torch's intra-op
count and ``OMP_NUM_THREADS`` (for the ``python -m dither_pie_tpu_torch``
subprocesses the CLI and tool tests start) become
``max(1, cores // PYTEST_XDIST_WORKER_COUNT)``. Without xdist nothing
changes: a single-process run keeps torch's default.
"""

import os

import torch


def worker_threads(cores: int, workers: int) -> int:
    """Each of ``workers`` processes' share of ``cores``, one at least."""
    return max(1, cores // workers)


def share_cores(environ=os.environ, set_threads=torch.set_num_threads):
    """Apply the rule to this process; return the count set, or None
    outside an xdist worker."""
    workers = environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    threads = worker_threads(len(os.sched_getaffinity(0)), int(workers))
    set_threads(threads)
    environ["OMP_NUM_THREADS"] = str(threads)
    return threads


share_cores()
