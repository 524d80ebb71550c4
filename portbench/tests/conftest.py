"""Fixtures of the benchmark's tests: BENCHMARK.json, and the card."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cells  # noqa: E402


@pytest.fixture
def bench():
    return cells.load_benchmark()


@pytest.fixture
def card():
    """The CUDA device, for the tests that need the card; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this machine has none")
    return torch.device("cuda", 0)
