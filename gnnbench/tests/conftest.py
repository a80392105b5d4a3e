"""Tests of the benchmark.  Run from the repository root:

    python -m pytest gnnbench/tests -q

Tests marked ``card`` need a CUDA device and skip without one; they decide
inside a fixture, never while the module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
