"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the checkout's root (CPU; the ``cuda`` ones skip without a card and run on
one with the same command)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark measures the card only")
    return torch.device("cuda")
