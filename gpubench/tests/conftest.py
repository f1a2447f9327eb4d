"""Tests of the benchmark harness. Those that need a CUDA card carry the
`card` marker and take the `card` fixture, which skips without one:

    python -m pytest gpubench/tests -q -p no:cacheprovider     # the CPU
    python -m pytest gpubench/tests -q -m card                 # on a card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
