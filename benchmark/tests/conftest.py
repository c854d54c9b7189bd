"""Settings of the benchmark's own tests: the ``cuda`` marker for tests that
need the card (they skip here), decided inside a fixture, never at import."""

from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import small  # noqa: E402,F401  (puts benchmark/ and the root on the path)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (runs on the card only)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)
