"""Shared test fixtures.

NOTE: XLA_FLAGS / device-count overrides are deliberately NOT set here —
smoke tests and benchmarks must see the real single CPU device.  Tests that
need a multi-device mesh spawn a subprocess (see test_distributed.py).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none"
    )


@pytest.fixture
def rng():
    return np.random.RandomState(0)
