"""Fixtures of qmbench's tests: the tiny benchmark (qmbench_tiny.py) and
the card's presence."""

import os
import time

import pytest
import torch

from qmbench import run
from qmbench_tiny import tiny_bench


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(bench, registry, cache directory) of the tiny benchmark."""
    root = str(tmp_path_factory.mktemp("qmbench_root"))
    bench = tiny_bench(root)
    return bench, run.Registry(root), os.path.join(root, "cache")


@pytest.fixture
def run_tiny(tiny):
    """run_tiny(cell, seed, traced, seconds, bench=None) -> (result,
    checks): one run of a tiny cell on the CPU's plain kernels."""
    def go(cell, seed=12345, traced=False, seconds=0.2, bench=None):
        return run.run_cell(bench or tiny[0], cell, seed, seconds, traced,
                            device="cpu", t_start=time.perf_counter(),
                            registry=tiny[1], cache_dir=tiny[2])
    return go


@pytest.fixture
def card():
    """Skip unless an NVIDIA card is present (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
