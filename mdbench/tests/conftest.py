"""The benchmark's own tests: on the CPU at a tiny size, and, marked
``cuda``, on the card (they skip without one).

    python -m pytest mdbench/tests -q
"""

import os
import sys

import pytest

# each test worker runs torch on two threads: the tiny systems gain
# nothing from more, and workers that each take every core stall
os.environ.setdefault("OMP_NUM_THREADS", "2")

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda")
