"""Tests of the benchmark (``python -m pytest benchmark/tests``).  They run
on the CPU at small sizes; a test marked ``gpu`` needs a CUDA device and
decides so inside the test (``need_gpu``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device")


@pytest.fixture
def need_gpu():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")


# a cell's traffic cut to what a test on the CPU can run: 2 stations, 4
# ring blocks, 2 streams
SMALL = {"stations": 2, "ring_blocks": 4, "streams": 2}
