"""The benchmark's CPU tests: the repository's root on the path, one torch
thread (the runners' rehearsals share a small host), and a fixture that
skips a test that needs a card where there is none."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell runs only there")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
