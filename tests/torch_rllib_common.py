"""A fixture shared by the ``tests/test_torch_rllib_*.py`` files."""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module's learners, and for the workers
    of the clusters it starts (they inherit ``OMP_NUM_THREADS``).  The RL
    networks are MLPs of 32–64 units: torch's default of one thread a
    core spin-waits against the suite's other workers on a shared CPU,
    which made one CQL update ~80x slower under load (727 ms against
    8.7 ms with one thread, seven busy processes beside it)."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env
