"""Fixtures shared by the port's CPU tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tier-1 runs six test processes on a few cores: PyTorch's own thread
    pool would oversubscribe them, so the port runs single-threaded here.
    Import this fixture into a test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
