"""One intra-op thread a test: the suite runs in several processes at
once, and the CPU sizes here gain nothing from more."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
