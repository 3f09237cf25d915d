"""The harness runs on one CPU thread, as ``bench/run.py`` sets it on the
card's host; so do its tests, which run beside other test processes."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
