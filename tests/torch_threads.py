"""The one thread-count decision of the port's CPU tests.

Each `tests/test_torch_*.py` that runs torch in its own process takes this
fixture with `from tests.torch_threads import one_torch_thread  # noqa: F401`.
The suite runs several test processes side by side on the cores, and
torch's parallel regions then wait for each other's threads at every small
operation: six processes on an 8-CPU machine, each running one bf16
PMF-ResNet34 eval forward at 1x64x128, took 24.9-25.7 s each with torch's
default 8 threads and 0.26-0.29 s each on one.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test runs torch on one thread; the count before it is restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
