"""The port's test files' shared thread policy.

A test file takes it with ``from torch_threads import _one_thread  # noqa: F401``;
pytest runs a fixture imported into a test module as if defined there.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test run shares the machine's cores among
    several workers, and torch's thread pools oversubscribed that way spin
    on these smoke-sized tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
