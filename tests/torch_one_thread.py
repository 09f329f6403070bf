"""A module-scoped autouse fixture for the port's engine-level CPU tests:
torch's intra-op threads are set to one while the importing test module
runs, and restored after it.  The reduced models' products are too small
to gain from threads, and the suite runs six pytest workers on one host,
so one thread each leaves the cores to the other workers.

    from torch_one_thread import one_torch_thread  # noqa: F401  (autouse fixture)
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
