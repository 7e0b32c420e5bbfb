"""One intra-op torch thread for the test modules of the port that run
torch on the CPU.

The suite runs its modules in several worker processes at once.  A module
whose tests run a window's CSR scatter, a fleet's kernels or a model's
step on the CPU would start an OpenMP thread a core in its worker, and
those threads, spinning against every other worker's, slow each worker
many times over.  A module takes the fixture by importing it:

    from torch_threads import one_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the importing module's tests; the count
    the process had comes back after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
