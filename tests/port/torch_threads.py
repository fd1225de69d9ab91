"""A module fixture for the port's test files: torch on one CPU thread.

The test suite runs in several xdist worker processes beside the JAX
compiler. torch's default thread pool (one thread per core in every
worker) then oversubscribes the cores, and the port's small CPU tensors
wait on it: an encode that takes 4 s alone took 220 s so. One thread per
worker gives the same results (torch's CPU kernels do not depend on the
thread count here; the suite passes either way) in far less time.
A test module takes it with
`from tests.port.torch_threads import one_torch_thread  # noqa: F401`."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
