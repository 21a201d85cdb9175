"""One torch CPU thread inside each test of the port.

The port's CPU tests run the plain versions of the kernels on small tensors,
where torch's intra-op thread pool costs more than it gives, and the tier-1
run puts several pytest workers on one machine: with every worker's pool at
the machine's width, a D-NeRF trainer test measured 108 s in each of three
concurrent processes against 5 s with one thread.  A test module imports
`one_torch_thread`, an autouse fixture, to run its tests on one thread; the
previous setting is restored after each test."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
