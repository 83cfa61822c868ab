"""One intra-op thread for torch while a port test module runs.

The tier-1 run puts several pytest workers on the same cores, and torch's
CPU kernels, each spreading over every core, then wait on one another: a
train step of the port that takes 0.3 s alone took 20-40 s there. A test
module imports :func:`one_torch_thread` to run its torch ops on one thread
and give the count back afterwards.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
