"""One PyTorch intra-op thread for the port's CPU tests.

The suite runs in several worker processes at once (pytest-xdist).  A CPU
op in PyTorch splits its work over a team of threads as wide as the
machine, so six workers start six such teams on one set of cores, and the
teams' threads spin waiting for one another.  The launch-plan walks, which
are thousands of small ops, ran 30 times slower that way than alone (on an
8-core host, three copies of each of their two files at once: about 830 s,
against 25 s with one thread a process).  With one thread a process, the
workers are the parallelism.

A test module takes it with ``from torch_threads import one_torch_thread``
(an autouse fixture; the import is what brings it into the module).
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
