"""A fixture for the port's heaviest CPU tests (the smoke's rehearsals):
they run torch at the flagship's widths beside the other xdist workers.
With torch's default of one intra-op thread a core, six workers on eight
cores wait on each other's threads and each such test runs several times
slower than alone (the rehearsals measured 3-4x); on two threads each they
run near their own speed. The checks are the same on any thread count."""

import pytest
import torch

THREADS = 2


@pytest.fixture
def few_threads(monkeypatch):
    """The test on THREADS intra-op threads, and its child processes too
    (OMP_NUM_THREADS); torch's setting is restored after it."""
    was = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    monkeypatch.setenv("OMP_NUM_THREADS", str(THREADS))
    yield
    torch.set_num_threads(was)
