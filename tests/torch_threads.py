"""A fixture for the port's end-to-end test modules, imported by each
(`from torch_threads import one_torch_thread`): pytest puts this
directory on `sys.path`, and a fixture imported into a test module is
that module's fixture."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work on one torch thread: beside the suite's other
    workers, torch's own pool oversubscribes the cores (its threads
    spin), which slowed the port's CPU runs up to ~90x in the suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
