"""One torch thread for the port's CPU tests.

Each tests/test_torch_*.py file imports the fixture below
(``from torch_threads import one_torch_thread  # noqa: F401``), which
pytest then runs around every test module of the file. When the suite
runs on six pytest-xdist workers, they share the box's cores, one of
them running tests/test_parallel.py, the longest file; torch's default
intra-op pool (a thread a core) in every worker oversubscribes them, and
its threads' waits burn the cores that file needs (a 256x256 frame of
the plain versions took 11 s on a loaded 8-core box, 0.8 s on one
thread). The tests compute the same values on one thread.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
