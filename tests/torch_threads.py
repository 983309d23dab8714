"""One torch thread per test process for the port's CPU tests.

The suite runs in several worker processes at once, and torch would give
each of them one intra-op thread a core: a worker's small tensor ops then
wait on threads that the other workers keep busy, and the port's tests ran
many times slower in the suite than alone.  Each `tests/test_torch_*.py`
imports `one_torch_thread`, an autouse fixture of module scope: the
module's tests run with one intra-op thread, and the processes they start
(servers, trainers) inherit OMP_NUM_THREADS=1 unless they set their own.
Both are put back after the module, so the other tests a worker runs keep
torch's defaults.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env
