"""Share the CPU's cores among the test workers.

Under pytest-xdist every worker process imports every test file while it
collects, so this module's setting reaches the whole run: each worker's
PyTorch gets its share of the cores (at least one thread) instead of a
thread for every core. PyTorch's OpenMP threads wait for work by spinning;
with a full team in each of several workers the spinning threads take the
cores from the ones that compute, and a case that takes seconds alone took
minutes. One process alone keeps PyTorch's default.
"""

import os

import torch


def worker_threads():
    """Threads for one worker's PyTorch, or None outside pytest-xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, len(os.sched_getaffinity(0)) // int(workers))


if worker_threads() is not None:
    torch.set_num_threads(worker_threads())


def test_workers_share_the_cores():
    want = worker_threads()
    if want is None:
        assert torch.get_num_threads() >= 1
    else:
        assert torch.get_num_threads() == want
