"""PyTorch's intra-op thread pool under pytest-xdist.

Every xdist worker imports every test module while it collects, so this
module's import runs in each worker before any test does. PyTorch's
default pool is one thread a core in EVERY worker: with six workers on
eight cores that is 48 spinning threads for 8 cores, and the port's
tests ran 2.2x slower for it (eight of the slowest port test files with
``-n 6`` on an 8-core host: 365 s at the default, 162 s at one thread a
worker). Each worker takes its share of the cores instead. Without
xdist (one process) nothing changes. The JAX package's thread pools are
not touched.
"""

import os

import torch


def worker_share():
    """Threads a worker gets: the cores over the workers, at least one;
    None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


if worker_share() is not None:
    torch.set_num_threads(worker_share())


def test_worker_takes_its_share_of_the_cores():
    share = worker_share()
    if share is not None:
        assert torch.get_num_threads() == share
    else:
        assert torch.get_num_threads() >= 1
