"""Each pytest-xdist worker's share of the CPU threads.

The Tier-1 run puts several test processes on the machine's cores at once
(`-n 6` on 8 cores). torch sizes its intra-op pool to every core a process
may use, so six workers would run 48 pool threads, which spin against each
other on small ops. In an xdist worker this file divides the cores the
process may use among the workers. A run in one process keeps torch's
default, and an OMP_NUM_THREADS set by the caller stands. A test whose
numbers depend on the thread count pins the count itself around the
computation.

pytest loads this file before `tests/conftest.py`, and xdist sets
PYTEST_XDIST_WORKER_COUNT before a worker loads any conftest.
"""

import os
import sys


def thread_share(environ, cores):
    """The threads one xdist worker gets: `cores` divided among the workers,
    at least one. None outside xdist, or where OMP_NUM_THREADS is set."""
    workers = environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None or "OMP_NUM_THREADS" in environ:
        return None
    return max(1, cores // int(workers))


SHARE = thread_share(os.environ, len(os.sched_getaffinity(0)))
if SHARE is not None:
    # before anything imports torch; the processes the tests start inherit it
    os.environ["OMP_NUM_THREADS"] = str(SHARE)


def pytest_configure(config):
    torch = sys.modules.get("torch")  # a plugin may have imported it first
    if SHARE is not None and torch is not None:
        torch.set_num_threads(SHARE)
