"""The repo root's conftest.py, which gives each pytest-xdist worker its
share of the CPU threads: the rule as this process follows it, and the
rule's function on made-up environments. Under a second on the CPU."""

import os
from pathlib import Path

import pytest
import torch

RULE = Path(__file__).resolve().parents[1] / "conftest.py"


@pytest.fixture
def rule(request):
    """The root conftest as pytest loaded it (run pytest from the repo root)."""
    module = request.config.pluginmanager.get_plugin(str(RULE))
    assert module is not None, f"{RULE} was not loaded"
    return module


def test_this_process_runs_at_its_share(rule):
    """A worker's torch pool and the OMP_NUM_THREADS its subprocesses
    inherit are its share of the cores it may use; one process keeps
    torch's default."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        assert rule.SHARE is None
    elif rule.SHARE is None:  # the caller's OMP_NUM_THREADS stands
        assert "OMP_NUM_THREADS" in os.environ
    else:
        share = max(1, len(os.sched_getaffinity(0)) // int(workers))
        assert rule.SHARE == share
        assert torch.get_num_threads() == share
        assert os.environ["OMP_NUM_THREADS"] == str(share)


@pytest.mark.parametrize("environ, cores, share", [
    ({}, 8, None),
    ({"OMP_NUM_THREADS": "3"}, 8, None),
    ({"PYTEST_XDIST_WORKER_COUNT": "6", "OMP_NUM_THREADS": "3"}, 8, None),
    ({"PYTEST_XDIST_WORKER_COUNT": "6"}, 8, 1),
    ({"PYTEST_XDIST_WORKER_COUNT": "2"}, 8, 4),
    ({"PYTEST_XDIST_WORKER_COUNT": "6"}, 1, 1),
], ids=["no_xdist", "no_xdist_omp_set", "omp_set_stands", "6_workers_8_cores",
        "2_workers_8_cores", "6_workers_1_core"])
def test_thread_share(rule, environ, cores, share):
    assert rule.thread_share(environ, cores) == share
