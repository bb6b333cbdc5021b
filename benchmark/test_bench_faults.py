"""`correct` out of a whole run with the program broken underneath: the run
skips the harness's look for a card and drives the rest on the CPU at a
small size, with the cell's committed limits. Each fault the cell can have
(faults.py) makes it not correct, and so does the control (the plain
reference in float8 in the program's place, in the checked steps and in
the late step from the program's state), by a number that a sound run
of the same size reads at or under its limit. (The limits are set from the
card at the cells' own sizes; a sound run here, where the program's SIREN
is the fp32 plain path and the sizes are small, need not meet every one.)"""

import pytest
import torch

from benchmark import faults, harness
from benchmark.reference.plain import Fp8
from benchmark.run import run_cell


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


TRAIN_CELLS = ["thesis_train_s2", "dg_train_s2"]
SERVE_CELLS = ["thesis_serve"]


_SOUND: dict = {}


def sound_checks(tiny_cell, workload) -> dict:
    if workload not in _SOUND:
        _SOUND[workload] = run_cell(tiny_cell(workload), 0.0)[1]
    return _SOUND[workload]


def failed_by_the_fault(checks, sound) -> list:
    """The numbers over their limit here that a sound run reads under it."""
    return [k for k, c in checks.items()
            if c["value"] > c["limit"] >= sound[k]["value"]]


@pytest.mark.parametrize("workload,fault", [(w, f) for w in TRAIN_CELLS for f in faults.TRAIN]
                         + [(w, f) for w in SERVE_CELLS for f in faults.SERVE])
def test_a_fault_is_not_correct(tiny_cell, workload, fault):
    table = faults.TRAIN if workload in TRAIN_CELLS else faults.SERVE
    sound = sound_checks(tiny_cell, workload)
    with table[fault]():
        result, checks = run_cell(tiny_cell(workload), 0.0)
    assert not result["correct"], checks
    assert failed_by_the_fault(checks, sound), (checks, sound)


@pytest.mark.parametrize("workload", TRAIN_CELLS + SERVE_CELLS)
def test_the_control_is_not_correct(tiny_cell, workload):
    cell = tiny_cell(workload)
    if workload in TRAIN_CELLS:
        from benchmark.drivers import train

        setup = train.Setup(cell)
        n = cell.traffic["checked_steps"]
        prog = train.Program(setup)
        train.checked_steps(setup, prog, n)
        snap = train.snapshot(prog)
        del prog
        readings = (train.compare(train.reference_readings(setup, Fp8()),
                                  train.reference_readings(setup))
                    | train.late(train.compare(
                        train.late_reference_readings(setup, snap, n, Fp8()),
                        train.late_reference_readings(setup, snap, n))))
    else:
        from benchmark.drivers import serve

        setup = serve.Setup(cell)
        k = list(range(cell.traffic["checked_requests"]))
        readings = serve.compare(serve.reference_outputs(setup, k, Fp8()),
                                 serve.reference_outputs(setup, k), setup.depth_tol)
    correct, checks = harness.judge(readings, cell.limits)
    assert not correct, checks
    assert failed_by_the_fault(checks, sound_checks(tiny_cell, workload)), checks
