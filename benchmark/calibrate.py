"""Readings from which a cell's limits for `correct` are set (not run by the
benchmark): for each seed, the sound program against the plain reference;
on the control seeds, the reference itself in float8 in the program's
place; on the fault seeds, the program with each planted fault (faults.py).
Train cells read their checked steps and, after `--window-steps` steps in
place of the window, the late step; serve cells `checked_requests`
requests. One JSON line a reading.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control 1,2,3] [--faults 1,2,3]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import faults, harness  # noqa: E402
from benchmark.drivers import common  # noqa: E402
from benchmark.reference.plain import Fp8  # noqa: E402


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def train_readings(cell, control: bool, fault_seed: bool, window_steps: int):
    """The checked steps' numbers, then the late step's (`late_`), taken
    after `window_steps` steps stand in for the window, as run.py takes it."""
    import torch

    from benchmark.drivers import train

    setup = train.Setup(cell)
    n = cell.traffic["checked_steps"]

    def program():
        prog = train.Program(setup)
        readings = train.checked_steps(setup, prog, n)
        return prog, readings

    prog, sound = program()
    gen = torch.Generator(device=cell.device).manual_seed(cell.seed + 3)
    for i in range(window_steps):
        prog.step(setup.pool[(n + i) % len(setup.pool)], gen)
    index = n + window_steps
    snap = train.snapshot(prog)
    late_sound = train.late_step(setup, prog, snap, index)
    late_faults = {}
    if fault_seed:
        for name, fault in faults.TRAIN.items():
            with fault():
                prog.rebuild()
                late_faults[name] = train.late_step(setup, prog, snap, index)
    del prog
    common.free(cell.device)
    ref = train.reference_readings(setup)
    late_ref = train.late_reference_readings(setup, snap, index)

    def both(early, late_readings):
        return train.compare(early, ref) | train.late(train.compare(late_readings, late_ref))

    yield "program", both(sound, late_sound)
    if control:
        yield "control", both(train.reference_readings(setup, Fp8()),
                              train.late_reference_readings(setup, snap, index, Fp8()))
    if fault_seed:
        for name, fault in faults.TRAIN.items():
            with fault():
                prog, early = program()
                del prog
                common.free(cell.device)
            yield name, both(early, late_faults[name])


def serve_readings(cell, control: bool, fault_seed: bool):
    from benchmark.drivers import serve

    setup = serve.Setup(cell)
    k = range(cell.traffic["checked_requests"])

    def program():
        inf = serve.inferencer(setup)
        outs = [serve.serve_one(inf, setup.key, *setup.request(i)) for i in k]
        del inf
        common.free(cell.device)
        return outs

    sound = program()
    ref = serve.reference_outputs(setup, list(k))
    yield "program", serve.compare(sound, ref, setup.depth_tol)
    if control:
        yield "control", serve.compare(serve.reference_outputs(setup, list(k), Fp8()), ref,
                                       setup.depth_tol)
    if fault_seed:
        for name, fault in faults.SERVE.items():
            with fault():
                yield name, serve.compare(program(), ref, setup.depth_tol)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control", type=seeds, default=[])
    p.add_argument("--faults", type=seeds, default=[])
    p.add_argument("--window-steps", type=int, default=40,
                   help="train: steps taken between the checked steps and the late step")
    args = p.parse_args(argv)
    for seed in sorted(set(args.seeds) | set(args.control) | set(args.faults),
                       key=lambda s: (s not in args.control, s)):
        cell = harness.load_cell(args.workload, seed, 0.0, False)
        t0 = time.perf_counter()
        if cell.traffic["driver"] == "train":
            read = train_readings(cell, seed in args.control, seed in args.faults,
                                  args.window_steps)
        else:
            read = serve_readings(cell, seed in args.control, seed in args.faults)
        for kind, numbers in read:
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              **numbers, "s": round(time.perf_counter() - t0, 2)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
