"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads`; its configuration, traffic, limits, reference and per-layer
readers are files under benchmark/ found by name (harness.py). With
`--trace 0` the result's metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer ones. The last line on stdout is one JSON object
(correct, attempted, failed, metrics, device, with --trace 1 breakdown, and
last the checks: each number compared for `correct` beside its limit); the
checks are also the last lines on stderr. Without a CUDA card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits non-zero.

The program's kernels build into its package's `_build/` directory inside
the checkout, so only a checkout's first run compiles.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell: harness.Cell, t0: float) -> tuple[dict, dict]:
    """Run the cell once -> (result without its checks, checks)."""
    import torch

    out = harness.driver(cell).run(cell, t0)
    correct, checks = harness.judge(out["readings"], cell.limits)
    on_card = torch.device(cell.device).type == "cuda"
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell.workload["chips"] if on_card else 0,
              "memory_peak_bytes": int(out["peak"])}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "device": device}
    if not cell.trace:
        result["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        return result, checks
    trace = out["trace"]
    metrics = {}
    for m in cell.per_layer:
        value = harness.metric_reader(m["name"])(trace)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    device["busy_s"], device["window_s"] = trace.busy_s, trace.window_s
    result["breakdown"] = {"device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}
    return result, checks


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = harness.load_cell(args.workload, args.seed, args.seconds, bool(args.trace))
        harness.require_cards(cell.workload["chips"])
        print(harness.describe_card(), file=sys.stderr, flush=True)
        print(f"at {time.perf_counter() - T0:.3f} s: torch and the card up", file=sys.stderr)
        result, checks = run_cell(cell, T0)
    except harness.CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
