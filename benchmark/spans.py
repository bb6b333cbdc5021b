"""The program's own spans (`conditioned_nerf_gan_torch/utils/tracing.py`),
read in the process that ran the cell, for the per-layer metrics built on
them.

A traced window (`harness.profile_window`) runs its steps or requests
twice: first tracing the device alone, then the host too. A metric takes
the first half of the root spans of its kind: the pass whose host the
profiler did not slow down. A program without the spans (no
`utils.tracing`) reads as one that recorded none.
"""

from __future__ import annotations

import statistics


def records() -> list[dict]:
    """The program's span records, or [] where it has none."""
    try:
        from conditioned_nerf_gan_torch.utils import tracing
    except ImportError:
        return []
    return tracing.records()


def first_pass(recs: list[dict], *root_names: str) -> list[tuple]:
    """The first half of the roots named `root_names[0]`, each with the
    roots of the other names at the same index: [(root id, ...)], one a
    step or request."""
    halves = []
    for name in root_names:
        ids = sorted(r["id"] for r in recs if r["name"] == name and r["root"] == r["id"])
        halves.append(ids[:len(ids) // 2])
    return list(zip(*halves))


def median_sum(recs: list[dict], units: list[tuple], names: tuple, field: str):
    """The median over `units` (tuples of root ids) of the sum of `field`
    over their spans named in `names`; units with no such span are left
    out. None where no unit has one."""
    sums = []
    for unit in units:
        values = [r[field] for r in recs if r["root"] in unit and r["name"] in names
                  and r[field] is not None]
        if values:
            sums.append(sum(values))
    return statistics.median(sums) if sums else None


def train_median(trace, names: tuple, field: str = "device_ms"):
    """A train cell's median over the first pass's steps (`train.step`
    roots) of the step's spans in `names`, summed."""
    if trace.kind != "train":
        return None
    recs = records()
    return median_sum(recs, first_pass(recs, "train.step"), names, field)


def serve_median(trace, names: tuple, field: str):
    """A serve cell's median over the first pass's requests (the k-th
    `infer.encode` root with the k-th `infer.render_batched` root) of the
    request's spans in `names`, summed."""
    if trace.kind != "serve":
        return None
    recs = records()
    return median_sum(recs, first_pass(recs, "infer.encode", "infer.render_batched"),
                      names, field)
