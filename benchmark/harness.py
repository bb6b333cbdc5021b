"""What every cell shares: the cell's files found by name, the card's
checks and description, the weights made from the seed, the traced window's
reduction, the per-layer readers and the result line.

A cell is an entry of BENCHMARK.json's `workloads`. Its configuration is
`configs/<config>.json`, its traffic `traffic/<traffic>.json` (whose
`driver` names the one module in `drivers/` that runs that kind of traffic),
its limits for `correct` `limits/<workload>.json`, its plain reference
`reference/<config>.py`, and each per-layer metric `metrics/<name>.py`, a
`read(trace)` that returns a number or None. Adding any of these is adding
files and entries; nothing here names a cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "conditioned_nerf_gan_tpu")


class CellError(RuntimeError):
    """A cell that cannot run here: no result is printed."""


# ---------------------------------------------------------------------------
# the cell's files
# ---------------------------------------------------------------------------


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    # smaller sizes for the CPU tests (never set by run.py)
    overrides: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, seed: int, seconds: float, trace: bool,
              spec_path: Path | None = None) -> Cell:
    """The cell `workload` of BENCHMARK.json with its files."""
    spec = _read_json(spec_path or ROOT / "BENCHMARK.json")
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    return make_cell(spec, found[0], seed, seconds, trace)


def make_cell(spec: dict, w: dict, seed: int, seconds: float, trace: bool) -> Cell:
    """The cell of the workload entry `w` (name, config, traffic, chips)
    under BENCHMARK.json's `spec`, with its files."""
    conf = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    config = _read_json(ROOT / conf["file"])
    traffic = _read_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH / "limits" / f"{w['name']}.json"
    limits = _read_json(limits_path) if limits_path.exists() else {}

    def applies(metric):
        return "workloads" not in metric or w["name"] in metric["workloads"]

    return Cell(w, config, traffic, limits,
                [m for m in spec["end_to_end"] if applies(m)],
                [m for m in spec["per_layer"] if applies(m)],
                seed, seconds, trace)


def driver(cell: Cell):
    """The module that runs this cell's kind of traffic."""
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")


def reference(cell: Cell):
    """The plain reference of this cell's configuration."""
    return importlib.import_module(f"benchmark.reference.{cell.config['name']}")


def metric_reader(name: str):
    """`metrics/<name>.py`'s `read`."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise CellError("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise CellError(f"the cell asks for {n} cards, {torch.cuda.device_count()} visible")


def describe_card() -> str:
    """The card's name, its power limit and the process's precision flags."""
    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi not readable"
    flags = (f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
             f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
             f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    return (f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | {flags} | "
            f"torch {torch.__version__} cuda {torch.version.cuda}")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


# ---------------------------------------------------------------------------
# weights from the seed
# ---------------------------------------------------------------------------


def make_weights(specs: dict, shapes: dict, seed: int, device) -> dict:
    """Every parameter from `seed` in two draws on `device` (one uniform
    buffer, one normal), each leaf a slice scaled by its rule: (uniform,
    bound), (normal, std) or (const, value). fp32, as the configurations
    hold their parameters."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {name: math.prod(shapes[name]) for name in specs}
    n_u = sum(sizes[n] for n, (k, _) in specs.items() if k == "uniform")
    n_n = sum(sizes[n] for n, (k, _) in specs.items() if k == "normal")
    u = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    g = torch.randn(n_n, generator=gen, device=device)
    out, iu, ig = {}, 0, 0
    for name, (kind, scale) in specs.items():
        n, shape = sizes[name], shapes[name]
        if kind == "uniform":
            out[name] = (u[iu:iu + n] * scale).view(shape)
            iu += n
        elif kind == "normal":
            out[name] = (g[ig:ig + n] * scale).view(shape)
            ig += n
        else:
            out[name] = torch.full(shape, scale, device=device)
    return out


def model_weights(ref, config: dict, seed: int, device) -> dict:
    """{"generator": {...}, "encoder": {...}, "discriminator": {...}} drawn
    from `seed`: the shapes and rules are the reference's, built on the meta
    device (nothing allocated)."""
    import torch

    from .reference.plain import init_specs

    with torch.device("meta"):
        modules = ref.build(config)
    specs, shapes = {}, {}
    for part, module in modules.items():
        if module is None:
            continue
        for name, spec in init_specs(module).items():
            specs[f"{part}/{name}"] = spec
        for name, p in module.named_parameters():
            shapes[f"{part}/{name}"] = tuple(p.shape)
    flat = make_weights(specs, shapes, seed, device)
    out = {part: {} for part, m in modules.items() if m is not None}
    for key, value in flat.items():
        part, name = key.split("/", 1)
        out[part][name] = value
    return out


# ---------------------------------------------------------------------------
# the traced window
# ---------------------------------------------------------------------------


@dataclass
class Trace:
    """What a `--trace 1` run read, for the metric readers. `ranges` maps a
    wrapped entry point to its calls' least times and the device time of
    the kernels launched inside its `record_function` ranges (None where
    the entry point was not called)."""

    kind: str  # "train" or "serve"
    busy_s: float | None = None
    window_s: float | None = None
    ranges: dict = field(default_factory=dict)
    values: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def profile_window(fn, range_names, between=None) -> dict:
    """Run fn twice under torch.profiler and reduce the traces. The first
    pass traces the device alone, which costs the host little: busy seconds
    (the union of device activity intervals), the window's seconds and the
    device operations that took most time. The second traces the host too:
    the device seconds of the operations launched inside each
    `record_function` range of `range_names`, and the longest idle gaps by
    the host op then running (the host's tracing lengthens these gaps).
    `between` runs between the passes (the callers clear their per-call
    records there, so that they count the second pass alone)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ranges = set(range_names)

    def device_ops(events):
        return [e for e in events if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False) and e.name not in ranges]

    def traced(activities):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        return prof.events(), seconds

    events, window_s = traced([ProfilerActivity.CUDA])
    busy_us, _, by_name = _union(device_ops(events))
    if between is not None:
        between()
    events, _ = traced([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    device = device_ops(events)
    _, gaps, _ = _union(device)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "range_s": _range_device_seconds(host, device, ranges),
        "device_ops": sorted(([n, us / 1e6] for n, us in by_name.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": _label_gaps(gaps, host),
    }


def _union(device):
    """(busy us: the union of the operations' intervals, the gaps between
    them, {name: us})."""
    busy_us, end, gaps = 0.0, -math.inf, []
    by_name: dict[str, float] = {}
    for e in sorted(device, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        if s > end > -math.inf:
            gaps.append((end, s))
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    return busy_us, gaps, by_name


def _range_device_seconds(host, device, ranges) -> dict:
    """{range name: device seconds of the operations launched inside its
    ranges, or None where no range was recorded}. A device operation is
    matched to the runtime or driver call that launched it by correlation
    id, and belongs to a range where that call started inside one of the
    range's intervals on the same thread (whatever launched it: an aten op,
    or a hand-written kernel through ctypes)."""
    import bisect

    spans: dict = {}
    for e in host:
        if e.name in ranges:
            spans.setdefault(e.name, []).append((e.thread, e.time_range.start, e.time_range.end))
    launches = {e.id: e for e in host if e.name.startswith("cu")}
    seconds = {name: (0.0 if name in spans else None) for name in ranges}
    index = {}
    for name, items in spans.items():
        by_thread: dict = {}
        for thread, s, t in items:
            by_thread.setdefault(thread, []).append((s, t))
        index[name] = {th: sorted(v) for th, v in by_thread.items()}
    for d in device:
        call = launches.get(d.id)
        if call is None:
            continue
        at = call.time_range.start
        for name, by_thread in index.items():
            intervals = by_thread.get(call.thread)
            if not intervals:
                continue
            i = bisect.bisect_right(intervals, (at, math.inf)) - 1
            if i >= 0 and intervals[i][0] <= at <= intervals[i][1]:
                seconds[name] += (d.time_range.end - d.time_range.start) / 1e6
    return seconds


def _label_gaps(gaps, host_events) -> list:
    """Idle gaps summed by the innermost host op that spans each gap's
    middle; "host (no op)" where none does."""
    if not gaps:
        return []
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host_events
                    if e.time_range.end > e.time_range.start), key=lambda s: s[0])
    starts = [s[0] for s in spans]
    import bisect

    totals: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label, best = "host (no op)", math.inf
        i = bisect.bisect_right(starts, mid)
        # the innermost (shortest) span that contains mid, among the spans
        # that start before it; spans are short, so look back a bounded way
        for s, t, name in spans[max(0, i - 2000):i]:
            if t >= mid and t - s < best:
                label, best = name, t - s
        totals[label] = totals.get(label, 0.0) + (b - a) / 1e6
    return sorted(([n, s] for n, s in totals.items()), key=lambda kv: -kv[1])[:10]


def roofline_share(calls: list, device_s: float | None) -> float | None:
    """100 x the calls' least time (the larger of FLOPs / the bf16 peak and
    bytes / the HBM peak, summed) over their measured device time; None
    where nothing was measured."""
    if not calls or not device_s:
        return None
    least = sum(max(f / PEAK_BF16_FLOPS, b / PEAK_HBM_BYTES) for f, b in calls)
    return 100.0 * least / device_s


# ---------------------------------------------------------------------------
# correct, and the result line
# ---------------------------------------------------------------------------


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each limited reading against its limit: correct where the cell has
    limits and every limited number was read, finite and at or under its
    limit. Readings without a limit are not compared."""
    checks, ok = {}, True
    for name in sorted(limits):
        value, limit = readings.get(name), limits.get(name)
        good = (value is not None and limit is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok and bool(checks), checks


def emit(result: dict, checks: dict) -> None:
    """The checks as the last lines on stderr, then the result as the last
    line on stdout, its `checks` key last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
