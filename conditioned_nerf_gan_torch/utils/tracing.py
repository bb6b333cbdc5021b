"""Spans at the port's layer boundaries, recorded only while a torch
profiler records.

    with tracing.span("train.d_step", device_time=True):
        ...

With no profiler running, `span` reads one flag
(`torch.autograd._profiler_enabled()`) and returns a shared no-op context
manager: no profiler range, no CUDA event, no record. Under any
`torch.profiler.profile` (the Trainer's `--profile_dir`, a benchmark's
traced window, an operator's own) a span

  * enters a profiler range named `name`, so that it lies in the
    profiler's trace, as a host event, on the clock of the device
    operations it launched. The range is `_RecordFunctionFast`, what
    `torch.profiler.record_function` records less its dispatcher call and
    its user-annotation correlation, which under a CUDA profiler cost ~15
    us a site and ~1-2 us a kernel launch inside (on an H100 a serve
    request ran 11% slower with them, 2.7% with this range);
  * appends a record to this process's store: its name, its id, its
    parent's id (the span open on the same thread, or None), the id of its
    root span, the thread, and host start and end (`time.perf_counter_ns`);
  * with `device_time=True`, once CUDA is up, records a pair of timing
    events on the current stream at entry and exit: the stream's time from
    finishing the work queued before the span to finishing the span's own,
    idle stretches included.

The root is the outermost span open in the process, whatever its thread:
autograd runs a CUDA backward on a thread of its own, and the spans opened
there (a checkpointed chunk's recompute, the backward kernel) carry the
root of the step that called `backward()`. Spans add no tensor operation
and draw no random number, so a checkpointed chunk whose forward and
recompute see the profiler differently computes the same thing.

The store keeps the newest `MAX_RECORDS` records and holds no tensor;
`records()` reads them (device milliseconds worked out from the events
then, which waits for them), `clear()` empties it.

The port's spans: `train.step` (the root of a train step), `train.d_step`,
`train.g_step`, `train.optim` (a `ClippedAdam.step`: clip and Adam) with
device time, `train.encode`; `gen.render` (a generator's forward) and
`gen.chunk` (one ray chunk, and its recompute); `infer.encode` (a root,
with device time) and `infer.render_batched` (a root), `infer.h2d` (a copy
from host memory, which waits for the stream: a request's inputs, and a
render's field of view, in a train step too; `h2d_span`) and
`infer.to_host` (the rendered arrays to numpy); `kern.film_fwd`, `kern.film_bwd`,
`kern.trilinear_fwd` and `kern.trilinear_bwd` (the CUDA branches of the
kernel entry points).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

MAX_RECORDS = 65536

_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()
_root_id = None  # the open root span's id, process-wide


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device_time", "id", "parent", "root", "thread", "start_ns",
                 "end_ns", "events", "_range")

    def __init__(self, name: str, device_time: bool):
        self.name, self.device_time = name, device_time
        self.events = None

    def __enter__(self):
        global _root_id
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1] if stack else None
        if _root_id is None:
            _root_id = self.id
        self.root = _root_id
        self.thread = threading.get_ident()
        stack.append(self.id)
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        if self.device_time and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _root_id
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        self._range = None
        _local.stack.pop()
        if _root_id == self.id:
            _root_id = None
        _records.append(self)
        return False


def span(name: str, device_time: bool = False):
    """A context manager around one layer's work: a no-op unless a torch
    profiler records (see the module's docstring)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, device_time)


def h2d_span(x):
    """The `infer.h2d` span around a copy of x to a device where x lies in
    host memory (an array, a Python number, a CPU tensor): a pageable copy,
    which waits for the work queued on the stream; the no-op where x is on
    a device already."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return _OFF
    return span("infer.h2d")


def records() -> list[dict]:
    """The stored spans, in the order they closed: {"name", "id", "parent", "root",
    "thread", "start_ns", "end_ns", "host_ms", "device_ms"}; device_ms is
    None for a span without device time."""
    out = []
    for s in list(_records):
        device_ms = None
        if s.events is not None:
            s.events[1].synchronize()
            device_ms = s.events[0].elapsed_time(s.events[1])
        out.append({"name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
                    "thread": s.thread, "start_ns": s.start_ns, "end_ns": s.end_ns,
                    "host_ms": (s.end_ns - s.start_ns) / 1e6, "device_ms": device_ms})
    return out


def clear() -> None:
    """Forget every stored span."""
    _records.clear()
