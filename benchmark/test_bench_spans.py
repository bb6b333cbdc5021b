"""The readers of the program's spans on stand-in records: each takes the
median over the first half of its roots (the pass that traced the device
alone), and reads nothing on an empty store or on the other kind of cell."""

import pytest

from benchmark import harness, spans

TRAIN = ("d_step_ms.train", "g_step_ms.train", "optimizer_ms.train")
SERVE = ("encode_device_ms.serve", "render_enqueue_ms.serve", "host_wait_ms.serve")


class Store:
    """Stand-in records, ids in the order the spans opened."""

    def __init__(self):
        self.recs, self.next_id = [], 1

    def add(self, name, root=None, parent=None, host_ms=0.0, device_ms=None):
        rid = self.next_id
        self.next_id += 1
        parent = root if parent is None and root is not None else parent
        self.recs.append({"name": name, "id": rid, "parent": parent,
                          "root": rid if root is None else root, "thread": 1,
                          "start_ns": 0, "end_ns": int(host_ms * 1e6),
                          "host_ms": host_ms, "device_ms": device_ms})
        return rid


def train_store(passes=2):
    """Two passes of 3 steps; step i of pass p: D 100 + 10i, G 300 + 10i,
    three optimizer steps of 5 + i, all x10 in the second pass."""
    s = Store()
    for p in range(passes):
        k = 10 ** p
        for i in range(3):
            step = s.add("train.step", device_ms=k * (400 + 20 * i))
            d = s.add("train.d_step", step, device_ms=k * (100 + 10 * i))
            s.add("train.optim", step, parent=d, device_ms=k * (5 + i))
            g = s.add("train.g_step", step, device_ms=k * (300 + 10 * i))
            s.add("gen.chunk", step, parent=g, host_ms=1.0)
            for _ in range(2):
                s.add("train.optim", step, parent=g, device_ms=k * (5 + i))
    return s.recs


def serve_store(passes=2):
    """Two passes of 3 requests; request i of pass p: encode 30 + i device
    ms, render issue 20 + i host ms, copies 1 + i (clouds) + 2 (cameras) +
    4 (to host) host ms, all x10 in the second pass."""
    s = Store()
    for p in range(passes):
        k = 10 ** p
        for i in range(3):
            enc = s.add("infer.encode", device_ms=k * (30 + i), host_ms=k * 12.0)
            s.add("infer.h2d", enc, host_ms=k * (1 + i))
            ren = s.add("infer.render_batched", host_ms=k * 40.0)
            s.add("infer.h2d", ren, host_ms=k * 2)
            s.add("gen.render", ren, host_ms=k * (20 + i))
            s.add("infer.to_host", ren, host_ms=k * 4)
    return s.recs


@pytest.fixture
def store(monkeypatch):
    held = []
    monkeypatch.setattr(spans, "records", lambda: list(held))
    return held


@pytest.mark.parametrize("name,kind,make,want", [
    ("d_step_ms.train", "train", train_store, 110.0),
    ("g_step_ms.train", "train", train_store, 310.0),
    ("optimizer_ms.train", "train", train_store, 18.0),  # 3 x 6
    ("encode_device_ms.serve", "serve", serve_store, 31.0),
    ("render_enqueue_ms.serve", "serve", serve_store, 21.0),
    ("host_wait_ms.serve", "serve", serve_store, 8.0),  # 2 + 2 + 4
])
def test_a_reader_takes_the_median_of_the_first_pass(store, name, kind, make, want):
    store.extend(make())
    read = harness.metric_reader(name)
    assert read(harness.Trace(kind)) == pytest.approx(want)
    other = "serve" if kind == "train" else "train"
    assert read(harness.Trace(other)) is None


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_a_reader_reads_nothing_without_records(store, name):
    read = harness.metric_reader(name)
    assert read(harness.Trace("train")) is None
    assert read(harness.Trace("serve")) is None
    store.extend(train_store() if name in SERVE else serve_store())
    assert read(harness.Trace(name.rsplit(".", 1)[1])) is None  # none of its kind


def test_a_dg_step_sums_its_two_optimizer_steps(store):
    s = Store()
    for p in range(2):
        for i in range(3):
            step = s.add("train.step", device_ms=300.0)
            g = s.add("train.g_step", step, device_ms=290.0 + i)
            for _ in range(2):
                s.add("train.optim", step, parent=g, device_ms=4.0 + i + 100 * p)
    store.extend(s.recs)
    trace = harness.Trace("train")
    assert harness.metric_reader("optimizer_ms.train")(trace) == pytest.approx(10.0)
    assert harness.metric_reader("g_step_ms.train")(trace) == pytest.approx(291.0)
    assert harness.metric_reader("d_step_ms.train")(trace) is None  # no D


def test_the_records_are_the_programs():
    from conditioned_nerf_gan_torch.utils import tracing

    tracing.clear()
    assert spans.records() == []
