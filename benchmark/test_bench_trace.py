"""The traced window's reduction on stand-in profiler events (the card's
trace needs the card): device busy as the union of intervals, a range's
device time by the launches inside it, idle gaps by the host op spanning
them; and the per-layer readers, which read nothing where nothing was
measured."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import harness


def ev(name, start, end, device=DeviceType.CPU, thread=1, id=0):
    return SimpleNamespace(name=name, device_type=device, thread=thread, id=id,
                           time_range=SimpleNamespace(start=start, end=end))


def test_busy_is_the_union_of_device_intervals():
    ops = [ev("k1", 0, 10, DeviceType.CUDA), ev("k2", 5, 20, DeviceType.CUDA),
           ev("k3", 30, 40, DeviceType.CUDA)]
    busy, gaps, by_name = harness._union(ops)
    assert busy == 30 and gaps == [(20, 30)] and by_name == {"k1": 10, "k2": 15, "k3": 10}


def test_a_range_takes_the_device_time_of_what_it_launched():
    host = [ev("film_siren_mlp", 100, 200, thread=1),
            ev("cuLaunchKernelEx", 150, 152, thread=1, id=7),   # inside: the kernel
            ev("cudaLaunchKernel", 120, 121, thread=1, id=8),   # inside: an aten op's
            ev("cudaLaunchKernel", 250, 251, thread=1, id=9),   # after the range
            ev("cudaLaunchKernel", 160, 161, thread=2, id=10),  # another thread
            ev("film_siren_mlp", 300, 310, thread=1)]
    device = [ev("film_siren_fwd_kernel", 400, 900, DeviceType.CUDA, id=7),
              ev("fold", 200, 260, DeviceType.CUDA, id=8),
              ev("other", 1000, 1100, DeviceType.CUDA, id=9),
              ev("other2", 1100, 1200, DeviceType.CUDA, id=10)]
    got = harness._range_device_seconds(host, device, {"film_siren_mlp", "trilinear_fwd"})
    assert got == {"film_siren_mlp": pytest.approx(560e-6), "trilinear_fwd": None}


def test_idle_gaps_are_labelled_by_the_innermost_host_op():
    host = [ev("step", 0, 1000), ev("aten::cat", 100, 300), ev("cudaMalloc", 500, 520)]
    labels = harness._label_gaps([(150, 250), (505, 515), (900, 980), (2000, 2100)], host)
    assert labels == [["aten::cat", 100e-6], ["host (no op)", 100e-6],
                      ["step", 80e-6], ["cudaMalloc", 10e-6]]


def test_roofline_share():
    # two calls: one FLOP-bound (989e9 FLOPs: 1 ms), one byte-bound (3.35e9 B: 1 ms)
    calls = [(989e9, 1.0), (0, 3.35e9)]
    assert harness.roofline_share(calls, 4e-3) == pytest.approx(50.0)
    assert harness.roofline_share([], 4e-3) is None
    assert harness.roofline_share(calls, None) is None


@pytest.mark.parametrize("name", ["film_fwd_roofline.train", "film_bwd_roofline.train",
                                  "film_fwd_roofline.serve", "trilinear_fwd_roofline.train",
                                  "trilinear_bwd_roofline.train", "device_idle_share.train",
                                  "device_idle_share.serve", "step_mfu.train",
                                  "request_mfu.serve", "encode_ms.serve", "render_ms.serve",
                                  "peak_mem_gib.train", "peak_mem_gib.serve"])
def test_readers_read_nothing_where_nothing_was_measured(name):
    read = harness.metric_reader(name)
    assert read(harness.Trace("train")) is None
    assert read(harness.Trace("serve")) is None


def test_readers_read_their_cell_kind():
    trace = harness.Trace("train", busy_s=0.75, window_s=1.0,
                          ranges={"film_siren_mlp": ([(989e9, 0)], 2e-3)},
                          values={"mfu": 12.5, "peak_gib": 18.0})
    assert harness.metric_reader("device_idle_share.train")(trace) == pytest.approx(25.0)
    assert harness.metric_reader("device_idle_share.serve")(trace) is None
    assert harness.metric_reader("film_fwd_roofline.train")(trace) == pytest.approx(50.0)
    assert harness.metric_reader("film_fwd_roofline.serve")(trace) is None
    assert harness.metric_reader("step_mfu.train")(trace) == 12.5
    assert harness.metric_reader("peak_mem_gib.train")(trace) == 18.0
