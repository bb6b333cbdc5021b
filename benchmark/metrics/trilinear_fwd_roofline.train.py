"""The trilinear lookup's share of its roofline in the train step, %: the
bytes of each call (coordinates, the voxels its points touch, features
out; counts.trilinear_fwd) over 3.35e12, over the device time inside the
range around the launcher."""

from benchmark.harness import roofline_share


def read(trace):
    if trace.kind != "train" or "trilinear_fwd" not in trace.ranges:
        return None
    calls, device_s = trace.ranges["trilinear_fwd"]
    return roofline_share(calls, device_s)
