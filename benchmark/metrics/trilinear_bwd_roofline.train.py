"""The trilinear VJP's share of its roofline in the train step, %: the
bytes of each call (coordinates and cotangent in, the touched rows of dV
out; counts.trilinear_bwd) over 3.35e12, over the device time inside the
range around the launcher."""

from benchmark.harness import roofline_share


def read(trace):
    if trace.kind != "train" or "trilinear_bwd" not in trace.ranges:
        return None
    calls, device_s = trace.ranges["trilinear_bwd"]
    return roofline_share(calls, device_s)
