"""The FiLM-SIREN VJP's share of its roofline in the train step, %: each
call's least time (dX and dW FLOPs, no recompute, or its boundary bytes,
counts.film_bwd) over the device time inside the range around the entry
point."""

from benchmark.harness import roofline_share


def read(trace):
    if trace.kind != "train" or "film_siren_mlp_bwd" not in trace.ranges:
        return None
    calls, device_s = trace.ranges["film_siren_mlp_bwd"]
    return roofline_share(calls, device_s)
