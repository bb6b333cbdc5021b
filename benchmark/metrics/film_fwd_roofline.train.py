"""The FiLM-SIREN forward's share of its roofline in the train step, %:
each call's least time (matmul FLOPs / 989e12 or its boundary bytes /
3.35e12, counts.film_fwd) over the device time of the kernels launched
inside the benchmark's record_function range around the entry point."""

from benchmark.harness import roofline_share


def read(trace):
    if trace.kind != "train" or "film_siren_mlp" not in trace.ranges:
        return None
    calls, device_s = trace.ranges["film_siren_mlp"]
    return roofline_share(calls, device_s)
