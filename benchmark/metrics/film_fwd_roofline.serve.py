"""The FiLM-SIREN forward's share of its roofline in a render request, %:
as film_fwd_roofline.train."""

from benchmark.harness import roofline_share


def read(trace):
    if trace.kind != "serve" or "film_siren_mlp" not in trace.ranges:
        return None
    calls, device_s = trace.ranges["film_siren_mlp"]
    return roofline_share(calls, device_s)
