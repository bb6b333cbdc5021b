"""Median host time of Inferencer.encode, ending in a synchronize, over a
window of requests timed so, ms."""


def read(trace):
    return trace.values.get("encode_ms") if trace.kind == "serve" else None
