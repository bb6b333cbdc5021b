"""Median host time of Inferencer.render_batched (numpy back), after an
encode that ended in a synchronize, over a window of requests, ms."""


def read(trace):
    return trace.values.get("render_ms") if trace.kind == "serve" else None
