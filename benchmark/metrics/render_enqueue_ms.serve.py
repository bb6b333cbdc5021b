"""Median over a traced window's requests of the host's time to issue the
render, ms: the host clock of the request's `gen.render` spans (the ray
set-up and the chunk loop, which returns before the device finishes), in
the pass that traced the device alone."""

from benchmark import spans


def read(trace):
    return spans.serve_median(trace, ("gen.render",), "host_ms")
