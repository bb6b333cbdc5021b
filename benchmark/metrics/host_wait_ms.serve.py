"""Median over a traced window's requests of the host's time in copies that
wait for the device, ms: the host clock of the request's `infer.h2d` spans
(inputs copied from host memory: the clouds, the cameras) and its
`infer.to_host` span (the rendered arrays to numpy), in the pass that
traced the device alone."""

from benchmark import spans


def read(trace):
    return spans.serve_median(trace, ("infer.h2d", "infer.to_host"), "host_ms")
