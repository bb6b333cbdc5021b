"""Median over a traced window's requests of the encode's device time, ms:
the CUDA events of the program's `infer.encode` span (the clouds' copy and
the encoder; no synchronize added), in the pass that traced the device
alone."""

from benchmark import spans


def read(trace):
    return spans.serve_median(trace, ("infer.encode",), "device_ms")
