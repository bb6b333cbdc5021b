"""Median over a traced window's steps of the D step's device time, ms:
the CUDA events of the program's `train.d_step` span (the stream's time
from the work queued before it to its own last operation), in the pass
that traced the device alone."""

from benchmark import spans


def read(trace):
    return spans.train_median(trace, ("train.d_step",))
