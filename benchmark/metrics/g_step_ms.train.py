"""Median over a traced window's steps of the G/E step's device time, ms:
the CUDA events of the program's `train.g_step` span (every `batch_split`
split, the backward and the G and E optimizer steps), in the pass that
traced the device alone."""

from benchmark import spans


def read(trace):
    return spans.train_median(trace, ("train.g_step",))
