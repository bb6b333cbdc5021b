"""Median over a traced window's steps of the optimizer steps' device time,
ms: the sum of the step's `train.optim` spans (`ClippedAdam.step`, the
global-norm clip and Adam; D, G and E with a discriminator, else G and E),
by their CUDA events, in the pass that traced the device alone."""

from benchmark import spans


def read(trace):
    return spans.train_median(trace, ("train.optim",))
