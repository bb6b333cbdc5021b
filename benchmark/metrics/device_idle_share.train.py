"""Device idle share of the traced window, %: 100 x (1 - busy / window), busy
the union of device activity intervals from torch.profiler."""


def read(trace):
    if trace.kind != "train" or not trace.window_s or trace.busy_s is None:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
