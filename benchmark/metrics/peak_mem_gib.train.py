"""Peak device memory over the window, GiB: max_memory_allocated() after
reset_peak_memory_stats() at the window's start. A guard, not a target."""


def read(trace):
    if trace.kind != "train":
        return None
    return trace.values.get("peak_gib")
