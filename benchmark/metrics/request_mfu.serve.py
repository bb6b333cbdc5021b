"""A whole request's share of the bf16 peak, %: the model FLOPs of a
request (counts.request_flops) x the requests of the untraced window over
its seconds, over 989e12."""


def read(trace):
    if trace.kind != "serve":
        return None
    return trace.values.get("mfu")
