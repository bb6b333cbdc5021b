"""The whole train step's share of the bf16 peak, %: the model FLOPs of a
step (counts.train_step_flops of the shapes logged at set-up) x the steps
of the untraced window over its seconds, over 989e12."""


def read(trace):
    if trace.kind != "train":
        return None
    return trace.values.get("mfu")
