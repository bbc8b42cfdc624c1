"""Device milliseconds a step under ``torch.optim``'s own range of the
port's optimizer (``Optimizer.step#ClippedAdamW.step``: the clip and the
AdamW update)."""


def read(ctx, window, trace):
    if trace is None:
        return None
    ops = trace.ops(lambda name: name.startswith("Optimizer.step#ClippedAdamW.step"))
    if not ops or sum(ops) <= 0:
        return None
    return 1e3 * sum(ops) / len(ops)
