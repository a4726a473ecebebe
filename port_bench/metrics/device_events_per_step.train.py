"""Device operations (kernels, copies and sets) in the trace, per traced
training step: the launches the host pays for."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    return ctx.trace.count() / ctx.traced_steps
