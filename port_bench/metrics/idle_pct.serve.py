"""The device's idle share of the traced window: the window less the
union of its kernel, copy and set intervals, in %."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
