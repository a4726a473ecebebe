"""The share of the traced window in which the device is idle
(``Trace.gaps()``) while the host is inside the program's ``train.batch``
or ``train.inputs`` span (the step's batch gathered from the device cache
by indices copied in; its noise and angles drawn on the host and copied
in), in %: the part of ``idle_pct.train`` that taking the inputs
leaves."""
from port_bench.harness import spans


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    inputs = spans.host(ctx, ("train.batch", "train.inputs"))
    if not inputs:
        return None
    tr = ctx.trace
    idle = spans.overlap_ns(tr.gaps(), [(lo, hi) for _, lo, hi in inputs])
    return 100.0 * idle / (tr.t1 - tr.t0)
