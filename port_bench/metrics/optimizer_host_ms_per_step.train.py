"""The host's time in the optimizer (the program's ``train.optimizer``
span: clip, L2 and Adam, a few launches a parameter), its self time, ms
per ``train.step`` span of the traced window. A profiled figure: it is
read only under ``torch.profiler``, whose own cost on every launch is in
it. Untraced, the host runs ahead of the card and ``optimizer.step()``
waits for room in the full launch queue, so its untraced host time is
about twice this figure and mostly waiting (``PERF.md``, section 3).
Compare it between traced runs only."""
from port_bench.harness import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    rec = spans.recorded(ctx)
    steps, opt = spans.named(rec, "train.step"), spans.named(
        rec, "train.optimizer")
    if not steps or not opt:
        return None
    return sum(spans.self_ns(s, rec) for s in opt) / 1e6 / len(steps)
