"""The regularizers' forward as the card sees it: the device extent of the
program's ``train.losses`` span (CUDA events at its open and close: the
shear rotation, the second encoder pass and the continuity loss), ms per
``train.step`` span of the traced window. The extent is no busy time: it
counts the idle between the span's kernels too, and under the profiler
that idle is mostly the host's launch stalls, so a host-side fix to the
losses moves it as a shorter device time would. Their backward runs
inside ``train.backward`` and is not counted."""
from port_bench.harness import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    rec = spans.recorded(ctx)
    steps = spans.named(rec, "train.step")
    losses = [s for s in spans.named(rec, "train.losses")
              if s.device_ms is not None]
    if not steps or not losses:
        return None
    return sum(s.device_ms for s in losses) / len(steps)
