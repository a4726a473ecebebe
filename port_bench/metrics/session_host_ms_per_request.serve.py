"""The session's host work around the device: the durations of the
program's ``session.normalize`` (the uint8 scaling), ``session.chunk``
(cutting, padding and copying the chunks) and ``session.gather`` spans
(``torch.cat``, ``.numpy()``, the concatenation and the cut to N rows),
ms per ``session.request`` span of the traced window."""
from port_bench.harness import spans

HOST = ("session.normalize", "session.chunk", "session.gather")


def read(ctx):
    if ctx.kind != "serve":
        return None
    rec = spans.recorded(ctx)
    requests = spans.named(rec, "session.request")
    work = [s for s in rec if s.name in HOST]
    if not requests or not work:
        return None
    return sum(s.end_ns - s.start_ns for s in work) / 1e6 / len(requests)
