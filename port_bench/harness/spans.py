"""The program's own spans (``lie_vae_tpu_torch.tracing``) in a traced
run, read two ways, both on ``time.time_ns()``'s clock, which the profiler
stamps its events on:

- ``host``: the trace's host events by name inside the traced window
  (each span opens a ``record_function`` of its name);
- ``recorded``: the program's record (``tracing.take()``: span ids,
  parents, request or step ids, device extents), taken once a run and kept
  on the context, filtered to the traced window's [t0, t1] (the serving
  cell may trace three times; only the last trace is the context's).

A program without the spans gives empty lists, and the metrics that read
them give None. A metric is normalised per ``train.step`` or
``session.request`` span found in the window.
"""
import importlib


def host(ctx, names):
    """(name, start ns, end ns) of the trace's host events named in
    ``names`` inside the traced window."""
    tr = ctx.trace
    return [h for h in tr.host
            if h[0] in names and tr.t0 <= h[1] and h[2] <= tr.t1]


def recorded(ctx):
    """The program's recorded spans inside the traced window."""
    if ctx.trace is None:
        return []
    if getattr(ctx, "program_spans", None) is None:
        try:
            tracing = importlib.import_module("lie_vae_tpu_torch.tracing")
        except ModuleNotFoundError:
            ctx.program_spans = []
        else:
            ctx.program_spans = tracing.take()
    tr = ctx.trace
    return [s for s in ctx.program_spans
            if tr.t0 <= s.start_ns and s.end_ns <= tr.t1]


def named(spans, name):
    return [s for s in spans if s.name == name]


def union(intervals):
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def overlap_ns(a, b):
    """The length of the intersection of the unions of ``a`` and ``b``."""
    a, b = union(a), union(b)
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_ns(span, spans):
    """A span's duration less the union of its child spans."""
    children = [(s.start_ns, s.end_ns) for s in spans
                if s.parent_id == span.span_id]
    return (span.end_ns - span.start_ns) - overlap_ns(
        [(span.start_ns, span.end_ns)], children)
