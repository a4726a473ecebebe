"""Spans of the program's layers: the training step's and the serving
session's stages, recorded only while a ``torch.profiler`` session runs.

``span(name, id=None, device=False)`` is a context manager. With no
profiler active (``torch.autograd._profiler_enabled()``) it returns one
shared no-op context and records nothing. Under a profiler it opens
``torch.profiler.record_function(name)``, so the span is in the
profiler's trace (and in ``cli.main --profile_dir``'s chrome trace) beside
the operations and kernels it covers, and it keeps a record in memory:
its name, its own ``span_id``, its parent's (the innermost span open on
the same thread), the request or step ``id`` (a child without one takes
its parent's), and its start and end from ``time.time_ns()``, the clock
the profiler stamps its events on. With ``device=True`` it also records a
CUDA event on the current stream at its open and at its close: its device
extent, the device time from the end of the work queued before the span
to the end of the work queued inside it, idle time between included. The
extent is None on the CPU (no CUDA context) and while the stream is
capturing a CUDA graph, which records no event; no span sits inside a
function that a graph captures.

``take()`` returns the records so far, oldest first, and clears them,
each device extent resolved to milliseconds. The record holds the newest
``CAPACITY`` spans; past that the oldest are dropped.

The spans, where they open and close, and what reads them are listed in
``PERF.md`` (section 3); ``README.md`` names them.
"""
import collections
import contextlib
import itertools
import threading
import time

import torch

CAPACITY = 16384

Span = collections.namedtuple(
    "Span", "name span_id parent_id id start_ns end_ns device_ms")
_OFF = contextlib.nullcontext()
_record = collections.deque(maxlen=CAPACITY)
_span_ids = itertools.count(1)
_open = threading.local()


def _stack():
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def _events():
    """A started pair of timing events on the current stream, or None on
    the CPU and while the stream captures a graph."""
    if not torch.cuda.is_initialized() \
            or torch.cuda.is_current_stream_capturing():
        return None
    stream = torch.cuda.current_stream()
    start = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    return stream, start


class _On:
    __slots__ = ("name", "id", "device", "span_id", "parent_id", "start_ns",
                 "_fn", "_events")

    def __init__(self, name, id, device):
        self.name, self.id, self.device = name, id, device

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent_id = parent.span_id if parent is not None else None
        if self.id is None and parent is not None:
            self.id = parent.id
        self.span_id = next(_span_ids)
        self._fn = torch.profiler.record_function(self.name)
        # stamped next to the profiler's own stamps of the span
        self.start_ns = time.time_ns()
        self._fn.__enter__()
        self._events = _events() if self.device else None
        stack.append(self)
        return self

    def __exit__(self, *exc):
        events = None
        if self._events is not None:
            stream, start = self._events
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            events = (start, end)
        end_ns = time.time_ns()
        self._fn.__exit__(*exc)
        _stack().pop()
        _record.append((self.name, self.span_id, self.parent_id, self.id,
                        self.start_ns, end_ns, events))
        return False


def span(name, id=None, device=False):
    """A span named ``name`` around a ``with`` block: recorded under a
    profiler, a shared no-op otherwise. ``id`` is the request or step it
    belongs to (None: its parent's); ``device=True`` adds its device
    extent."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _On(name, id, device)


def take():
    """The spans recorded so far (``Span`` tuples, oldest first), the
    record cleared; a device extent waits for its end event."""
    out = []
    while True:
        try:
            name, span_id, parent_id, id_, lo, hi, events = \
                _record.popleft()
        except IndexError:
            return out
        ms = None
        if events is not None:
            start, end = events
            end.synchronize()
            ms = start.elapsed_time(end)
        out.append(Span(name, span_id, parent_id, id_, lo, hi, ms))
