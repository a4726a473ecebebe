"""The traced window: ``torch.profiler`` over a few steps or requests after
the measured window, read in memory (nothing is written to disk), and the
arithmetic the per-layer metrics take from it.

The device's busy time is the union of its kernel, copy and set
intervals inside the window (the union arithmetic is a frozen copy of
``lie_vae_tpu_torch/profile_serve.py``'s ``_busy_us``, commit 81ffa68); an
idle gap is labelled by what the host was doing at its middle: the
benchmark's own span around the call (``step``, ``request``, ``arrival``)
and the innermost host operation inside it.
"""
import bisect
import collections
import re

import torch

SPANS = ("window", "step", "request", "arrival")
# cuDNN's convolution kernels by name: the fprop, dgrad and wgrad engines
# and implicit GEMMs, and the layout transposes around them
CONV_KERNELS = (r"(?i)conv(?!ert)|dgrad|wgrad|fprop|implicit_gemm"
                r"|nchwToNhwc|nhwcToNchw|fft2d|flip_filter")


class Span:
    """A ``record_function`` span opened and closed by hand (a step's span
    runs from one ``on_step`` call to the next)."""

    def __init__(self, name):
        self._rf = torch.profiler.record_function(name)
        self._rf.__enter__()

    def close(self):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None


def profiler():
    """A profiler of the host and the card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _union(spans):
    """Seconds covered by the union of (start, end) ns intervals."""
    busy, end = 0, None
    for lo, hi in sorted(spans):
        if end is None or hi > end:
            busy += hi - (lo if end is None else max(lo, end))
            end = hi
    return busy / 1e9


class Trace:
    """The events of one profiled window: ``device`` (name, start ns, end
    ns, kind: 'kernel', 'copy' or 'set') inside the window, and ``host``
    (name, start ns, end ns) operations and spans."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        device, host = [], []
        for e in events:
            name, lo = e.name(), e.start_ns()
            hi = lo + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if name in SPANS or e.is_user_annotation():
                    continue      # a span's extent on the device's timeline
                kind = ("copy" if name.startswith("Memcpy") else
                        "set" if name.startswith("Memset") else "kernel")
                device.append((name, lo, hi, kind))
            else:
                host.append((name, lo, hi))
        windows = [h for h in host if h[0] == "window"]
        if not windows:
            raise RuntimeError("the trace holds no 'window' span")
        self.t0, self.t1 = windows[0][1], windows[0][2]
        self.device = sorted(
            (d for d in device if d[2] > self.t0 and d[1] < self.t1),
            key=lambda d: d[1])
        self.host = sorted(host, key=lambda h: h[1])
        self.window_s = (self.t1 - self.t0) / 1e9
        self.busy_s = _union((max(lo, self.t0), min(hi, self.t1))
                             for _, lo, hi, _ in self.device)

    def count(self, kinds=("kernel", "copy", "set")):
        return sum(1 for d in self.device if d[3] in kinds)

    def seconds(self, pattern, kind="kernel"):
        """Device seconds and count of the events of ``kind`` whose name
        matches the regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [d for d in self.device if d[3] == kind and rx.search(d[0])]
        return sum(d[2] - d[1] for d in hits) / 1e9, len(hits)

    def top_ops(self, n=10):
        """The ``n`` device operations that took most time, by name."""
        total = collections.Counter()
        for name, lo, hi, _ in self.device:
            total[name[:120]] += (hi - lo) / 1e9
        return [[k, v] for k, v in total.most_common(n)]

    def gaps(self):
        """Idle intervals (start ns, end ns) of the device in the window."""
        out, end = [], self.t0
        for _, lo, hi, _ in self.device:
            if lo > end:
                out.append((end, lo))
            end = max(end, hi)
        if self.t1 > end:
            out.append((end, self.t1))
        return out

    def _label(self, t):
        """The benchmark's span and the innermost host operation at t."""
        starts = [h[1] for h in self.host]
        i = bisect.bisect_right(starts, t)
        inner, span = None, None
        for name, lo, hi in self.host[:i]:
            if hi >= t:
                if name in SPANS:
                    if name != "window":
                        span = name
                else:
                    inner = name
        parts = [p for p in (span, inner) if p]
        return " > ".join(parts) if parts else "host"

    def idle_gaps(self, n=10):
        """The ``n`` longest idle gaps, each labelled by the host's work at
        its middle."""
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self._label((lo + hi) // 2), (hi - lo) / 1e9]
                for lo, hi in longest]
