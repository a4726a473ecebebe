"""What a run records and prints: the process's age (set-up time counts
from the process's start), the device, and the result line.
"""
import json
import os
import subprocess
import sys
import time

import torch


def process_age_s():
    """Seconds since this process started, from /proc (the kernel's start
    time in clock ticks against the machine's uptime); where /proc does not
    say, since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED


_IMPORTED = time.monotonic()


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


class Context:
    """What the metric readers read: the cell, its configuration and
    traffic, ``setup_s``, the measured window (``window_s`` on the host's
    clock, ``images``, ``steps`` or ``requests``, request ``latencies_s``
    and ``service_s``), and with ``--trace 1`` the ``trace``
    (``harness.trace.Trace``) and the traced window's ``traced_steps`` or
    ``traced_requests``."""

    def __init__(self, **fields):
        self.trace = None
        self.__dict__.update(fields)


def device_info(count, trace=None):
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def emit(result, checks):
    """The result line, last on standard output, with ``checks`` as its
    last key; then each number compared beside its limit as the last lines
    on standard error."""
    result = dict(result, checks=checks)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
