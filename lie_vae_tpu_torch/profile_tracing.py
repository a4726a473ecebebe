"""What a span (``tracing.span``) costs the host: its open and close with
no profiler active (off), and under ``torch.profiler`` of the host and the
card (on), with and without its device extent; µs a span, the median of
``REPEATS`` timings of a loop of ``N`` spans off or ``N_ON`` on, an empty
loop's µs beside them. Under the profiler it also reads how far each
span's recorded start lies from the profiler's own event of it (the two
share ``time.time_ns()``'s clock). Prints one JSON line with the card's
name and power limit.

    python -m lie_vae_tpu_torch.profile_tracing
"""
import json
import statistics
import subprocess
import time

import torch

from lie_vae_tpu_torch import tracing

# spans a timing off and on the profiler; N_ON x REPEATS fit in the record
N, N_ON, REPEATS = 200000, 2000, 5


def _per_span_us(body, n):
    """The median over ``REPEATS`` of µs an iteration of ``body`` n
    times."""
    times = []
    for _ in range(REPEATS):
        t = time.perf_counter()
        body(n)
        times.append((time.perf_counter() - t) / n * 1e6)
    return statistics.median(times)


def _empty(n):
    for _ in range(n):
        pass


def _spans(device):
    def body(n):
        for i in range(n):
            with tracing.span("profile_tracing.span", i, device=device):
                pass
    return body


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def main():
    cuda = torch.cuda.is_available()
    if cuda:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "power_limit": _power_limit(), "torch": torch.__version__,
           "empty_loop_us": _per_span_us(_empty, N),
           "off_us": _per_span_us(_spans(False), N),
           "off_device_us": _per_span_us(_spans(True), N)}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for device in (False, True):
        tracing.take()
        with torch.profiler.profile(activities=acts) as prof:
            on = _per_span_us(_spans(device), N_ON)
        t = time.perf_counter()
        spans = tracing.take()
        take_us = (time.perf_counter() - t) / max(len(spans), 1) * 1e6
        starts = sorted(e.start_ns() for e in
                        prof.profiler.kineto_results.events()
                        if e.name() == "profile_tracing.span"
                        and e.device_type() != torch.autograd.DeviceType.CUDA)
        mine = sorted(s.start_ns for s in spans)
        gaps = [abs(a - b) / 1e3 for a, b in zip(starts, mine)]
        key = "on_device" if device else "on"
        out[key + "_us"] = on
        out[key + "_take_us"] = take_us
        out[key + "_spans"] = len(spans)
        out[key + "_events"] = len(starts)
        out[key + "_start_gap_us"] = {
            "median": statistics.median(gaps) if gaps else None,
            "max": max(gaps) if gaps else None}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
