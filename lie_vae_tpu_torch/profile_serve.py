"""Where a serving request's time goes on the card.

    python -m lie_vae_tpu_torch.profile_serve [--reps 20]

Serves the flagship model with the converged reference weights
(``converged_state/torch_clean/best.pt``) at batch 64 on the first CUDA
device, profiles ``reps`` requests each of ``encode``, ``decode`` and
``reconstruct`` with ``torch.profiler``, and prints for each: the host
milliseconds per request, the device's busy share of that time (kernels
and copies, overlaps merged), and the device time per request of the
costliest kernels and of the Wigner chain kernel. Then it profiles the
Wigner chain kernel alone at B = 64 and B = 4096. Float32 throughout, in
IEEE float32 (``precision.ieee_float32``, as the session itself runs). The
trace files go to ``build/profile/``.
"""
import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from lie_vae_tpu_torch.models import flagship_model
from lie_vae_tpu_torch.ops import group_matrix_to_eazyz, random_group_matrices
from lie_vae_tpu_torch.ops.kernels import block_wigner_matrix_multiply_fused
from lie_vae_tpu_torch.precision import ieee_float32
from lie_vae_tpu_torch.serve import InferenceSession

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _busy_us(events):
    """Microseconds covered by the union of the events' intervals."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, -float("inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def device_us(fn, launches=20, replays=20):
    """Median over ``replays`` of the device µs per call of ``fn``: a warm-up
    call, then ``launches`` calls captured in one CUDA graph, whose replays
    are timed with CUDA events (the host's enqueue drops out)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(1e3 * start.elapsed_time(end) / launches)
    return statistics.median(times)


def profile_request(name, fn, reps, out_dir, unit="request of 64",
                    watch=("wigner_chain",)):
    """Profile ``reps`` calls of ``fn``; print host ms per call, the
    device's busy share, and the device us per call of the 8 costliest
    device items and of every item whose name holds one of ``watch``.
    Returns ({item name: device us per call}, {"host_ms", "busy_ms",
    "events"} per call)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    path = os.path.join(out_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("cat") in _DEVICE_CATS and "dur" in e]
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy = _busy_us(events)
    print(f"{name}: {wall_us / reps / 1e3:.4f} ms per {unit} (host), "
          f"device busy {busy / reps / 1e3:.4f} ms = "
          f"{100 * busy / wall_us:.1f}% of it, {len(events) / reps:.0f} "
          f"device events per {unit}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for kname, dur in ranked[:8] + [kv for kv in ranked[8:]
                                    if any(w in kv[0] for w in watch)]:
        print(f"    {dur / reps:9.2f} us  {kname[:100]}")
    return ({k: v / reps for k, v in by_name.items()},
            {"host_ms": wall_us / reps / 1e3, "busy_ms": busy / reps / 1e3,
             "events": len(events) / reps})


@ieee_float32()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    out_dir = os.path.join(_ROOT, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    sess = InferenceSession.from_torch(
        os.path.join(_ROOT, "converged_state", "torch_clean", "best.pt"),
        flagship_model(), batch_size=64).warmup()
    imgs = sess.sample(64, seed=0)
    poses = np.asarray(sess.encode(imgs)["pose"])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(),
          f"torch {torch.__version__}")
    for name, fn in (("encode", lambda: sess.encode(imgs)),
                     ("decode", lambda: sess.decode(poses)),
                     ("reconstruct", lambda: sess.reconstruct(imgs))):
        profile_request(name, fn, args.reps, out_dir)
    gen = torch.Generator().manual_seed(0)
    item_rep = torch.randn((49, 10), generator=gen).cuda()
    for B in (64, 4096):
        angles = group_matrix_to_eazyz(random_group_matrices(
            B, generator=gen, device="cpu").cuda()).contiguous()
        with torch.inference_mode():
            profile_request(
                f"wigner_chain_B{B}",
                lambda: block_wigner_matrix_multiply_fused(angles, item_rep, 6),
                args.reps, out_dir, unit="launch")


if __name__ == "__main__":
    main()
