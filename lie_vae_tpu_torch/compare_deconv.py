"""The decoder's transposed convolutions on the port's path against
``F.conv_transpose2d``, on one card.

    python -m lie_vae_tpu_torch.compare_deconv [--batch 512] [--calls 10]
        [--trials 5] [--dtype float32|bfloat16] [--json PATH]

For each of the flagship decoder's five layers (``decoder.deconv.1``: 490
-> 200 channels, 1x1 -> 4x4, k4 s1 p0; ``deconv.3``/``.5``/``.7``: 200 ->
200, k4 s2 p1 from 4x4, 8x8 and 16x16; ``deconv.9``: the 200 -> 3 image
head, 32x32 -> 64x64) it times, at the batch's shapes in the dtype (IEEE
float32 by default), the forward, the input gradient (dx) and the weight
gradient (dw) of two routes, in turns:

- ``transpose``: ``F.conv_transpose2d`` on an NCHW input, the bias inside;
- ``port``: the port's own layer (``nets.ConvTranspose2d._product``),
  each pass by the route its shape and dtype pick.

A pass's time is the median over ``trials`` of CUDA events around
``calls`` calls, over the calls; its rate is the layer's operations (2
C_in C_out k^2 H_in W_in a image, as ``port_bench/harness/counts.py``
counts them) over that time, against the 67 TFLOP/s float32 peak, after a
second of matrix products has brought the clocks up. The port's output,
dx and dw are held against ``transpose``'s (relative to the largest
entry), and one profiled call of each pass names the device kernels it
ran, with their µs. The card's name and power limit come first; the JSON
record of every row goes to ``--json`` (else to the last line).
"""
import argparse
import json
import subprocess
import time

import torch
import torch.nn.functional as F

from lie_vae_tpu_torch.models import nets
from lie_vae_tpu_torch.precision import ieee_float32
from lie_vae_tpu_torch.profile_train import PEAK, kernels, passes, time_ms

# (name, C_in, C_out, H_in, kernel, stride, padding) of the flagship decoder
LAYERS = (("deconv.1", 490, 200, 1, 4, 1, 0),
          ("deconv.3", 200, 200, 4, 4, 2, 1),
          ("deconv.5", 200, 200, 8, 4, 2, 1),
          ("deconv.7", 200, 200, 16, 4, 2, 1),
          ("deconv.9", 200, 3, 32, 4, 2, 1))


def routes(stride, padding):
    """{route name: fn(x, w, b)} for a layer: ``F.conv_transpose2d`` and
    the port's own."""
    port = nets.ConvTranspose2d(1, 1, 4, stride, padding)
    return {"transpose": lambda x, w, b: F.conv_transpose2d(
                x, w, b, stride, padding),
            "port": port._product}


def _gap(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


@ieee_float32()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_deconv needs a CUDA device")
    dtype = getattr(torch, args.dtype)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(),
          f"torch {torch.__version__}, {args.dtype}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm = torch.randn((4096, 4096), device="cuda", generator=gen)
    t_warm = time.perf_counter()    # a second of work: the clocks up first
    while time.perf_counter() - t_warm < 1.0:
        warm @ warm
        torch.cuda.synchronize()
    record = []
    for name, c_in, c_out, h, k, stride, pad in LAYERS:
        flops = 2.0 * c_in * c_out * k * k * h * h * args.batch
        x = torch.randn((args.batch, c_in, h, h), device="cuda",
                        generator=gen).to(dtype)
        w = (torch.randn((c_in, c_out, k, k), device="cuda", generator=gen)
             / (c_in * 4) ** 0.5).to(dtype)
        b = torch.randn((c_out,), device="cuda", generator=gen).to(dtype)
        ref = None
        for route, fn in routes(stride, pad).items():
            torch.manual_seed(0)
            calls = passes(fn, x, w, b)
            outs = {p: c().float() for p, c in calls.items()}
            if ref is None:
                ref = outs
            for p, c in calls.items():
                ms = time_ms(c, args.calls, args.trials)
                names = kernels(c)
                row = {"layer": name, "route": route, "dtype": args.dtype,
                       "pass": p, "ms": ms, "tflops": flops / ms / 1e9,
                       "peak_pct": 100 * flops / ms / 1e-3 / PEAK,
                       "gap": _gap(outs[p], ref[p]), "kernels": names}
                record.append(row)
                top = sorted(names.items(), key=lambda kv: -kv[1])
                print(f"{name:9s} {route:9s} {p:7s} {ms:8.4f} ms "
                      f"{row['tflops']:6.2f} TFLOP/s {row['peak_pct']:5.1f}%"
                      f" gap {row['gap']:.1e} | " + "; ".join(
                          f"{n[:60]} {us:.0f}" for n, us in top[:3]))
            del calls, outs
        del x, w, b, ref
        torch.cuda.empty_cache()
    line = json.dumps({"compare_deconv": record})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    else:
        print(line)


if __name__ == "__main__":
    main()
