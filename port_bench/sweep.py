"""Find the knee of a serving cell once, by a sweep on the card: one
set-up, then a closed loop (one client: the highest rate one server
sustains) and open loops at fractions of that rate, each for
``--seconds``, printing one JSON line a load.

    python3 -m port_bench.sweep --workload flagship-serve_peak --seed 3 \\
        --seconds 8 --fractions 0.5 0.7 0.8 0.9 1.0 1.1

The cell's traffic then offers a fixed rate (``rate_per_s``); the
benchmark's runs do not search for one.
"""
import argparse
import json
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--fractions", type=float, nargs="*",
                   default=[0.5, 0.7, 0.8, 0.9, 1.0])
    p.add_argument("--arrivals", default="poisson")
    args = p.parse_args(argv)
    from port_bench.harness.spec import Bench
    from port_bench.harness.serve import ServeRun
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    bench = Bench()
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    traffic = dict(bench.traffic(cell["traffic"]), arrivals="closed")
    r = ServeRun(bench.root, config, traffic, args.seed, "cuda")
    n = traffic["images_per_request"]

    def load(name, **over):
        r.traffic = dict(traffic, **over)
        window, lat, service = r.window(args.seconds)
        out = {"load": name, "requests": len(lat),
               "images_per_s": len(lat) * n / window,
               "p50_ms": 1e3 * float(np.percentile(lat, 50)),
               "p95_ms": 1e3 * float(np.percentile(lat, 95)),
               "p99_ms": 1e3 * float(np.percentile(lat, 99)),
               "service_p50_ms": 1e3 * float(np.percentile(service, 50)),
               "rate_per_s": over.get("rate_per_s")}
        print(json.dumps(out), flush=True)
        return out

    knee = load("closed")["images_per_s"] / n
    for f in args.fractions:
        load(f"{args.arrivals} x{f}", arrivals=args.arrivals,
             rate_per_s=f * knee, arrival_seed=0)
    r.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
