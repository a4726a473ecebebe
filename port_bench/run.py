"""Run one cell of the benchmark of ``lie_vae_tpu_torch`` on this machine's
cards and print its result line.

    python3 -m port_bench.run --workload flagship-train --seed 7 \\
        --seconds 20 --trace 0

from the root of a checkout. The cell, its configuration, its traffic mix,
its limits and its metrics are found by name from ``BENCHMARK.json``
(``harness/spec.py``). ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` runs the same window, then a short window under
``torch.profiler``, and reports its per-layer metrics. Every run compares
what the timed path produced with the plain reference, after the window.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, and when ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""
import argparse
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "lie_vae_tpu")


def _caches(root):
    """Build and kernel caches at fixed directories inside the checkout."""
    base = os.path.join(root, "build", "port_bench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    from port_bench.harness.spec import Bench
    bench = Bench()
    _caches(bench.root)
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from port_bench.harness import check, record
    kind = bench.traffic(cell["traffic"])["kind"]
    if kind == "train":
        from port_bench.harness import train as runner
    elif kind == "serve":
        from port_bench.harness import serve as runner
    else:
        raise ValueError(f"no runner for traffic kind {kind!r}")
    fields, ctx, numbers = runner.run(bench, cell, args.seed, args.seconds,
                                      bool(args.trace))
    print("port_bench: set-up phases (s) " + " ".join(
        f"{k} {v:.3f}" for k, v in fields["setup_phases"].items())
        + f"; to the window {ctx.setup_s:.2f}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"port_bench: the process loaded {found}", file=sys.stderr)
        return 3
    correct, checks = check.judge(numbers, bench.limits(args.workload))
    metrics = {}
    for m in bench.metrics(args.workload, bool(args.trace)):
        value = bench.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = record.device_info(cell["chips"], ctx.trace)
    device["memory_peak_bytes"] = int(fields["memory"])
    result = {"correct": correct, "attempted": fields["attempted"],
              "failed": fields["failed"], "metrics": metrics,
              "device": device, "power_limit": record.power_limit()}
    if ctx.trace is not None:
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    record.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
