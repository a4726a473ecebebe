"""The readings that a cell's limits are set from, on the card at the
cell's own size, one JSON line a seed:

- ``program``: the numbers of the program against the reference (the
  lower reading is their largest over a dozen seeds or more);
- ``control``: the reference put in the program's place in the nearest
  precision below the configuration's (TF32 convolutions and matmuls for
  IEEE float32; the upper reading is the smallest of these);
- faults planted in the reference put in the program's place: training's
  ``half_batch`` (half of each batch left out, the mean taken over the
  rest); serving's ``altered`` (0.1 added to every pixel of one
  answer's first image). A state left unchanged reads 1 on ``change_gap`` by its
  definition and needs no run.

    python3 -m port_bench.calibrate --workload flagship-train \\
        --seeds 11 12 13 ... [--seconds 2]

Training needs no window; serving runs a short one at the cell's load
for each seed (one session built once, each seed's pool rendered anew).
"""
import argparse
import json
import sys

import torch

from port_bench.harness import check
from port_bench.harness.spec import Bench


def _halved(batches, steps):
    out_b, out_s = [], []
    for x, s in zip(batches, steps):
        h = x.shape[0] // 2
        out_b.append(x[:h])
        cut = dict(s, eps=s["eps"][:, :h])
        if "theta" in s:
            cut.update(theta=s["theta"][:h], eq_eps=s["eq_eps"][:, :h])
        out_s.append(cut)
    return out_b, out_s


def train_readings(bench, workload, seed, device="cuda", faults=True):
    from port_bench.harness.train import TrainRun, readings
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    module = bench.reference(config["reference"])
    r = TrainRun(config, bench.traffic(cell["traffic"]), seed, device)
    program = r.first_steps()
    r.free()
    ref = r.reference(module, "ieee")
    out = {"seed": seed, "program": check.train_numbers(program, ref),
           "losses": {"program": program["losses"],
                      "reference": ref["losses"]},
           "terms": ref["parts"][0],
           "worst": check.worst_leaves(program, ref)}
    if faults:
        control = r.reference(module, "tf32")
        out["control"] = check.train_numbers(control, ref)
        out["losses"]["control"] = control["losses"]
        out["worst_control"] = check.worst_leaves(control, ref)
        batches, steps = _halved(*r.reference_inputs())
        with module.precision("ieee"):
            half = module.train_steps(r.init, batches, steps,
                                      config["model"], config["train"])
        out["half_batch"] = check.train_numbers(readings(half, r.init), ref)
    return out


def serve_readings(bench, workload, seeds, seconds, device="cuda"):
    from port_bench.harness.serve import ServeRun
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    module = bench.reference(config["reference"])
    r = ServeRun(bench.root, config, bench.traffic(cell["traffic"]),
                 seeds[0], device)
    rows = []
    for seed in seeds:
        r.load_requests(seed)
        r.window(seconds)
        ref = r.reference(module, "ieee")
        got = [o for _, o in r.sample]
        altered = [o.copy() for o in got]
        altered[0][0] += 0.1
        rows.append({"seed": seed, "requests": len(r.sample),
                     "program": check.serve_numbers(got, ref),
                     "control": check.serve_numbers(
                         r.reference(module, "tf32"), ref),
                     "altered": check.serve_numbers(altered, ref)})
    r.free()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program_only", action="store_true",
                   help="training: the program's readings alone")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = Bench()
    kind = bench.traffic(bench.cell(args.workload)["traffic"])["kind"]
    if kind == "serve":
        rows = serve_readings(bench, args.workload, args.seeds, args.seconds)
    else:
        rows = (train_readings(bench, args.workload, s,
                               faults=not args.program_only)
                for s in args.seeds)
    for row in rows:
        print(json.dumps(dict(row, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
