"""Degree-scaling study on the toy task,
``python -m lie_vae_tpu_torch.cli.run_degree_sweep``.

Counterpart of the JAX package's ``scripts/run_degree_sweep.py``. The paper
fixes the Wigner degree at L = 6 for images and L = 3 for the toy matrix;
the kernels carry degrees up to 16. For each L this regenerates the toy
set with the operator the action decoder applies (on the card the Wigner
chain kernel K1), trains the s2s2-chart action model with the ground-truth
spectrum fixed (the pose-recovery task; training runs K2, or K5/K6 with
``--kernel_impl pallas``) and evaluates it as ``cli.analyze_toy`` does:
test recon, pose coverage and the encoder's discontinuity.

Reading the result: raw recon is not comparable across L (the spectrum has
norm 10 at every degree and high-l blocks decorrelate faster under
rotation); the scale-free column is pose coverage, the fraction of
validation poses recovered within 10 degrees and the fraction stuck at the
180-degree flips of SO(3) registration.

Writes ``results.json`` into ``--out_dir`` (default
``outputs/degree-sweep``, git-ignored) after every L, and merges a marker
table into ``--out`` (default ``<out_dir>/TOY_RESULTS.md``). Usage::

    python -m lie_vae_tpu_torch.cli.run_degree_sweep [--degrees 2 4 6 8 10]
"""
import argparse
import json
import os
import time

import torch

from lie_vae_tpu_torch.cli import analyze_toy
from lie_vae_tpu_torch.cli._results_table import merge_marker_table
from lie_vae_tpu_torch.data import ToyDataset

BEGIN, END = "<!-- degree-sweep:begin -->", "<!-- degree-sweep:end -->"
OUT_DIR = os.path.join("outputs", "degree-sweep")
# ae = the pure pose-recovery landscape; vae = the same task with
# sampling noise on the algebra
SERIES = ["ae-action-s2s2", "vae-action-s2s2"]


def _label(config, L):
    dim = (L + 1) ** 2
    return (f"L={L} ({dim})" if config == "ae-action-s2s2"
            else f"vae, L={L} ({dim})")


def _row(desc, r):
    c, w = r["discontinuity_circle"], r["discontinuity_random_walk"]
    p = r.get("pose_err_deg")
    pe = (f"{100 * p['frac_within_10deg']:.0f}% / "
          f"{100 * p['frac_near_flip']:.0f}%" if p else "—")
    return (f"| {desc} | {r['test_recon']:.3f} | {pe} "
            f"| {c['mean']:.3g} / {c['max']:.3g} "
            f"| {w['mean']:.3g} / {w['max']:.3g} | {r['train_s']} |")


def parse_args(argv=None):
    p = argparse.ArgumentParser("run_degree_sweep")
    p.add_argument("--degrees", type=int, nargs="*", default=[2, 4, 6, 8, 10])
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--rep_copies", type=int, default=4)
    p.add_argument("--n_data", type=int, default=1024)
    p.add_argument("--steps_per_call", type=int, default=8)
    p.add_argument("--out_dir", default=OUT_DIR)
    p.add_argument("--out", default=None,
                   help="the markdown file the table merges into (default "
                        "<out_dir>/TOY_RESULTS.md)")
    p.add_argument("--configs", nargs="*", default=SERIES[:1],
                   choices=SERIES)
    p.add_argument("--kernel_impl", default="fused",
                   choices=["fused", "pallas", "auto", "xla"])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N, cpu)")
    args = p.parse_args(argv)
    if args.out is None:
        args.out = os.path.join(args.out_dir, "TOY_RESULTS.md")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available (pass "
                         "--device cpu to run on the CPU)")
    os.makedirs(args.out_dir, exist_ok=True)
    results = {}
    for config in args.configs:
        for L in args.degrees:
            name = f"{config}-L{L}"
            print(f"== {name} (spectrum dim {(L + 1) ** 2})")
            ds = ToyDataset.generate(n=args.n_data, degrees=L,
                                     rep_copies=args.rep_copies,
                                     device=args.device)
            train, valid = analyze_toy.toy_split(ds, args.n_data)
            run_args = argparse.Namespace(
                degrees=L, rep_copies=args.rep_copies, fixed_spectrum=True,
                steps_per_call=args.steps_per_call, epochs=args.epochs,
                kernel_impl=args.kernel_impl, device=args.device)
            t0 = time.perf_counter()
            r, _ = analyze_toy.run_config(name, analyze_toy.CONFIGS[config],
                                          ds, train, valid, run_args)
            r["train_s"] = round(time.perf_counter() - t0, 1)
            results[(config, L)] = r
            print(json.dumps(r, indent=2))
            with open(os.path.join(args.out_dir, "results.json"), "w") as f:
                json.dump({f"{c}-L{l}": v
                           for (c, l), v in results.items()}, f, indent=2)

    merge_marker_table(
        args.out, BEGIN, END,
        caption=(
            "s2s2 action models with the ground-truth spectrum fixed vs "
            "Wigner degree; plain rows = deterministic AE (the pose-recovery "
            "landscape), vae rows = the same task with algebra sampling "
            "noise (`python -m lie_vae_tpu_torch.cli.run_degree_sweep`; "
            f"{args.epochs} epochs, rep_copies={args.rep_copies}, "
            f"n={args.n_data}, kernel_impl={args.kernel_impl}, "
            f"device={args.device}). Raw recon is not comparable across L; "
            "pose coverage is the fraction within 10 deg / the fraction at "
            "a 180-deg flip; s is the seconds of training and evaluation."),
        header=("| degree L (spectrum dim) | test recon "
                "| pose cov. <=10 deg / flips "
                "| circle disc. mean / max | walk disc. mean / max | s |"),
        descriptions={(c, L): _label(c, L)
                      for c in SERIES for L in args.degrees},
        results=results, format_row=_row,
        section_title="Degree scaling (toy pose recovery)")
    print(f"merged degree-sweep table into {args.out}")
    return results


if __name__ == "__main__":
    main()
