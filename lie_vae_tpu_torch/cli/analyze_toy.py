"""Toy-experiment analysis: train toy models and evaluate the paper's
latent-space diagnostics, ``python -m lie_vae_tpu_torch.cli.analyze_toy``.

Counterpart of the JAX package's ``scripts/analyze_toy.py`` (the
scriptable equivalent of the reference's toy_results.ipynb): the
{ae, vae} x {action, mlp} x latent matrix (:data:`CONFIGS`), each config
trained on the toy set with the ground-truth spectrum fixed (or learned,
``--no-fixed_spectrum``), then evaluated: test recon, the encoder
discontinuity along a circle and a random walk in SO(3), their PCA
projections, the encoded-pose strip along the circle (the notebook's
``render_axes`` figure, cell 13, by the port's renderer) and, for
rotation-interpretable latents with the spectrum fixed, the coverage of
the geodesic pose error.

:func:`train_config` is the training half and :func:`evaluate_config` the
evaluation half, which takes a trained model (so that it can be held
against the JAX package's analysis at the same weights). The random walk's
noise comes from a ``torch.Generator`` seeded 7, or ``eps=``.

Outputs (``--out_dir``, default ``outputs/toy-analysis``, git-ignored):
``results.json`` (the metrics per config), ``arrays.npz`` (per config the
PCA projections of both trajectories and the encoded-pose strip) and
``TOY_RESULTS.md`` (the summary table). No figures are drawn: the card's
machine has no matplotlib. ``--kernel_impl`` picks the Wigner kernels on
the card: 'fused' (K1/K2) or 'pallas' (K5/K6). Usage::

    python -m lie_vae_tpu_torch.cli.analyze_toy --epochs 200 --configs all
"""
import argparse
import json
import os

import numpy as np
import torch

from lie_vae_tpu_torch import analysis, ops
from lie_vae_tpu_torch.data import ToyDataset, random_split
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.train import ConstantSchedule, UnsupervisedExperiment

OUT_DIR = os.path.join("outputs", "toy-analysis")
N_TRAJ = 200
WALK_STEP = 0.08
WALK_SEED = 7
POSE_ITEMS = 512


# The paper's toy model matrix (toy_results.ipynb cell 4 loads
# {ae,vae} x {action,mlp} x {q,alg,s2s2,s2s1,normal3,normal30,vmf,vmfq}
# checkpoints); built programmatically below.
def _toy_matrix():
    latents = {
        "alg": dict(latent_mode="so3", mean_mode="alg"),
        "q": dict(latent_mode="so3", mean_mode="q"),
        "s2s1": dict(latent_mode="so3", mean_mode="s2s1"),
        "s2s2": dict(latent_mode="so3", mean_mode="s2s2"),
        "normal3": dict(latent_mode="normal", normal_dims=3),
        "normal30": dict(latent_mode="normal", normal_dims=30),
        "vmf": dict(latent_mode="vmf"),
        "vmfq": dict(latent_mode="vmfq"),
    }
    configs = {}
    for kind, deterministic in (("ae", True), ("vae", False)):
        # action decoder: the group latents and the decodable vector
        # latents (normal at 3 dims through the Euler chart, vmfq through
        # the quaternion chart; plain vmf has no action path)
        for lname in ("alg", "q", "s2s1", "s2s2", "normal3", "vmfq"):
            configs[f"{kind}-action-{lname}"] = dict(
                decoder_mode="action", deterministic=deterministic,
                **latents[lname])
        # mlp decoder: everything
        for lname in ("s2s2", "normal3", "normal30", "vmf", "vmfq"):
            configs[f"{kind}-mlp-{lname}"] = dict(
                decoder_mode="mlp", deterministic=deterministic,
                **latents[lname])
    return configs


CONFIGS = _toy_matrix()
# the six configs the quick-start exercises, kept as the default subset
DEFAULT_CONFIGS = ["ae-action-s2s2", "ae-action-alg", "ae-action-q",
                   "ae-action-s2s1", "ae-mlp-normal3", "vae-action-s2s2"]


def toy_model(cfg, ds, args):
    """The toy LieVAE of config ``cfg`` (a :data:`CONFIGS` entry) on
    ``args.device``, the spectrum ``ds.harmonics`` fixed unless
    ``args.fixed_spectrum`` is off."""
    return LieVAE(encode_mode="toy", deconv_mode="toy",
                  degrees=args.degrees, rep_copies=args.rep_copies,
                  fixed_item_rep=(ds.harmonics if args.fixed_spectrum
                                  else None),
                  kernel_impl=args.kernel_impl, device=args.device, **cfg)


def train_config(cfg, ds, train, valid, args):
    """The training half: the config's model trained for ``args.epochs``
    epochs (batch 64, lr 1e-3, no clip, beta 0 for an autoencoder and 1
    otherwise); returns the experiment (its ``model`` trained)."""
    exp = UnsupervisedExperiment(
        model=toy_model(cfg, ds, args), train_dataset=train,
        test_dataset=valid,
        beta_schedule=ConstantSchedule(0.0 if cfg.get("deterministic")
                                       else 1.0),
        batch_size=64, report_freq=10 ** 9, lr=1e-3, clip_grads=None,
        steps_per_call=args.steps_per_call)
    for epoch in range(args.epochs):
        exp.train(epoch)
    return exp


def rotation_latent(cfg):
    """Whether the config's latent reads as a rotation (so3, vmfq, a
    3-dim normal)."""
    mode = cfg["latent_mode"]
    return mode in ("so3", "vmfq") or (mode == "normal"
                                       and cfg.get("normal_dims") == 3)


def evaluate_config(cfg, model, ds, valid, args, eps=None):
    """The evaluation half on a trained ``model``: the discontinuity
    summary and the PCA projections of the posterior-mean encodings along
    a circle and a random walk of ``N_TRAJ`` poses (its standard normal
    increments ``eps`` (N_TRAJ, 3), else drawn from a generator seeded
    ``WALK_SEED``), for a rotation latent the encoded-pose strip along the
    circle (12 frames aligned to its start) and, with the spectrum fixed,
    the geodesic pose error on the first ``POSE_ITEMS`` validation items.
    Returns (the metrics, the arrays)."""
    if eps is None:
        eps = torch.randn((N_TRAJ, 3),
                          generator=torch.Generator().manual_seed(WALK_SEED))
    results, arrays = {}, {}
    impl = "fused" if args.kernel_impl == "auto" else args.kernel_impl
    device = next(model.parameters()).device
    for traj_name, traj in [
            ("circle", analysis.circle_trajectory(N_TRAJ)),
            ("random_walk", analysis.random_walk_trajectory(
                N_TRAJ, step=WALK_STEP, eps=eps))]:
        with torch.no_grad():
            xs = analysis.toy_inputs_for_trajectory(
                traj.to(device), ds.harmonics, args.degrees,
                impl=impl).cpu().numpy()
        enc = analysis.encode_dataset(model, xs)
        _, summary = analysis.discontinuity_score(enc)
        results[f"discontinuity_{traj_name}"] = summary
        arrays[f"{traj_name}_pca"] = analysis.pca(enc)[0]
        if traj_name == "circle" and rotation_latent(cfg):
            # encoded-pose strip (toy_results.ipynb cell 13): the object
            # at the encoder's poses, aligned to the trajectory start, so
            # latent-space discontinuities show as pose jumps
            mats = analysis.encodings_to_group_matrices(
                enc, cfg["latent_mode"]).numpy()
            idx = np.linspace(0, len(enc) - 1, 12).astype(int)
            arrays["encoded_poses"] = analysis.render_encoded_poses(
                mats[idx], size=64, align_to=traj[0].numpy())

    # absolute pose recovery (rotation latents with the ground-truth
    # spectrum fixed): the pose is identifiable, so the geodesic angle to
    # the generating rotation is a scale-free accuracy metric; the
    # posterior mean is evaluated (encode_dataset is deterministic)
    if args.fixed_spectrum and rotation_latent(cfg):
        q, _, x = valid.gather(np.arange(min(len(valid), POSE_ITEMS)))
        enc = analysis.encode_dataset(model, x)
        r_hat = analysis.encodings_to_group_matrices(
            enc, cfg["latent_mode"]).numpy()
        r_true = ops.quaternions_to_group_matrix(
            torch.as_tensor(np.asarray(q))).numpy()
        rel_tr = np.einsum("bij,bij->b", r_hat, r_true)   # tr(R_hat R^T)
        ang = np.degrees(np.arccos(np.clip((rel_tr - 1.0) / 2.0, -1.0,
                                           1.0)))
        # bimodal: a recovered pose (~0 deg) or the 180-degree flip local
        # minima of SO(3) registration; report coverage
        results["pose_err_deg"] = {
            "median": float(np.median(ang)),
            "mean": float(np.mean(ang)),
            "frac_within_10deg": float(np.mean(ang <= 10.0)),
            "frac_near_flip": float(np.mean(ang >= 170.0))}
    return results, arrays


def run_config(name, cfg, ds, train, valid, args):
    """Train the config, then evaluate it: the metrics (``test_recon``
    first), and the arrays."""
    exp = train_config(cfg, ds, train, valid, args)
    results = {"test_recon": float(exp.test()[0])}
    metrics, arrays = evaluate_config(cfg, exp.model, ds, valid, args)
    results.update(metrics)
    return results, arrays


def toy_split(ds, n):
    """The JAX driver's split: an eighth each for validation and test."""
    nv = n // 8
    valid, _, train = random_split(ds, [nv, nv, n - 2 * nv])
    return train, valid


def summary_table(all_results, args):
    """The markdown summary (the notebook's recon + discontinuity view)."""
    lines = [
        "# Toy experiment matrix — recon + encoder discontinuity",
        "",
        f"{args.epochs} epochs, degrees={args.degrees}, "
        f"rep_copies={args.rep_copies}, n={args.n_data}, "
        f"fixed_spectrum={args.fixed_spectrum}, "
        f"kernel_impl={args.kernel_impl}, device={args.device}. "
        "Discontinuity = per-step squared encoding jumps along SO(3) "
        "trajectories (toy_results.ipynb cells 3+14); outliers = jumps "
        ">10x median. Pose coverage (rotation-interpretable latents under "
        "a fixed ground-truth spectrum, where the pose is identifiable) = "
        "fraction of validation poses recovered within 10 deg / fraction "
        "stuck at the 180-deg flip local minima of SO(3) registration.",
        "",
        "| config | test recon | pose cov. <=10 deg / flips "
        "| circle: mean / max / outliers "
        "| walk: mean / max / outliers |",
        "|---|---|---|---|---|",
    ]
    for name, r in all_results.items():
        c = r["discontinuity_circle"]
        w = r["discontinuity_random_walk"]
        p = r.get("pose_err_deg")
        pe = (f"{100 * p['frac_within_10deg']:.0f}% / "
              f"{100 * p['frac_near_flip']:.0f}%" if p else "—")
        lines.append(
            f"| {name} | {r['test_recon']:.3f} | {pe} "
            f"| {c['mean']:.3g} / {c['max']:.3g} / {c['num_outliers']} "
            f"| {w['mean']:.3g} / {w['max']:.3g} / {w['num_outliers']} |")
    return "\n".join(lines) + "\n"


def parse_args(argv=None):
    p = argparse.ArgumentParser("analyze_toy")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--degrees", type=int, default=3)
    p.add_argument("--rep_copies", type=int, default=4)
    p.add_argument("--n_data", type=int, default=1024)
    p.add_argument("--fixed_spectrum", action=argparse.BooleanOptionalAction,
                   default=True, help="--no-fixed_spectrum trains learned "
                                      "item representations")
    p.add_argument("--steps_per_call", type=int, default=8)
    p.add_argument("--out_dir", default=OUT_DIR)
    p.add_argument("--configs", nargs="*", default=DEFAULT_CONFIGS,
                   help="config names, or 'all' for the paper's full "
                        "{ae,vae} x {action,mlp} x latent matrix")
    p.add_argument("--kernel_impl", default="fused",
                   choices=["fused", "pallas", "auto", "xla"])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N, cpu)")
    args = p.parse_args(argv)
    if args.configs == ["all"]:
        args.configs = list(CONFIGS)
    unknown = [c for c in args.configs if c not in CONFIGS]
    if unknown:
        p.error(f"unknown configs {unknown}")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available (pass "
                         "--device cpu to run on the CPU)")
    os.makedirs(args.out_dir, exist_ok=True)
    ds = ToyDataset.generate(n=args.n_data, degrees=args.degrees,
                             rep_copies=args.rep_copies, device=args.device)
    train, valid = toy_split(ds, args.n_data)

    all_results, all_arrays = {}, {}
    for name in args.configs:
        print(f"== {name}")
        all_results[name], arrays = run_config(name, CONFIGS[name], ds,
                                               train, valid, args)
        all_arrays.update({f"{name}/{k}": v for k, v in arrays.items()})
        print(json.dumps(all_results[name], indent=2))

    with open(os.path.join(args.out_dir, "results.json"), "w") as f:
        json.dump(all_results, f, indent=2)
    np.savez(os.path.join(args.out_dir, "arrays.npz"), **all_arrays)
    md = os.path.join(args.out_dir, "TOY_RESULTS.md")
    with open(md, "w") as f:
        f.write(summary_table(all_results, args))
    print(f"Wrote {args.out_dir}/results.json, arrays.npz and {md}")
    return all_results


if __name__ == "__main__":
    main()
