"""Image-scale latent-space analysis of one sphere-cube checkpoint.

    python -m lie_vae_tpu_torch.cli.analyze_spherecube \\
        (--checkpoint PATH | --torch_checkpoint PATH) [--n_traj 200] \\
        [--out_dir DIR] [--style v1|v2] <cli.main model flags>

Counterpart of the JAX package's ``scripts/analyze_spherecube.py`` (which
loops over the latent-matrix checkpoints) for one checkpoint: the
notebook's PCA, discontinuity and encoded-pose figures (toy_results.ipynb
cells 11-14) at the scale the paper shows, 64x64 sphere-cube images.

1. renders two pose trajectories of ``--n_traj`` poses with the native
   renderer: a full turn about the axis (0.3, 0.5, 0.81) and a random walk
   of step 0.08 (its increments from a CPU ``torch.Generator`` seeded 7),
   and encodes them on the posterior-mean path (``analysis``);
2. computes the encoder-discontinuity metric along each (the paper's
   continuity evaluation) and the encodings' PCA projections;
3. for a rotation-interpretable latent (so3, vmfq, 3-dim normal) renders
   the poses the encoder assigns to 10 frames of the circle, beside the
   inputs (``encoded_poses.png``);
4. reconstructs 10 frames of the circle beside the inputs (``recon.png``)
   and the mean reconstruction error of the whole circle.

It writes ``spherecube_results.json`` (the summaries, the PCA projections,
the reconstruction errors) and ``SPHERECUBE_ANALYSIS.md`` into
``--out_dir``, the strips as PNG files (``data/png.py``). The JAX script's
PCA scatter figures need matplotlib, which the port does without: their
projections are in the JSON.

The model is built from ``cli.main``'s flags with the sphere-cube's conv
encoder and RGB images; ``--checkpoint`` is a ``cli.main`` checkpoint.pt,
``--torch_checkpoint`` a reference state_dict (e.g.
``converged_state/torch_clean/best.pt`` with the flagship's defaults).
"""
import argparse
import json
import os
import types

import numpy as np
import torch

from lie_vae_tpu_torch import analysis
from lie_vae_tpu_torch.cli import main as cli
from lie_vae_tpu_torch.data.png import write_png
from lie_vae_tpu_torch.data.render import render_spherecube
from lie_vae_tpu_torch.precision import ieee_float32

CIRCLE_AXIS = (0.3, 0.5, 0.81)
WALK_STEP = 0.08
WALK_SEED = 7
FRAMES = 10


def load_model(args, checkpoint=None):
    """The model of the parsed ``cli.main`` flags ``args`` with the
    checkpoint's weights, and the checkpoint's step (None for a reference
    state_dict)."""
    if args.dataset == "toy":
        raise SystemExit("analyze_spherecube analyses an image model: "
                         "--dataset spherecube or sc-pairs")
    model = cli.build_model(args, types.SimpleNamespace(rgb=True), None)
    if args.torch_checkpoint:
        from lie_vae_tpu_torch.compat import load_torch
        model.load_state_dict(load_torch(args.torch_checkpoint), strict=True)
        return model, None
    if checkpoint is None:
        raise SystemExit("name the checkpoint: --checkpoint or "
                         "--torch_checkpoint")
    from lie_vae_tpu_torch.train.checkpoint import load_checkpoint
    ckpt = load_checkpoint(checkpoint)
    model.load_state_dict(ckpt["model"], strict=True)
    return model, int(ckpt["step"])


@torch.no_grad()
@ieee_float32()
def recon_strip(model, xs, n_frames=FRAMES):
    """(inputs, reconstructions) of ``n_frames`` evenly spaced frames of a
    trajectory, on the posterior-mean path."""
    idx = np.linspace(0, len(xs) - 1, n_frames).astype(int)
    with analysis.evaluating(model, deterministic=True):
        x = analysis.model_inputs(model, xs[idx])
        recon, _ = model(x, n=1)
    return xs[idx], recon[0].float().cpu().numpy()


def analyze(model, latent_mode, normal_dims=3, n_traj=200, style="v1"):
    """The analysis of ``model`` (module docstring): (results, arrays,
    strips), ``results`` what the JSON holds, ``arrays`` the encodings of
    both trajectories and the circle's reconstructions, ``strips`` the
    rows of each strip."""
    circle = analysis.circle_trajectory(n_traj, axis=CIRCLE_AXIS).numpy()
    walk = analysis.random_walk_trajectory(
        n_traj, step=WALK_STEP,
        generator=torch.Generator().manual_seed(WALK_SEED)).numpy()
    rotation_latent = latent_mode in ("so3", "vmfq") or (
        latent_mode == "normal" and normal_dims == 3)
    results, arrays, strips = {}, {}, {}
    for name, traj in (("circle", circle), ("random_walk", walk)):
        xs = render_spherecube(traj, size=64, style=style)
        enc = analysis.encode_dataset(model, xs)
        arrays[f"encodings_{name}"] = enc
        _, results[f"discontinuity_{name}"] = analysis.discontinuity_score(
            enc)
        results[f"pca_{name}"] = analysis.pca(enc)[0].tolist()
        if name != "circle":
            continue
        idx = np.linspace(0, len(enc) - 1, FRAMES).astype(int)
        if rotation_latent:
            mats = np.asarray(analysis.encodings_to_group_matrices(
                enc, latent_mode))
            strips["encoded_poses"] = [xs[idx], analysis.render_encoded_poses(
                mats[idx], size=64, align_to=traj[0], style=style)]
        x_in, x_rec = recon_strip(model, xs)
        strips["recon"] = [x_in, x_rec]
        arrays["recon_circle"] = x_rec
        results["recon_mse_circle"] = float(np.mean((x_in - x_rec) ** 2))
        results["recon_error_circle"] = analysis.reconstruction_error(
            model, xs)
    return results, arrays, strips


def write_strip(rows, path):
    """The rows of images (each (n, H, W, 3) in [0, 1]) as one PNG."""
    strip = np.concatenate(
        [np.concatenate(list(np.clip(r, 0, 1)), axis=1) for r in rows],
        axis=0)
    write_png(path, (strip * 255).astype(np.uint8))


def main(argv=None):
    outer = argparse.ArgumentParser("analyze_spherecube")
    outer.add_argument("--checkpoint", default=None,
                       help="a cli.main checkpoint.pt")
    outer.add_argument("--n_traj", type=int, default=200)
    outer.add_argument("--out_dir", default="analysis_out/torch_spherecube")
    outer.add_argument("--style", choices=["v1", "v2"], default="v1",
                       help="render style of the trajectories and strips")
    opts, rest = outer.parse_known_args(argv)
    args = cli.parse_args(["--dataset", "spherecube"] + rest)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available (pass "
                         "--device cpu to run on the CPU)")
    model, step = load_model(args, opts.checkpoint)
    label = opts.checkpoint or args.torch_checkpoint
    print(f"== {label} (checkpoint step {step})")
    results, arrays, strips = analyze(model, args.latent_mode,
                                      args.normal_dims, opts.n_traj,
                                      opts.style)
    results = {"checkpoint": label, "checkpoint_step": step,
               "latent_mode": args.latent_mode, "n_traj": opts.n_traj,
               "style": opts.style, **results}
    os.makedirs(opts.out_dir, exist_ok=True)
    for name, rows in strips.items():
        write_strip(rows, os.path.join(opts.out_dir, f"{name}.png"))
    with open(os.path.join(opts.out_dir, "spherecube_results.json"),
              "w") as f:
        json.dump(results, f, indent=2)
    c, w = results["discontinuity_circle"], results[
        "discontinuity_random_walk"]
    lines = [
        "# Sphere-cube image model: latent-space continuity",
        "",
        f"Encoder discontinuity (per-step squared encoding jump) along "
        f"rendered SO(3) trajectories of {opts.n_traj} poses ({opts.style} "
        f"renders), for `{label}` (latent `{args.latent_mode}`). Strips: "
        "encoded_poses.png (inputs above, the poses the encoder assigns "
        "below), recon.png (inputs above, reconstructions below); the PCA "
        "projections are in spherecube_results.json.",
        "",
        "| model | circle: mean / max / outliers "
        "| walk: mean / max / outliers | recon error (circle) |",
        "|---|---|---|---|",
        f"| {label} "
        f"| {c['mean']:.3g} / {c['max']:.3g} / {c['num_outliers']} "
        f"| {w['mean']:.3g} / {w['max']:.3g} / {w['num_outliers']} "
        f"| {results['recon_error_circle']:.4g} |",
    ]
    md = os.path.join(opts.out_dir, "SPHERECUBE_ANALYSIS.md")
    with open(md, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(json.dumps({k: v for k, v in results.items()
                      if not k.startswith("pca_")}))
    print(f"Wrote {md}")
    return results, arrays, model


if __name__ == "__main__":
    main()
