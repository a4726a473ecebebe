"""Sphere-cube dataset generator.

    python -m lie_vae_tpu_torch.cli.gen_spherecube NUM DIR --singles

Counterpart of the JAX package's ``cli/gen_spherecube.py`` on its numpy
path. It renders Haar-random single poses with the port's ray-caster
(``data/render.py``) into ``DIR/images.npy`` (uint8, quantised as the JAX
generator quantises its PNGs: ``(img * 255).astype(np.uint8)``, a
truncation) beside the pose manifest ``DIR/_poses.npz``, which is what the
port's ``SphereCubeDataset`` reads. Nothing is downloaded.

The poses come, in this order, from ``--from_poses``; else from the tracked
manifest ``data_poses/<basename of DIR>.npz`` when it holds at least NUM
single poses (``data_poses/spherecube.npz``, 2048 poses, and
``spherecube-v2-32k.npz``, 32768), whose first NUM poses are used; else
from the seeded sampler. ``--style`` defaults to the manifest's own style
(v1 without one). Pairs (sc-pairs), PNG output and the Blender backend are
not ported (ROADMAP.md, Queue A, A6 and A3n).

Usage:
  python -m lie_vae_tpu_torch.cli.gen_spherecube 2048 data/spherecube --singles
"""
import argparse
import os

import numpy as np

from lie_vae_tpu_torch.data._np_ops import (
    group_matrix_to_quaternions_np, quaternions_to_group_matrix_np,
    random_quaternions_np)
from lie_vae_tpu_torch.data.render import render_spherecube
from lie_vae_tpu_torch.data.shapes import IMAGES, POSES

POSE_SETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data_poses")


def sample_poses(num, seed):
    """Haar poses (num, 1, 3, 3) and their quaternions (num, 1, 4), from
    numpy's PCG64 as the JAX generator draws its single poses."""
    rng = np.random.default_rng(seed)
    r = quaternions_to_group_matrix_np(random_quaternions_np(num, rng))
    r = r[:, None]
    return r, group_matrix_to_quaternions_np(r)


def pinned_manifest(out_dir, num):
    """The tracked manifest named after ``out_dir`` if it holds at least
    ``num`` single poses, else None."""
    path = os.path.join(POSE_SETS_DIR,
                        os.path.basename(os.path.normpath(out_dir)) + ".npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as f:
        shape = f["r"].shape
    return path if shape[0] >= num and shape[1] == 1 else None


def render_images(r, size=64, style="v1", batch=256):
    """uint8 (N, size, size, 3) renders of the (N, 3, 3) rotations."""
    out = np.empty((len(r), size, size, 3), np.uint8)
    for i in range(0, len(r), batch):
        imgs = render_spherecube(r[i:i + batch], size=size, style=style)
        out[i:i + batch] = (imgs * 255).astype(np.uint8)
    return out


def generate(num, out_dir, size=64, seed=0, style=None, from_poses=None):
    """Render ``num`` single poses into ``out_dir``; returns the uint8
    images."""
    if from_poses is None:
        from_poses = pinned_manifest(out_dir, num)
    meta_style = None
    if from_poses:
        print(f"using pinned poses {from_poses}")
        with np.load(from_poses) as f:
            r_np, q_np = f["r"], f["q"]
            if "style" in f.files:
                meta_style = f["style"].item().decode()
        if len(r_np) < num or r_np.shape[1] != 1:
            raise ValueError(f"pose manifest {from_poses} holds "
                             f"{len(r_np)} x {r_np.shape[1]} poses; asked "
                             f"for {num} singles")
        r_np, q_np = r_np[:num], q_np[:num]
    else:
        r_np, q_np = sample_poses(num, seed)
    style = style or meta_style or "v1"
    images = render_images(r_np[:, 0], size=size, style=style)
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, POSES), r=r_np, q=q_np,
        meta=np.array([num, 1, size, seed], dtype=np.int64),
        step_size=np.float64(0.0), style=np.bytes_(style))
    tmp = os.path.join(out_dir, IMAGES + ".tmp.npy")
    np.save(tmp, images)
    os.replace(tmp, os.path.join(out_dir, IMAGES))
    return images


def main(argv=None):
    parser = argparse.ArgumentParser(__doc__)
    parser.add_argument("num", type=int)
    parser.add_argument("dir")
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--singles", action="store_true",
                        help="single poses (the only kind the port renders)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--style", choices=["v1", "v2"], default=None,
                        help="render look (default: the manifest's, else v1)")
    parser.add_argument("--from_poses", default=None,
                        help="re-render exactly this pose manifest")
    args = parser.parse_args(argv)
    if not args.singles:
        raise NotImplementedError(
            "pose pairs (sc-pairs) are not ported yet: pass --singles "
            "(ROADMAP.md, Queue A, A6)")
    generate(args.num, args.dir, size=args.size, seed=args.seed,
             style=args.style, from_poses=args.from_poses)
    print(f"Wrote poses to {args.dir}")


if __name__ == "__main__":
    main()
