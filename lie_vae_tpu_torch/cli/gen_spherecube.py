"""Sphere-cube dataset generator.

    python -m lie_vae_tpu_torch.cli.gen_spherecube NUM DIR            # pairs
    python -m lie_vae_tpu_torch.cli.gen_spherecube NUM DIR --singles

Counterpart of the JAX package's ``cli/gen_spherecube.py``, writing what
it writes. By default it renders NUM consecutive-pose pairs (sc-pairs: a
Haar pose a and b = a exp(N(0, step_size)) in the algebra, 2 NUM images,
pair i in files 2i and 2i + 1); with ``--singles`` NUM Haar-random single
poses. Each image is a PNG file (``data/png.py``) named by its index,
its place in the pair and its pose quaternion at 4 decimals,
``{:06d}_{sub}_{q0:.4f}_{q1:.4f}_{q2:.4f}_{q3:.4f}.png``, as the JAX
generator names them and the datasets of both packages parse them back,
quantised as the JAX generator quantises (``(img * 255).astype(np.uint8)``,
a truncation); the pose manifest ``DIR/_poses.npz`` (``r``, ``q``, ``meta``,
``step_size``, ``style``) lies beside them. The native renderer
(``data/render.py``, built with ``g++``) renders them; ``--backend numpy``
takes the plain ray-caster, ``--blender`` Blender
(``data/blender_spherecube.py``, through ``blender --background --python
<script> -- <spec.json>``, as the JAX generator runs it). Nothing is
downloaded.

The poses come, in this order, from ``--from_poses``; else from the tracked
manifest ``data_poses/<basename of DIR>.npz`` when it holds at least NUM
poses of the asked kind (``data_poses/spherecube.npz``, 2048 single poses,
and ``spherecube-v2-32k.npz``, 32768), whose first NUM are used; else from
the seeded sampler (numpy's PCG64, as the JAX generator draws them, so one
seed gives the JAX generator's poses). ``--style`` defaults to the
manifest's own style (v1 without one).

Usage:
  python -m lie_vae_tpu_torch.cli.gen_spherecube 2048 data/spherecube --singles
  python -m lie_vae_tpu_torch.cli.gen_spherecube 1024 data/sc-pairs
"""
import argparse
import json
import os
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lie_vae_tpu_torch.data._np_ops import (
    expmap_np, group_matrix_to_quaternions_np,
    quaternions_to_group_matrix_np, random_quaternions_np)
from lie_vae_tpu_torch.data.png import write_png
from lie_vae_tpu_torch.data.render import render_spherecube

POSES = "_poses.npz"
# the pool that encodes and writes the PNG files
WRITE_THREADS = 8
BLENDER_SCRIPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "blender_spherecube.py")

POSE_SETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data_poses")


STEP_SIZE = 2 * np.pi / 60


def pose_name(index, sub, q):
    """The file name of pose ``sub`` of item ``index`` with quaternion
    ``q``, as the JAX generator names it."""
    return "{:06d}_{}_{:.4f}_{:.4f}_{:.4f}_{:.4f}.png".format(
        index, sub, *[float(x) for x in q])


def sample_poses(num, step_size, pairs, seed):
    """Haar poses a (num, 1, 3, 3), or with ``pairs`` the pairs (a, a @
    exp(N(0, step_size))) (num, 2, 3, 3), and their quaternions (num, P, 4):
    one numpy PCG64 stream, as the JAX generator draws them."""
    rng = np.random.default_rng(seed)
    a_r = quaternions_to_group_matrix_np(random_quaternions_np(num, rng))
    if pairs:
        d = expmap_np(rng.normal(size=(num, 3)) * step_size)
        r = np.stack([a_r, a_r @ d], 1)
    else:
        r = a_r[:, None]
    return r, group_matrix_to_quaternions_np(r)


def pinned_manifest(out_dir, num, pairs=False):
    """The tracked manifest named after ``out_dir`` if it holds at least
    ``num`` poses of the asked kind (pairs or singles), else None."""
    path = os.path.join(POSE_SETS_DIR,
                        os.path.basename(os.path.normpath(out_dir)) + ".npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as f:
        shape = f["r"].shape
    return path if shape[0] >= num and (shape[1] == 2) == bool(pairs) \
        else None


def render_images(r, size=64, style="v1", batch=256, backend="auto"):
    """uint8 (N, size, size, 3) renders of the (N, 3, 3) rotations."""
    out = np.empty((len(r), size, size, 3), np.uint8)
    for i in range(0, len(r), batch):
        imgs = render_spherecube(r[i:i + batch], size=size, style=style,
                                 backend=backend)
        out[i:i + batch] = (imgs * 255).astype(np.uint8)
    return out


def write_pngs(images, names, out_dir):
    """Write each uint8 image to ``out_dir/<name>`` (zlib releases the GIL:
    the files are encoded by a pool of WRITE_THREADS threads)."""
    with ThreadPoolExecutor(WRITE_THREADS) as pool:
        for f in [pool.submit(write_png, os.path.join(out_dir, n), img)
                  for img, n in zip(images, names)]:
            f.result()


def render_blender(r, names, out_dir, size):
    """Render the (N, 3, 3) rotations into ``out_dir/<name>`` with Blender:
    a JSON spec of the rotation matrices (convention-unambiguous, unlike
    quaternion layouts), the names, the directory and the size, handed to
    ``blender --background --python <script> -- <spec>``."""
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump({"matrices": np.asarray(r).reshape(-1, 3, 3).tolist(),
                   "names": list(names),
                   "out_dir": os.path.abspath(out_dir), "size": size}, f)
        spec = f.name
    try:
        subprocess.check_call(["blender", "--background", "--python",
                               BLENDER_SCRIPT, "--", spec])
    finally:
        os.unlink(spec)


def generate(num, out_dir, size=64, seed=0, style=None, from_poses=None,
             pairs=False, step_size=STEP_SIZE, backend="auto",
             use_blender=False):
    """Render ``num`` single poses, or with ``pairs`` ``num`` pairs, into
    PNG files in ``out_dir`` with the renderer's ``backend`` (or Blender);
    returns the uint8 images (num * P, size, size, 3), file order (None
    from Blender)."""
    if from_poses is None:
        from_poses = pinned_manifest(out_dir, num, pairs)
    meta_style = None
    if from_poses:
        print(f"using pinned poses {from_poses}")
        with np.load(from_poses) as f:
            r_np, q_np = f["r"], f["q"]
            if "style" in f.files:
                meta_style = f["style"].item().decode()
        kind = "pairs" if pairs else "singles"
        if len(r_np) < num or (r_np.shape[1] == 2) != bool(pairs):
            raise ValueError(f"pose manifest {from_poses} holds "
                             f"{len(r_np)} x {r_np.shape[1]} poses; asked "
                             f"for {num} {kind}")
        r_np, q_np = r_np[:num], q_np[:num]
    else:
        r_np, q_np = sample_poses(num, step_size, pairs, seed)
    style = style or meta_style or "v1"
    if use_blender and style != "v1":
        raise ValueError(f"style={style!r} is a ray-caster look; the Blender "
                         "backend renders the v1 scene only")
    names = [pose_name(i, j, q_np[i, j]) for i in range(num)
             for j in range(r_np.shape[1])]
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, POSES), r=r_np, q=q_np,
        meta=np.array([num, r_np.shape[1], size, seed], dtype=np.int64),
        step_size=np.float64(step_size if pairs else 0.0),
        style=np.bytes_(style))
    if use_blender:
        render_blender(r_np, names, out_dir, size)
        return None
    images = render_images(r_np.reshape(-1, 3, 3), size=size, style=style,
                           backend=backend)
    write_pngs(images, names, out_dir)
    return images


def main(argv=None):
    parser = argparse.ArgumentParser(__doc__)
    parser.add_argument("num", type=int)
    parser.add_argument("dir")
    parser.add_argument("--step_size", type=float, default=STEP_SIZE,
                        help="std of a pair's algebra perturbation")
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--singles", action="store_true",
                        help="single poses (spherecube) instead of pairs "
                             "(sc-pairs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--style", choices=["v1", "v2"], default=None,
                        help="render look (default: the manifest's, else v1)")
    parser.add_argument("--from_poses", default=None,
                        help="re-render exactly this pose manifest")
    parser.add_argument("--backend", choices=["auto", "native", "numpy"],
                        default="auto",
                        help="renderer: the native one (auto, native) or "
                             "the numpy ray-caster")
    parser.add_argument("--blender", action="store_true",
                        help="render with Blender (a blender binary on "
                             "PATH) instead of the ray-caster")
    args = parser.parse_args(argv)
    generate(args.num, args.dir, size=args.size, seed=args.seed,
             style=args.style, from_poses=args.from_poses,
             pairs=not args.singles, step_size=args.step_size,
             backend=args.backend, use_blender=args.blender)
    print(f"Wrote {'poses' if args.singles else 'pairs'} to {args.dir}")


if __name__ == "__main__":
    main()
