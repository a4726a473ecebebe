"""Where a training step's time goes on the card.

    python -m lie_vae_tpu_torch.profile_train [--steps 20] [--batch 64]
        [--kernel_impl fused|pallas] [--bench_recipe]

Trains the flagship model as ``bench.py`` does (sigma clamp pi * 10 / 2,
lr 1e-3, clip 1e-5, beta 1; float32 throughout, TF32 off; with
``--bench_recipe`` in ``bench.py``'s dtypes, ``models.bench_model``:
bfloat16 conv and transpose-conv stacks, a float32 image head) from the
converged reference weights (``converged_state/torch_clean/best.pt``) on
the first CUDA device, on one batch of uint8 sphere-cube renders (the
first poses of ``data_poses/spherecube.npz``, rendered by the port), with
the Lie-group kernels of ``--kernel_impl``. After two warm-up steps it
profiles ``steps`` steps with ``torch.profiler`` and prints the host ms per
step, the device's busy share of it (kernels and copies, overlaps merged;
the rest is the idle share), the device us per step of the costliest
device items, of every cuDNN convolution kernel and of the port's own
kernels (the Wigner chain, the
synthesise-then-apply Wigner product and the SO(3) density), and their
sum. Then it profiles each kernel of that path alone at the batch's shape
and at B = 4096. The trace files go to ``build/profile/``.
"""
import argparse
import math
import os
import subprocess

import numpy as np
import torch

from lie_vae_tpu_torch import compat
from lie_vae_tpu_torch.cli.gen_spherecube import POSE_SETS_DIR, render_images
from lie_vae_tpu_torch.models import bench_model, flagship_model
from lie_vae_tpu_torch.ops import group_matrix_to_eazyz, random_group_matrices
from lie_vae_tpu_torch.ops.kernels import (so3_density, wigner_block,
                                           wigner_fused)
from lie_vae_tpu_torch.profile_serve import profile_request
from lie_vae_tpu_torch.train import make_optimizer, train_step

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHECKPOINT = os.path.join(_ROOT, "converged_state", "torch_clean",
                           "best.pt")
_KERNELS = ("wigner_chain", "wigner_block", "so3_density")
# the conv stack's cuDNN kernels (implicit GEMMs, dgrad and wgrad engines),
# listed with the port's own whatever their rank
_CONV = ("xmma", "cudnn", "grad")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--kernel_impl", default="fused",
                    choices=["fused", "pallas"])
    ap.add_argument("--bench_recipe", action="store_true",
                    help="bench.py's bfloat16 stacks and float32 image head")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = os.path.join(_ROOT, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(),
          f"torch {torch.__version__}")

    weights = compat.load_torch(_CHECKPOINT)
    with np.load(os.path.join(POSE_SETS_DIR, "spherecube.npz")) as f:
        batch = render_images(f["r"][:args.batch, 0])
    model = (bench_model(kernel_impl=args.kernel_impl) if args.bench_recipe
             else flagship_model(sigma_clamp=math.pi * 10 / 2,
                                 kernel_impl=args.kernel_impl))
    model.load_state_dict(weights, strict=True)
    opt = make_optimizer(model.named_parameters(), lr=1e-3, clip_grads=1e-5)
    x = torch.as_tensor(batch, device="cuda")
    noise = torch.Generator().manual_seed(0)

    def step():
        train_step(model, opt, x, 1.0, generator=noise)

    step()
    name = f"train_step_{args.kernel_impl}" + (
        "_bf16" if args.bench_recipe else "")
    per_step, _ = profile_request(name, step, args.steps, out_dir,
                                  unit=f"step of {args.batch}",
                                  watch=_KERNELS + _CONV)
    ours = sum(us for name, us in per_step.items()
               if any(w in name for w in _KERNELS))
    print(f"    {ours:9.2f} us  the port's kernels together "
          f"({100 * ours / sum(per_step.values()):.1f}% of device time)")

    gen = torch.Generator().manual_seed(1)
    item_rep = torch.randn((49, 10), generator=gen).cuda()
    for B in (args.batch, 4096):
        angles = group_matrix_to_eazyz(random_group_matrices(
            B, generator=gen, device="cpu").cuda()).contiguous()
        dout = torch.randn((B, 49, 10), generator=gen).cuda()
        sigma = torch.rand((B, 3), generator=gen).cuda() + 0.1
        v = (torch.randn((B, 3), generator=gen).cuda() * sigma).contiguous()
        g = torch.randn((B,), generator=gen).cuda()
        if args.kernel_impl == "fused":
            _, y, z = wigner_fused._launch_residuals(angles, item_rep, 6)
            wigner = (
                ("wigner_chain_fwd_res", lambda: wigner_fused
                 ._launch_residuals(angles, item_rep, 6)),
                ("wigner_chain_bwd", lambda: wigner_fused._launch_backward(
                    angles, item_rep, y, z, dout, 6, True)))
        else:
            wigner = (
                ("wigner_block_fwd", lambda: wigner_block._launch(
                    angles, item_rep, 6, False)),
                ("wigner_block_bwd", lambda: wigner_block._launch_backward(
                    angles, item_rep, dout, 6, False, True)))
        for name, fn in wigner + (
                ("so3_density_kl", lambda: so3_density._launch_kl(
                    v, sigma, 10, 1e-3)),
                ("so3_density_bwd", lambda: so3_density._launch_bwd(
                    v, sigma, g, 10, 1e-3, True))):
            profile_request(f"{name}_B{B}", fn, args.steps, out_dir,
                            unit="launch", watch=_KERNELS)


if __name__ == "__main__":
    main()
