"""Where a training step's time goes on the card.

    python -m lie_vae_tpu_torch.profile_train [--steps 20] [--batch 512]
        [--kernel_impl fused|pallas] [--bench_recipe] [--find_kernel NAME ...]
        [--syncs]

Trains the flagship model as ``bench.py`` does (sigma clamp pi * 10 / 2,
lr 1e-3, clip 1e-5, beta 1; float32 throughout, in IEEE float32 as
``train_step`` runs; with
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
sum. Then it gives the decoder's transposed convolutions' device time by
layer and pass (forward, dx, dw; :func:`decoder_passes`), and profiles
each kernel of the Lie-group path alone at the batch's shape and at B =
4096. The batch defaults to the benchmark's 512 images a step. The trace
files go to ``build/profile/``.

``--find_kernel NAME ...`` names the layers behind the device kernels
whose name holds each NAME: it profiles two steps with ``record_shapes``
and prints, for each such kernel, the operator that launched it with its
input shapes (and dtypes, where torch records them), and the model's
parameters (by name) whose shape is among them.

``--syncs`` instead counts the synchronising CUDA calls of a training step
as ``UnsupervisedExperiment.train()`` runs it over a device cache of the
batch (``device_data``), for the flagship and for the flagship under the
regularised preset on pairs (equivariance 100, 'shear'; continuity 3000):
after two warm-up steps it prints the ms a step of ``steps`` steps (host
clock, untraced), then runs ``steps`` more under
``torch.cuda.set_sync_debug_mode("warn")`` and prints the synchronising
calls a step with their call sites (the innermost frames of this package
on each warning's Python stack) and the experiment's ``staged`` counts.
"""
import argparse
import collections
import math
import os
import subprocess
import time
import traceback
import warnings

import numpy as np
import torch

from lie_vae_tpu_torch import compat
from lie_vae_tpu_torch.cli.gen_spherecube import POSE_SETS_DIR, render_images
from lie_vae_tpu_torch.models import bench_model, flagship_model
from lie_vae_tpu_torch.ops import group_matrix_to_eazyz, random_group_matrices
from lie_vae_tpu_torch.ops.kernels import (so3_density, wigner_block,
                                           wigner_fused)
from lie_vae_tpu_torch.precision import flags, ieee_float32
from lie_vae_tpu_torch.profile_serve import profile_request
from lie_vae_tpu_torch.train import (ConstantSchedule, UnsupervisedExperiment,
                                     get_beta_schedule, make_optimizer,
                                     train_step)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHECKPOINT = os.path.join(_ROOT, "converged_state", "torch_clean",
                           "best.pt")
_KERNELS = ("wigner_chain", "wigner_block", "so3_density")
# the conv stack's cuDNN kernels (implicit GEMMs, dgrad and wgrad engines),
# listed with the port's own whatever their rank
_CONV = ("xmma", "cudnn", "grad")
PEAK = 67e12    # the H100's float32 FMA rate outside the tensor cores
_PACKAGE = os.path.dirname(os.path.abspath(__file__))


def time_ms(fn, calls, trials):
    """Median over ``trials`` of the ms per call of ``calls`` calls (CUDA
    events), after two calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def kernels(fn, calls=1):
    """{device kernel name: µs a call} of ``calls`` calls of ``fn``,
    profiled."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.device_time / calls
    return out


def passes(fn, x, w, b):
    """{pass: a call} for the forward, dx and dw of ``fn(x, w, b)``: the
    gradients are taken of one recorded graph, kept for repeated calls;
    the output's gradient is drawn in its shape and dtype and laid out as
    it is."""
    y = fn(x, w, b)
    g = torch.randn(y.shape, dtype=y.dtype, device=y.device).contiguous(
        memory_format=torch.contiguous_format if y.is_contiguous()
        else torch.channels_last)
    xg = x.detach().requires_grad_(True)
    wg = w.detach().requires_grad_(True)
    y_dx = fn(xg, w, b)
    y_dw = fn(x, wg, b)

    def forward():
        with torch.no_grad():
            return fn(x, w, b)

    return {"forward": forward,
            "dx": lambda: torch.autograd.grad(y_dx, xg, g,
                                              retain_graph=True)[0],
            "dw": lambda: torch.autograd.grad(y_dw, wg, g,
                                              retain_graph=True)[0]}


def decoder_passes(model, step, calls=3):
    """Device µs of each of the decoder's transposed convolutions' forward,
    input gradient (dx) and weight gradient (dw), on the model's own path
    at the inputs one call of ``step`` hands it: each pass alone, its
    kernels summed over ``calls`` profiled calls. Prints a row a layer and
    pass (µs, TFLOP/s and share of the 67 TFLOP/s float32 peak, the two
    costliest kernels) and returns {(layer, pass): µs}."""
    from torch.func import functional_call
    convs = [(n, m) for n, m in model.named_modules()
             if isinstance(m, torch.nn.ConvTranspose2d)]
    seen = {}

    def keep(name):
        def hook(mod, args, out):
            seen.setdefault(name, args[0].detach())
        return hook

    hooks = [m.register_forward_hook(keep(n)) for n, m in convs]
    try:
        step()
    finally:
        for h in hooks:
            h.remove()
    print(f"the decoder's transposed convolutions by layer and pass "
          f"(device us a call, {calls} calls profiled):")
    out, total = {}, {}
    for n, mod in convs:
        x = seen[n]
        c_in, c_out, kh, kw = mod.weight.shape
        flops = 2.0 * c_in * c_out * kh * kw * x[0, 0].numel() * x.shape[0]
        calls_of = passes(
            lambda x, w, b, mod=mod: functional_call(
                mod, {"weight": w, "bias": b}, (x,)),
            x, mod.weight.detach(), mod.bias.detach())
        for p, call in calls_of.items():
            names = kernels(call, calls)
            us = sum(names.values())
            out[(n, p)] = us
            total[p] = total.get(p, 0.0) + us
            top = sorted(names.items(), key=lambda kv: -kv[1])[:2]
            print(f"    {n:18s} {p:7s} {us:9.1f} us "
                  f"{flops / us / 1e6:6.2f} TFLOP/s "
                  f"{100 * flops / us / 1e-6 / PEAK:5.1f}% | "
                  + "; ".join(f"{k[:56]} {v:.0f}" for k, v in top))
    print("    by pass: " + ", ".join(f"{p} {us:.1f} us"
                                       for p, us in total.items())
          + f"; together {sum(total.values()):.1f} us")
    return out


def find_kernel(model, step, name, steps=2):
    """Print the operators (with their input shapes) that launch the
    device kernels whose name holds ``name`` in ``steps`` calls of ``step``,
    and the parameters of ``model`` whose shape is among those inputs."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    shapes = {}
    for pname, p in model.named_parameters():
        shapes.setdefault(tuple(p.shape), []).append(pname)
    found = {}
    for evt in prof.events():
        for k in getattr(evt, "kernels", []):
            if name in k.name:
                key = (evt.name, repr(evt.input_shapes),
                       repr(getattr(evt, "input_dtypes", None)), k.name)
                entry = found.setdefault(key, [0.0, evt.input_shapes])
                entry[0] += k.duration
    print(f"kernels holding {name!r} in {steps} steps (precision flags "
          f"{flags()}): {len(found)} launching operator(s)")
    for (op, in_shapes, dtypes, kname), (us, inputs) in found.items():
        params = sorted({pn for s in inputs if s
                         for pn in shapes.get(tuple(s), [])})
        print(f"    {us / steps:9.2f} us  {kname[:90]}\n"
              f"        from {op} inputs {in_shapes} {dtypes}\n"
              f"        parameters of that shape: {params}")
    return found


class _Renders:
    """Renders as ``UnsupervisedExperiment`` reads a dataset: items of
    ``per_item`` consecutive images, an item's images on consecutive rows
    of a batch."""

    def __init__(self, images, per_item):
        self.images = images.reshape((-1, per_item) + images.shape[1:])

    def __len__(self):
        return len(self.images)

    def gather(self, indices):
        idx = np.asarray(indices)
        return idx, self.images[idx]

    def prep_batch(self, batch):
        idx, images = batch
        return idx, images.reshape((-1,) + images.shape[2:])


def _call_site(stack):
    """The innermost two frames of this package (this script left out) on
    ``stack``, as "file:line function <- file:line function"."""
    ours = [f for f in stack if f.filename.startswith(_PACKAGE)
            and not f.filename.endswith("profile_train.py")]
    return " <- ".join(
        f"{os.path.relpath(f.filename, os.path.dirname(_PACKAGE))}:"
        f"{f.lineno} {f.name}" for f in reversed(ours[-2:])) or "elsewhere"


def count_syncs(step, steps):
    """{call site: synchronising CUDA calls} over ``steps`` calls of
    ``step``: torch's sync debug mode warns at each such call, and the
    warning's Python stack names the site."""
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        # the mode's own notice when it is set ("... does not yet detect
        # all synchronizing operations") is no call of the step
        if "called a synchronizing" in str(message):
            sites[_call_site(traceback.extract_stack()[:-1])] += 1
        else:
            print(f"    not counted: {str(message)[:160]}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def sync_report(images, weights, args):
    """``--syncs``: for each training configuration, the ms a step and
    the synchronising calls a step of ``train()`` over a device cache of
    ``images`` (one batch an epoch)."""
    configs = (("flagship", 1, {}),
               ("scpairs_reg", 2, dict(
                   equivariance_lamb=ConstantSchedule(100.0),
                   encoder_continuity_lamb=ConstantSchedule(3000.0),
                   equivariance_rotate="shear")))
    for name, per_item, reg in configs:
        model = flagship_model(kernel_impl=args.kernel_impl)
        model.load_state_dict(weights, strict=True)
        data = _Renders(images, per_item)
        exp = UnsupervisedExperiment(
            model=model, train_dataset=data, test_dataset=data,
            beta_schedule=get_beta_schedule(None, 1.0), lr=1e-3,
            clip_grads=1e-5, report_freq=None, batch_size=len(data),
            device_data=True, seed=0, **reg)
        epoch = [0]

        def step():
            exp.train(epoch[0])
            epoch[0] += 1

        step()
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / args.steps
        staged = dict(getattr(exp, "staged", {}) or {})
        sites = count_syncs(step, args.steps)
        after = getattr(exp, "staged", None)
        moved = (None if after is None else
                 {k: (v - staged.get(k, 0)) / args.steps
                  for k, v in after.items()})
        print(f"{name}: {ms:.3f} ms a step of {len(images)} images "
              f"(untraced, {args.steps} steps); "
              f"{sum(sites.values()) / args.steps:g} synchronising calls a "
              f"step over {args.steps} steps; staged a step {moved}")
        for site, n in sites.most_common():
            print(f"    {n / args.steps:g} a step  {site}")


@ieee_float32()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--kernel_impl", default="fused",
                    choices=["fused", "pallas"])
    ap.add_argument("--bench_recipe", action="store_true",
                    help="bench.py's bfloat16 stacks and float32 image head")
    ap.add_argument("--find_kernel", nargs="+", default=(),
                    help="name the layers behind the device kernels whose "
                         "name holds one of these")
    ap.add_argument("--syncs", action="store_true",
                    help="count the synchronising calls of a training step "
                         "in train(), flagship and regularised")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    out_dir = os.path.join(_ROOT, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(),
          f"torch {torch.__version__}")

    weights = compat.load_torch(_CHECKPOINT)
    with np.load(os.path.join(POSE_SETS_DIR, "spherecube.npz")) as f:
        batch = render_images(f["r"][:args.batch, 0])
    if args.syncs:
        sync_report(batch, weights, args)
        return
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
    for kname in args.find_kernel:
        find_kernel(model, step, kname)
    decoder_passes(model, step)
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
