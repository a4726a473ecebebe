"""How far the card's flagship training step sits from the exact one, by
the memory layout of the encoder's convolutions' inputs and by channel,
and what each layout costs.

    python -m lie_vae_tpu_torch.conv_precision [--render 80] [--pairs 64]

The encoder takes the NHWC images as a permuted view, which is
channels_last in memory, and its convolutions carry that layout through
it, on the card in cuDNN's NHWC kernels; laid out NCHW, cuDNN runs its
NCHW kernels. This script sets each encoder convolution's input to one
layout or the other by a forward pre-hook. It renders ``--render``
consecutive-pose pairs with the port's generator from seed 0 (into
``build/conv_precision/``; the defaults are the renders on which the
card's step sat farthest from the exact one, ROADMAP.md, Queue C, C7;
``chip_smoke.py`` renders 320) and takes the 2 * pairs images of the first
``--pairs``. Four parts:

1. Per layout, one card step from the converged reference weights, each
   encoder convolution's input and output gradient captured; per layer
   the forward and the two backward products (``F.conv2d``,
   ``aten.convolution_backward``) on them, against the same in float64 on
   the CPU: the largest error as a share of the largest exact value, and
   the CUDA kernels that ran.
2. One flagship step from the converged reference weights of
   ``converged_state/torch_clean/best.pt`` (sigma clamp pi * 10 / 2, lr
   1e-3, clip 1e-5, beta 1, the posterior noise of ``chip_smoke.py``'s
   regularised step, no regularizer): exactly, in float64 on the CPU; in
   float32 on the CPU (NCHW); and in float32 on the first CUDA device (IEEE
   float32, as ``train_step`` runs) with the encoder's inputs NCHW,
   channels_last (as the model runs) at torch's defaults, with
   ``cudnn.deterministic`` and with ``cudnn.benchmark``, and channels_last
   at each layer alone. For each it prints the three gradients farthest
   from the exact step, each as a share of its tensor's largest exact
   entry, with the CPU's float32 share beside it (the conv biases before a
   BatchNorm, whose exact gradient is 0, left out).
3. For encoder.9, by layout, where the card's step leaves the exact one:
   the layer's input, output and output gradient, and the output channels
   of the worst weight gradients with their spread, their BatchNorm's
   scale and shift, and the BatchNorm outputs at the LeakyReLU's kink
   (within 1e-4 of the largest from 0, and on the other side of it from
   the exact step's).
4. The step's cost by layout, in turns (NCHW, channels_last,
   channels_last, NCHW): the flagship step on the first 64 images and the
   regularised step (equivariance 100, encoder continuity 3000, shear) on
   all 2 * pairs, each 5 steps under torch.profiler after a warm-up: host
   ms, device busy ms and device events per step
   (``profile_serve.profile_request``; traces under build/profile/).
"""
import argparse
import contextlib
import math
import os
import subprocess

import torch
import torch.nn.functional as F

from lie_vae_tpu_torch import compat
from lie_vae_tpu_torch.models import flagship_model
from lie_vae_tpu_torch.precision import ieee_float32
from lie_vae_tpu_torch.train import make_optimizer, train_step

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHECKPOINT = os.path.join(_ROOT, "converged_state", "torch_clean",
                           "best.pt")
_PRE_BN = {f"encoder.{i}.bias" for i in (0, 3, 6, 9)}
_LAYERS = (0, 3, 6, 9, 12)
_NHWC = torch.channels_last


@contextlib.contextmanager
def _cudnn(**flags):
    """Run the block with ``torch.backends.cudnn``'s ``flags``; restore
    them after."""
    saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)


def _model(device, dtype, weights, nhwc=(), seen=None):
    """The flagship from ``weights`` and its optimizer; the encoder convs of
    ``nhwc`` take their input channels_last, the others NCHW. With ``seen``
    (a dict) each conv's input and output gradient are kept there by
    layer."""
    model = flagship_model(device, sigma_clamp=math.pi * 10 / 2)
    model.load_state_dict(weights, strict=True)
    model.to(dtype)

    def lay_out(mod, args, i):
        fmt = _NHWC if i in nhwc else torch.contiguous_format
        x = args[0].contiguous(memory_format=fmt)
        if seen is not None:
            seen[i] = {"x": x.detach()}
        return (x,)

    def keep_bn(out, i):
        # the BatchNorm's output, the LeakyReLU's input (returns None: the
        # output stays the module's)
        seen[i].setdefault("bn", out.detach())

    def keep_grad(mod, args, out, i):
        seen[i]["y"] = out.detach()
        out.register_hook(lambda g: seen[i].setdefault("dy", g.detach()))

    for i in _LAYERS:
        conv = model.encoder[i]
        conv.register_forward_pre_hook(
            lambda mod, args, i=i: lay_out(mod, args, i))
        if seen is not None:
            conv.register_forward_hook(
                lambda mod, args, out, i=i: keep_grad(mod, args, out, i))
            if i != _LAYERS[-1]:
                model.encoder[i + 1].register_forward_hook(
                    lambda mod, args, out, i=i: keep_bn(out, i))
    opt = make_optimizer(model.named_parameters(), lr=1e-3, clip_grads=1e-5)
    return model, opt


def _step(device, dtype, weights, x, eps, nhwc=(), seen=None):
    model, opt = _model(device, dtype, weights, nhwc, seen)
    train_step(model, opt, torch.as_tensor(x), 1.0, eps=eps.to(dtype))
    return model


def _shares(model, exact):
    ref = dict(exact.named_parameters())
    out = {}
    for name, p in model.named_parameters():
        if name in _PRE_BN:
            continue
        e = ref[name].grad
        out[name] = ((p.grad.detach().cpu().double() - e).abs().max()
                     / e.abs().max()).item()
    return out


def _conv_products(x, dy, w, b, stride, padding):
    """The forward, dx and dw of one convolution."""
    y = F.conv2d(x, w, b, stride, padding)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy, x, w, [w.shape[0]], list(stride), list(padding), [1, 1], False,
        [0, 0], 1, [True, True, True])
    return y, dx, dw


def _kernels(fn):
    """fn's result and the names of the CUDA kernels of one call (after a
    warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), ieee_float32():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
    names = sorted({e.name[:80] for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and "elementwise" not in e.name
                    and "Fill" not in e.name})
    return out, names


def layer_table(weights, images, eps):
    """Part 1: each encoder conv's three products by layout."""
    for label, nhwc in (("NCHW", ()), ("channels_last", _LAYERS)):
        seen = {}
        model = _step("cuda", torch.float32, weights, images, eps, nhwc,
                      seen)
        for i in _LAYERS:
            conv = model.encoder[i]
            x, dy = seen[i]["x"], seen[i]["dy"]
            w, b = conv.weight.detach(), conv.bias.detach()
            args = (conv.stride, conv.padding)
            exact = _conv_products(*(t.cpu().double() for t in (x, dy, w, b)),
                                   *args)
            got, names = _kernels(lambda: _conv_products(x, dy, w, b, *args))
            shares = [((g.cpu().double() - e).abs().max()
                       / e.abs().max()).item() for g, e in zip(got, exact)]
            print(f"{label} encoder.{i} ({w.shape[1]} -> {w.shape[0]}, "
                  f"{tuple(x.shape)} in, strides {x.stride()}, dy strides "
                  f"{dy.stride()}): forward {shares[0]:.3e}, dx "
                  f"{shares[1]:.3e}, dw {shares[2]:.3e}; kernels {names}")


def step_shares(weights, images, eps):
    """Part 2: the card's step against the exact one, by layout."""
    exact = _step("cpu", torch.float64, weights, images, eps)
    cpu = _shares(_step("cpu", torch.float32, weights, images, eps), exact)
    configs = [("NCHW", (), {}),
               ("channels_last (as the model runs)", _LAYERS, {}),
               ("channels_last, cudnn.deterministic", _LAYERS,
                {"deterministic": True}),
               ("channels_last, cudnn.benchmark", _LAYERS,
                {"benchmark": True})] + [
        (f"channels_last at encoder.{i} alone", (i,), {}) for i in _LAYERS]
    for label, nhwc, flags in configs:
        with _cudnn(**flags):
            card = _step("cuda", torch.float32, weights, images, eps, nhwc)
        got = _shares(card, exact)
        worst = sorted(got, key=got.get, reverse=True)[:3]
        print(f"{label}: " + "; ".join(
            f"{n} card {got[n]:.3e}, CPU {cpu[n]:.3e}" for n in worst))


def channel_noise(weights, images, eps, layer=9):
    """Part 3: for ``encoder.<layer>``, by layout, how far the card's
    input, output and output gradient of the layer sit from the exact
    step's (each as a share of its largest exact value), and for the three
    output channels of the worst weight gradients: the exact pre-BatchNorm
    output's spread (its standard deviation over the batch and positions,
    as a share of the layer's largest output) and the card's deviation
    from it over that spread, the output gradient's error, the BatchNorm's
    scale and shift, and how many of its outputs sit at the LeakyReLU's
    kink and on the other side of it from the exact step's. A sign flipped
    there multiplies that element's gradient by 0.2 instead of 1, or the
    other way."""
    seen_x, seen_c = {}, {}
    exact = _step("cpu", torch.float64, weights, images, eps, (), seen_x)
    for label, nhwc in (("NCHW", ()), ("channels_last", _LAYERS)):
        seen_c.clear()
        card = _step("cuda", torch.float32, weights, images, eps, nhwc,
                     seen_c)
        ye = seen_x[layer]["y"]
        yc = seen_c[layer]["y"].cpu().double()
        spread = ye.std(dim=(0, 2, 3))
        rel = spread / ye.abs().max()
        noise = (yc - ye).std(dim=(0, 2, 3)) / spread
        ge = exact.encoder[layer].weight.grad
        gc = card.encoder[layer].weight.grad.cpu().double()
        err = (gc - ge).abs().amax(dim=(1, 2, 3)) / ge.abs().max()
        worst = err.argsort(descending=True)[:3].tolist()
        far = {k: ((seen_c[layer][k].cpu().double() - seen_x[layer][k])
                   .abs().max() / seen_x[layer][k].abs().max()).item()
               for k in ("x", "y", "dy")}
        dye, dyc = seen_x[layer]["dy"], seen_c[layer]["dy"].cpu().double()
        dy_err = (dyc - dye).abs().amax(dim=(0, 2, 3)) / dye.abs().max()
        bne, bnc = seen_x[layer]["bn"], seen_c[layer]["bn"].cpu().double()
        flips = ((bne > 0) != (bnc > 0)).sum(dim=(0, 2, 3))
        near = (bne.abs() < 1e-4 * bne.abs().max()).sum(dim=(0, 2, 3))
        gamma = weights[f"encoder.{layer + 1}.weight"]
        beta = weights[f"encoder.{layer + 1}.bias"]
        print(f"{label} encoder.{layer}, per output channel: " + "; ".join(
            f"channel {c} gradient {err[c]:.3e}, spread {rel[c]:.3e}, "
            f"noise over spread {noise[c]:.3e}, output gradient "
            f"{dy_err[c]:.3e}, BatchNorm scale {float(gamma[c]):.3e} shift "
            f"{float(beta[c]):.3e}, its outputs within 1e-4 of its largest "
            f"from 0 {int(near[c])} of {bne[:, c].numel()}, signs flipped "
            f"from the exact {int(flips[c])}" for c in worst)
            + f"; over all {len(err)} channels the spread's median "
            f"{rel.median():.3e} and smallest {rel.min():.3e} (channel "
            f"{int(rel.argmin())}), noise over spread median "
            f"{noise.median():.3e}; the layer's input, output and output "
            f"gradient from the exact step's: " + ", ".join(
                f"{k} {v:.3e}" for k, v in far.items())
            + f"; LeakyReLU signs flipped in all channels {int(flips.sum())}")


def step_costs(weights, images, eps):
    """Part 4: host ms, device busy ms and events per step, in turns."""
    from lie_vae_tpu_torch.profile_serve import profile_request
    out_dir = os.path.join(_ROOT, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(22)
    n = len(images)
    theta = torch.rand((n,), generator=gen, dtype=torch.float64) * (
        2 * math.pi)
    eq_eps = torch.randn((1, n, 3), generator=gen).cuda()
    steps = {
        "flagship step, 64 images": (images[:64], eps[:, :64].cuda(), {}),
        f"regularised step, {n} images": (images, eps.cuda(), {
            "equivariance_lamb": 100.0, "encoder_continuity_lamb": 3000.0,
            "theta": theta, "eq_eps": eq_eps})}
    layouts = (("NCHW", ()), ("channels_last", _LAYERS))
    for what, (x, noise, reg) in steps.items():
        x = torch.as_tensor(x).cuda()
        rows = {}
        for turn in (0, 1, 1, 0):
            label, nhwc = layouts[turn]
            model, opt = _model("cuda", torch.float32, weights, nhwc)
            _, prof = profile_request(
                f"layout_{label}_{what.split(',')[0].replace(' ', '_')}",
                lambda: train_step(model, opt, x, 1.0, eps=noise, **reg),
                5, out_dir, unit="step")
            rows.setdefault(label, []).append(prof)
        print(f"{what}, in turns NCHW, channels_last, channels_last, NCHW: "
              + "; ".join(
                  f"{label} host "
                  + "/".join(f"{p['host_ms']:.3f}" for p in ps)
                  + " ms, busy "
                  + "/".join(f"{p['busy_ms']:.3f}" for p in ps)
                  + " ms, events "
                  + "/".join(f"{p['events']:.1f}" for p in ps)
                  for label, ps in rows.items()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--render", type=int, default=80)
    ap.add_argument("--pairs", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_precision needs a CUDA device")
    from lie_vae_tpu_torch.cli import gen_spherecube
    images = gen_spherecube.generate(
        args.render, os.path.join(_ROOT, "build", "conv_precision",
                                  "sc-pairs"), pairs=True)[:2 * args.pairs]
    weights = compat.load_torch(_CHECKPOINT)
    eps = torch.randn((1, len(images), 3),
                      generator=torch.Generator().manual_seed(21))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(),
          f"torch {torch.__version__}, cuDNN "
          f"{torch.backends.cudnn.version()}, {len(images)} images")
    layer_table(weights, images, eps)
    step_shares(weights, images, eps)
    channel_noise(weights, images, eps)
    step_costs(weights, images, eps)


if __name__ == "__main__":
    main()
