"""Drive the PyTorch port's serving path, its training step and its
experiment CLI on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, each timed:

1. card: name and power limit (nvidia-smi), torch, CUDA and nvcc versions;
2. build: the Wigner chain kernels (csrc/wigner_chain.cu), the density
   kernels (csrc/so3_density.cu) and the synthesise-then-apply Wigner
   kernels (csrc/wigner_block.cu), one nvcc each, started together with
   three more that compile each source with ``-Xptxas -v`` to report each
   kernel's registers, stack frame and spills;
3. K1, the chain kernel without residuals, against the plain chain on the
   card over L in {0, 1, 3, 6, 10}, C in {1, 10, 16}, B in {1, 64, 4103},
   shared and per-sample spectra, transpose on and off; then both timed
   with CUDA events at the flagship shape (B = 64) and at B = 4096, and
   the kernel's device time taken from a CUDA graph of 20 launches;
4. K2, the chain forward with residuals and its backward kernel, against
   autograd of the plain chain over the same grid (and two wider shapes,
   C = 100 and C = 40): output, d angles, d spectrum for a random
   cotangent; timed as K1; then the three chain kernels at every degree
   from 0 to 16 and at C = 130 (two channel tiles) against the plain chain
   and its autograd, and each run twice on the same inputs, shared and
   per-sample spectra, C in {10, 100}, B in {64, 4103}, to repeat bit for
   bit;
5. K3 and K4, the wrapped SO(3) density and its backward, against the
   plain density and its autograd in float64: N in {1, 64, 4103, 65536}
   samples (the last as n = 4 samples of a batch of 16384), k in
   {0, 1, 10}, sigma from 1e-6 to pi * 10 / 2, v = 0 and |v| near
   multiples of 2 pi; timed at N = 64 and N = 4096;
6. K5 and K6, the synthesise-then-apply Wigner kernel and its backward
   (angles in, trig formed in the kernel; d angles and d spectrum out),
   against the plain version (``trig_features`` then
   ``wigner_block_apply_plain``) and its autograd over K1's grid: the
   output, K6's outputs, and the gradients through the autograd Function;
   then every degree from 0 to 16 at C in {3, 130}, and each run twice on
   the same inputs (8 cases) to repeat bit for bit; timed at B = 64 and
   B = 4096 (L = 6, C = 10, shared) with CUDA events, and by device time
   from a CUDA graph of 20 launches, for K5, K6 and the whole op forward
   and forward with backward;
7. serving: the flagship model with the converged reference weights
   (converged_state/torch_clean/best.pt), batch 64, on the card: warmup,
   sample, encode, reconstruct, geodesic and a ragged decode, checked for
   shape, finiteness, rotations and one kernel launch per decode chunk,
   then held against the same requests served on the CPU, and timed;
8. renders: 1024 poses of data_poses/spherecube.npz rendered with the
   port's ray-caster (``cli/gen_spherecube.py``) into chiprun_out/;
9. training, once with ``kernel_impl='fused'`` (K2, K3, K4) and once with
   ``'pallas'`` (K5, K6, K3, K4): the flagship model as ``bench.py``
   trains it (sigma clamp pi * 10 / 2; float32, TF32 off) from the same
   weights, fresh optimizer (lr 1e-3, clip 1e-5), beta 1, batch 64 of the
   renders: one step on the card against the same step on the CPU (loss,
   every gradient, parameters and BatchNorm statistics after it), then 20
   steps with finite losses and one launch per step of each kernel of the
   path and none of the other's, timed per step;
10. the CLI: ``cli.main.main`` with the flagship defaults and
   ``--kernel_impl pallas`` on the renders, two epochs, checkpoint and logs
   under chiprun_out/: every logged loss finite, K5, K6, K3 and K4 launched
   and K1, K2 not, the best checkpoint served by
   ``InferenceSession.from_checkpoint`` decoding fixed poses as the model
   it saved, and each test item's IW-LL finite and no lower than the mean
   of its own log-weights (Jensen's inequality); seconds per epoch.

The last lines are a JSON record of the kernels, the card line, and
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; it does so too without a CUDA card.
"""
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "converged_state", "torch_clean",
                          "best.pt")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOP_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
# kernel vs plain chain: both float32, sums in another order
KERNEL_TOL = 1e-5
# chain gradients vs autograd of the plain chain: sums of up to S*C (and,
# for a shared spectrum, B*S*C) float32 products in another order, held
# against the largest reference value
GRAD_TOL = 1e-4
# density kernels vs the plain density evaluated in float64 on the same
# inputs (in float32 the plain autograd is the less accurate of the two
# where sigma is small: dsigma sums terms of order 1 / sigma that cancel),
# as the JAX package pins its own kernels (tests/test_kernels.py): values,
# then gradients, a gradient row against its largest component
DENSITY_TOL = 1e-4
DENSITY_GRAD_TOL = 1e-3
# one training step on the card vs on the CPU, float32 with TF32 off: the
# loss and each gradient tensor against its largest value (ten conv layers
# summed in other orders); parameters absolutely (an Adam step moves each
# by at most lr = 1e-3, and a relative gradient error d moves that step by
# at most lr * d / 4); BatchNorm statistics against their largest value
LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
# (the check prints the largest: 7.7e-5 on an H100, the first conv's, whose
# sum runs over 65536 positions)
BIAS_TOL = 1e-3
PARAM_TOL = 1e-5
STATS_TOL = 1e-4
# The step is held against the exact one (float64 on the CPU), each
# quantity within its tolerance above plus ARBITER times the CPU's own
# float32 error against that exact step. From the converged weights on the
# real renders the float32 step loses digits on any device (a near-
# stationary point: gradients are sums that cancel, and Adam's first step
# g / (|g| + 1e-8) magnifies the error of the small ones): the CPU's float32
# step is 3.0e-5 from the exact one in the first conv's weights after the
# step and 9.0e-3 of max in the last hidden deconv's gradient, where images
# that the serving session decodes keep both below 4e-4.
ARBITER = 2.0
SIGMA_CLAMP = math.pi * 10 / 2
TRAIN_STEPS = 20
# the CLI phase: poses of data_poses/spherecube.npz rendered by the port,
# two epochs on them, and the IW-LL of a few test items
RENDER_POSES = 1024
DATA_DIR = os.path.join(ROOT, "chiprun_out", "smoke_data", "spherecube")
CLI_DIR = os.path.join(ROOT, "chiprun_out", "smoke_cli")
CLI_EPOCHS = 2
LL_SAMPLES = 20
LL_ITEMS = 8
# GPU vs CPU serving, float32 with TF32 off: ten conv layers whose sums run
# in other orders (cuDNN's algorithms against the CPU's)
IMAGE_TOL = 1e-3
POSE_TOL = 1e-3


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(fn, trials=20, per_trial=10):
    """Median over ``trials`` of the ms per call of ``fn``, each trial
    ``per_trial`` calls between two CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_trial):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_trial)
    return statistics.median(times)


def ptxas_report(text, source):
    """{kernel: (registers, stack bytes, spill stores, spill loads)} from
    ``nvcc -Xptxas -v`` on csrc/<source>.cu; a kernel is named by its kind
    and its degree cap, e.g. ``fwd_res<6>``."""
    report, name = {}, None
    for line in text.splitlines():
        m = re.search(rf"Compiling entry function '\S*?{source}_(fwd|bwd|"
                      r"sum)_kernel(?:ILi(\d+)E(?:Lb([01])E)?E)?", line)
        if m:
            kind, cap, res = m.groups()
            name = (kind + ("_res" if res == "1" else "")
                    + (f"<{cap}>" if cap else ""))
            report[name] = [None] * 4
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            report[name][1:] = [int(v) for v in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in report.items()}


def host_ms(fn, reps=20, warm=2):
    """Median host ms of ``fn``, which returns numpy (so it has synced)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def chain_bound(B, L, C, shared):
    """Least time for the chain on an H100 SXM, in ms, and what bounds it:
    each input read once and the output written once, against the float32
    operations (two J products of sum_l (2l+1)^2 C MACs and three
    z-rotations of 3 S C operations per sample)."""
    S = (L + 1) ** 2
    n_j = (L + 1) * (4 * (L + 1) ** 2 - 1) // 3
    spec = S * C * (1 if shared else B)
    nbytes = 4 * (3 * B + spec + n_j + B * S * C)
    flops = B * (2 * 2 * n_j * C + 3 * 3 * S * C)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def chain_res_bound(B, L, C, shared):
    """The chain with residuals: the chain's bytes plus y and z written."""
    S = (L + 1) ** 2
    n_j = (L + 1) * (4 * (L + 1) ** 2 - 1) // 3
    spec = S * C * (1 if shared else B)
    nbytes = 4 * (3 * B + spec + n_j + 3 * B * S * C)
    flops = B * (2 * 2 * n_j * C + 3 * 3 * S * C)
    return _bound(nbytes, flops)


def chain_bwd_bound(B, L, C, shared):
    """The chain backward: angles, x, J, y, z and dout read, dx (per sample)
    and d angles written; two J products, three z-rotations and three
    angle contractions (about 6 operations per element each)."""
    S = (L + 1) ** 2
    n_j = (L + 1) * (4 * (L + 1) ** 2 - 1) // 3
    spec = S * C * (1 if shared else B)
    nbytes = 4 * (3 * B + spec + n_j + 3 * B * S * C + B * S * C + 3 * B)
    flops = B * (2 * 2 * n_j * C + 3 * 3 * S * C + 3 * 6 * S * C)
    return _bound(nbytes, flops)


def density_bound(N, B, k, backward):
    """The wrapped density of N samples with sigma (B, 3): v and sigma read
    and log q written (backward: g read, dv and dsigma (N, 3) written);
    about 30 + 11 (2k+1) float32 operations per sample forward and
    60 + 17 (2k+1) backward, an exp counted as one."""
    shells = 2 * k + 1
    if backward:
        return _bound(4 * (3 * N + 3 * B + N + 6 * N), N * (60 + 17 * shells))
    return _bound(4 * (3 * N + 3 * B + N), N * (30 + 11 * shells))


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def block_bound(B, L, C, shared, backward):
    """K5 (or K6 with ``backward``) on an H100 SXM: the angles, the spectrum
    and the coefficients the kernels read (597 for L = 6) read once, the
    output written once (K6: dout read too; d angles and the per-sample d
    spectrum written), against the float32 operations per column: an FMA
    per coefficient and one per row of each coefficient block for d u, and
    two z-rotations of 6 operations per pair of rows (K6: two FMAs per
    coefficient, three per block row for w, dt and the scaled cotangent,
    three z-rotations and two angle contractions)."""
    from lie_vae_tpu_torch.ops.kernels.wigner_block import (c_offset,
                                                             coupled_blocks)
    S, nnz = (L + 1) ** 2, c_offset(L + 1)
    rows = sum(len(r) for l in range(L + 1) for s in range(2 * l + 1)
               for r, _ in coupled_blocks(l, s))
    pairs = L * (L + 1) // 2
    spec = S * C * (1 if shared else B)
    if backward:
        nbytes = 4 * (3 * B + spec + nnz + 2 * B * S * C + 3 * B)
        flops = B * C * (4 * nnz + 6 * rows + 26 * pairs)
    else:
        nbytes = 4 * (3 * B + spec + nnz + B * S * C)
        flops = B * C * (2 * nnz + 2 * rows + 12 * pairs)
    return _bound(nbytes, flops)


def plain_block(angles, spectrum, L, transpose=False):
    """The plain version of K5 from the angles: the trig features, then
    ``wigner_block_apply_plain``; autograd of it is the reference of the
    angle and spectrum gradients through the kernels' autograd Function."""
    from lie_vae_tpu_torch.ops.kernels.wigner_block import (
        trig_features, wigner_block_apply_plain)
    return wigner_block_apply_plain(*trig_features(angles, L), spectrum, L,
                                    transpose=transpose)


def check_block(L, angles, x, dout, tr):
    """K5's output and K6's (d angles, d spectrum) against the plain
    version and its autograd, and the same gradients through the autograd
    Function: (|K5 - plain|, its tolerance, K6's largest absolute error,
    the worst gradient error of max(1, max|ref|))."""
    from lie_vae_tpu_torch.ops.kernels import wigner_block
    got = wigner_block._launch(angles, x, L, tr)
    a, xx = angles.clone().requires_grad_(), x.clone().requires_grad_()
    ref = plain_block(a, xx, L, tr)
    want = torch.autograd.grad(ref, (a, xx), dout)
    dang, dspec = wigner_block._launch_backward(angles, x, dout, L, tr, True)
    k6 = (dang, dspec.sum(0) if x.dim() == 2 else dspec)
    a, xx = angles.clone().requires_grad_(), x.clone().requires_grad_()
    through = torch.autograd.grad(
        wigner_block.block_wigner_matrix_multiply_pallas(
            a, xx, L, transpose=tr), (a, xx), dout)
    if got.is_cuda:
        torch.cuda.synchronize()
    return ((got - ref).abs().max().item(),
            KERNEL_TOL * max(1.0, x.abs().max().item()),
            max(max_rel(g, w)[0] for g, w in zip(k6, want)),
            max(max_rel(g, w)[1] for g, w in zip(k6 + through, want + want)))


def check_rotations(R, what):
    R = np.asarray(R, np.float64).reshape(-1, 3, 3)
    orth = np.abs(np.swapaxes(R, -1, -2) @ R - np.eye(3)).max()
    det = np.linalg.det(R).min()
    print(f"   {what}: max|R^T R - I| {orth:.2e}, min det {det:.6f}")
    if not (orth < 1e-4 and det > 0):
        raise AssertionError(f"{what} are not rotations")


def check_images(x, shape, what):
    if x.shape != shape or not np.isfinite(x).all():
        raise AssertionError(f"{what}: shape {x.shape} (expected {shape}), "
                             f"finite {np.isfinite(x).all()}")


def density_inputs(n, B, seed):
    """v (n, B, 3) and sigma (B, 3), float32: sigma log-uniform in
    [1e-6, pi * 10 / 2] and v = eps * sigma. With B >= 9, rows 0 and 1 put
    sigma at both ends, rows 2-6 of the first sample put |v| at and near
    multiples of 2 pi (with sigma at least 0.5: a posterior near the sigma
    floor draws |v| near 0), and the last sample has v = 0 at row 7 and a
    tiny v at row 8."""
    rng = np.random.default_rng(seed)
    sigma = np.exp(rng.uniform(np.log(1e-6), np.log(SIGMA_CLAMP), (B, 3)))
    if B >= 9:
        sigma[0], sigma[1] = 1e-6, SIGMA_CLAMP
        sigma[2:7] = rng.uniform(0.5, SIGMA_CLAMP, (5, 3))
    v = rng.normal(size=(n, B, 3)) * sigma
    if B >= 9:
        axes = rng.normal(size=(5, 3))
        axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
        radii = np.array([2 * math.pi, 2 * math.pi + 1e-3,
                          4 * math.pi - 1e-2, 6 * math.pi, 0.3])
        v[0, 2:7] = axes * radii[:, None]
        v[-1, 7] = 0.0
        v[-1, 8] = [1e-5, -2e-5, 3e-6]
    return v.astype(np.float32), sigma.astype(np.float32)


def max_rel(got, want):
    """max |got - want| and its ratio to max(1, max |want|)."""
    err = (got - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def step_card_vs_cpu(weights, batch, eps, kernel_impl):
    """One flagship training step from ``weights`` on the uint8 ``batch``
    with the noise ``eps`` on the card in float32, and on the CPU in float32
    and in float64. The card is held against the exact (float64) step: loss,
    every gradient, the parameters and BatchNorm statistics after it, each
    within its stated tolerance plus twice the CPU's own float32 error
    against the same exact step (where float32 loses digits on this input,
    as at a near-stationary point, that error says by how much). Returns
    the card's model and optimizer."""
    from lie_vae_tpu_torch.models import flagship_model
    from lie_vae_tpu_torch.train import make_optimizer, train_step
    runs = {}
    for key, device, dtype in (("card", "cuda", torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("exact", "cpu", torch.float64)):
        model = flagship_model(device, sigma_clamp=SIGMA_CLAMP,
                               kernel_impl=kernel_impl)
        model.load_state_dict(weights, strict=True)
        model.to(dtype)
        opt = make_optimizer(model.named_parameters(), lr=1e-3,
                             clip_grads=1e-5)
        metrics = train_step(model, opt, torch.as_tensor(batch), 1.0,
                             eps=eps.to(dtype))
        runs[key] = (model, opt, metrics)
    (mg, opt_g, met_g), (mc, _, met_c), (me, _, met_e) = (
        runs["card"], runs["cpu"], runs["exact"])
    loss_g, loss_c, loss_e = (float(m["loss"]) for m in (met_g, met_c,
                                                        met_e))
    print(f"   one step: loss {loss_g:.6f} on the card, {loss_c:.6f} on the "
          f"CPU, {loss_e:.6f} exact (recon {float(met_e['recon']):.4f}, KL "
          f"{float(met_e['kl']):.4f})")
    if not abs(loss_g - loss_e) <= LOSS_TOL * abs(loss_e) \
            + ARBITER * abs(loss_c - loss_e):
        raise AssertionError(f"training loss {loss_g} on the card vs "
                             f"{loss_e} exact ({loss_c} on the CPU)")
    cpu_params = dict(mc.named_parameters())
    exact_params = dict(me.named_parameters())
    # a conv bias that feeds a BatchNorm has zero gradient in exact
    # arithmetic (the batch mean is subtracted): on both devices it must be
    # rounding, below BIAS_TOL of its conv weight's largest gradient
    enc = mg.encoder
    pre_bn = {f"encoder.{i}.bias" for i in range(len(enc) - 1)
              if isinstance(enc[i], torch.nn.Conv2d)
              and isinstance(enc[i + 1], torch.nn.BatchNorm2d)}

    def excess(card, cpu, exact, tol, scale):
        """max |card - exact| over tol + ARBITER max |cpu - exact|, and the
        card's and the CPU's errors against the exact value over
        ``scale``."""
        e_card = (card.detach().cpu().double() - exact.detach()).abs().max()
        e_cpu = (cpu.detach().double() - exact.detach()).abs().max()
        allowance = tol + ARBITER * e_cpu.item()
        ratio = e_card.item() / allowance if allowance > 0 else (
            0.0 if e_card.item() == 0 else math.inf)
        return ratio, e_card.item() / scale, e_cpu.item() / scale

    # per kind: worst share of the allowance, largest card and CPU errors
    worst = {"grad": [0.0] * 3, "param": [0.0] * 3, "stat": [0.0] * 3}
    worst_bias = 0.0

    def note(kind, name, res, what):
        if not res[0] <= 1.0:
            raise AssertionError(
                f"{what} of {name}: card {res[1]:.3e} from the exact step, "
                f"beyond its tolerance plus {ARBITER} x the CPU's float32 "
                f"error {res[2]:.3e} ({res[0]:.3f} of the allowance)")
        worst[kind] = [max(a, b) for a, b in zip(worst[kind], res)]

    for name, p in mg.named_parameters():
        ref, exact = cpu_params[name], exact_params[name]
        if name in pre_bn:
            w = exact_params[name[:-len("bias")] + "weight"].grad.abs().max()
            top = max(p.grad.abs().max().item(), ref.grad.abs().max().item())
            if not top <= BIAS_TOL * w.item():
                raise AssertionError(f"gradient of {name}: {top:.3e}, not "
                                     f"rounding against {w.item():.3e}")
            worst_bias = max(worst_bias, top / w.item())
        else:
            scale = exact.grad.abs().max().item()
            note("grad", name, excess(p.grad, ref.grad, exact.grad,
                                      TRAIN_GRAD_TOL * scale, scale),
                 "gradient")
        note("param", name, excess(p, ref, exact, PARAM_TOL, 1.0), "value")
    cpu_buffers = dict(mc.named_buffers())
    card_buffers = dict(mg.named_buffers())
    for name, b in me.named_buffers():
        card, ref = card_buffers[name], cpu_buffers[name]
        if name.endswith("num_batches_tracked"):
            if not int(card) == int(ref) == int(b):
                raise AssertionError(f"{name}: {int(card)} vs {int(b)}")
            continue
        scale = b.abs().max().item()
        note("stat", name, excess(card, ref, b, STATS_TOL * scale, scale),
             "running statistic")
    print(f"   against the exact step (gradients and statistics as a share "
          f"of each tensor's max, parameters absolute): "
          + "; ".join(f"{k}: card {v[1]:.3e}, CPU float32 {v[2]:.3e}, "
                      f"worst {v[0]:.3f} of the allowance"
                      for k, v in worst.items())
          + f"; the biases before BatchNorm at most {worst_bias:.3e} of "
          f"their weight's gradient (tol {BIAS_TOL})")
    return mg, opt_g


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() "
                 "is False")
    from lie_vae_tpu_torch import compat
    from lie_vae_tpu_torch.distributions.so3 import (
        so3_wrapped_log_density_plain)
    from lie_vae_tpu_torch.models import flagship_model
    from lie_vae_tpu_torch.ops import (group_matrix_to_eazyz,
                                       random_group_matrices)
    from lie_vae_tpu_torch.ops.kernels import _build
    from lie_vae_tpu_torch.ops.kernels import so3_density
    from lie_vae_tpu_torch.ops.kernels import wigner_block
    from lie_vae_tpu_torch.ops.kernels import wigner_fused
    from lie_vae_tpu_torch.ops.wigner import block_wigner_apply_zjz
    from lie_vae_tpu_torch.profile_serve import device_us
    from lie_vae_tpu_torch.serve import InferenceSession
    from lie_vae_tpu_torch.train import train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fused = wigner_fused.block_wigner_matrix_multiply_fused
    dens = so3_density.so3_wrapped_log_density_fused
    block = wigner_block.block_wigner_matrix_multiply_pallas
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    t0 = phase("card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    print(f"   {card}")
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s); {nvcc[-1]}; ninja: {shutil.which('ninja')}")
    done(t0)

    t0 = phase("build (one nvcc per source, all started together)")
    sources = ("wigner_chain", "so3_density", "wigner_block")
    cached = {n: os.path.exists(_build.library_path(n)) for n in sources}

    def timed_build(name):
        tb = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - tb

    def ptxas(name):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        return ptxas_report(subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS[:4], "-cubin", "-Xptxas",
             "-v", "-o", os.path.join(_build.BUILD_DIR, f"{name}.cubin"),
             os.path.join(_build.CSRC, f"{name}.cu")],
            capture_output=True, text=True, check=True).stderr, name)

    with ThreadPoolExecutor(2 * len(sources)) as pool:
        ptxas_runs = [pool.submit(ptxas, n) for n in sources]
        build_s = dict(zip(sources, pool.map(timed_build, sources)))
        ptxas_all = {n: r.result() for n, r in zip(sources, ptxas_runs)}
    for n in sources:
        print(f"   {n}: {build_s[n]:.2f} s "
              f"({'already built' if cached[n] else 'nvcc'}) -> "
              f"{_build.library_path(n)}")
        print(f"   {n}.cu, ptxas (registers, stack frame, spill stores, "
              "spill loads in bytes): " + "; ".join(
                  f"{k} {v}" for k, v in ptxas_all[n].items()))
    done(t0)

    t0 = phase("K1: Wigner chain kernel vs plain chain on the card")
    gen = torch.Generator(device="cpu").manual_seed(0)
    worst = 0.0
    for L in (0, 1, 3, 6, 10):
        S = (L + 1) ** 2
        worst_l, n = 0.0, 0
        for C in (1, 10, 16):
            for B in (1, 64, 4103):
                angles = group_matrix_to_eazyz(random_group_matrices(
                    B, gen, device="cpu").to(dev)).contiguous()
                for shared in (True, False):
                    shape = (S, C) if shared else (B, S, C)
                    x = torch.randn(shape, generator=gen).to(dev)
                    for tr in (False, True):
                        got = fused(angles, x, L, transpose=tr)
                        ref = block_wigner_apply_zjz(angles, x, L,
                                                     transpose=tr)
                        torch.cuda.synchronize()
                        err = (got - ref).abs().max().item()
                        tol = KERNEL_TOL * max(1.0, x.abs().max().item())
                        if not err <= tol:
                            raise AssertionError(
                                f"kernel != plain: L={L} C={C} B={B} "
                                f"shared={shared} transpose={tr}: "
                                f"{err:.3e} > {tol:.3e}")
                        worst_l = max(worst_l, err)
                        n += 1
        worst = max(worst, worst_l)
        print(f"   L={L:2d}: {n} cases, max |kernel - plain| {worst_l:.3e}")

    item_rep = torch.randn((49, 10), generator=gen).to(dev)
    timing = {}
    for B in (64, 4096):
        angles = group_matrix_to_eazyz(
            random_group_matrices(B, gen, device="cpu").to(dev)).contiguous()
        with torch.inference_mode():
            k_ms = cuda_ms(lambda: fused(angles, item_rep, 6))
            p_ms = cuda_ms(lambda: block_wigner_apply_zjz(angles, item_rep,
                                                          6))
            k_us = device_us(lambda: fused(angles, item_rep, 6))
        bound, bound_by = chain_bound(B, 6, 10, shared=True)
        timing[B] = (k_ms, p_ms, bound, bound_by, k_us)
        print(f"   B={B} L=6 C=10 shared: kernel {k_ms:.4f} ms (device "
              f"{k_us:.2f} us), plain {p_ms:.4f} ms, bound {bound:.6f} ms "
              f"({bound_by})")
    done(t0)

    t0 = phase("K2: chain with residuals and its backward kernel vs "
               "autograd of the plain chain on the card")
    k2_err = {"fwd": 0.0, "bwd": 0.0}
    cases = [(L, C, B) for L in (0, 1, 3, 6, 10) for C in (1, 10, 16)
             for B in (1, 64, 4103)] + [(6, 100, 5), (10, 40, 64)]
    per_l = {}
    for L, C, B in cases:
        S = (L + 1) ** 2
        angles = group_matrix_to_eazyz(random_group_matrices(
            B, gen, device="cpu").to(dev)).contiguous()
        for shared in (True, False):
            x = torch.randn((S, C) if shared else (B, S, C),
                            generator=gen).to(dev)
            dout = torch.randn((B, S, C), generator=gen).to(dev)
            for tr in (False, True):
                res = []
                for fn in (fused, block_wigner_apply_zjz):
                    a = angles.clone().requires_grad_()
                    xx = x.clone().requires_grad_()
                    out = fn(a, xx, L, transpose=tr)
                    res.append((out.detach(),) + torch.autograd.grad(
                        out, (a, xx), dout))
                (o1, da1, dx1), (o2, da2, dx2) = res
                e_out = (o1 - o2).abs().max().item()
                tol_out = KERNEL_TOL * max(1.0, x.abs().max().item())
                e_a, r_a = max_rel(da1, da2)
                e_x, r_x = max_rel(dx1, dx2)
                if not (e_out <= tol_out and r_a <= GRAD_TOL
                        and r_x <= GRAD_TOL):
                    raise AssertionError(
                        f"K2 != plain: L={L} C={C} B={B} shared={shared} "
                        f"transpose={tr}: out {e_out:.3e} (tol "
                        f"{tol_out:.3e}), d angles {r_a:.3e}, d spectrum "
                        f"{r_x:.3e} of max(1, max|ref|) (tol {GRAD_TOL})")
                k2_err["fwd"] = max(k2_err["fwd"], e_out)
                k2_err["bwd"] = max(k2_err["bwd"], e_a, e_x)
                w = per_l.setdefault((L, C > 16), [0, 0.0, 0.0])
                w[0] += 1
                w[1] = max(w[1], e_out)
                w[2] = max(w[2], r_a, r_x)
    for (L, wide), (n, e_out, r_grad) in sorted(per_l.items()):
        print(f"   L={L:2d}{' C>16' if wide else ''}: {n} "
              f"cases, max |out - plain| {e_out:.3e}, max grad error "
              f"{r_grad:.3e} of max(1, max|ref|)")
    k2_timing, chain_us = {}, {}
    for B in (64, 4096):
        angles = group_matrix_to_eazyz(
            random_group_matrices(B, gen, device="cpu").to(dev)).contiguous()
        dout = torch.randn((B, 49, 10), generator=gen).to(dev)
        _, y, z = wigner_fused._launch_residuals(angles, item_rep, 6)
        f_ms = cuda_ms(lambda: wigner_fused._launch_residuals(
            angles, item_rep, 6))
        b_ms = cuda_ms(lambda: wigner_fused._launch_backward(
            angles, item_rep, y, z, dout, 6, True))
        a = angles.clone().requires_grad_()
        xx = item_rep.clone().requires_grad_()
        pf_ms = cuda_ms(lambda: block_wigner_apply_zjz(a, xx, 6))
        ref = block_wigner_apply_zjz(a, xx, 6)
        pb_ms = cuda_ms(lambda: torch.autograd.grad(ref, (a, xx), dout,
                                                    retain_graph=True))
        fb = chain_res_bound(B, 6, 10, shared=True)
        bb = chain_bwd_bound(B, 6, 10, shared=True)
        k2_timing[B] = (f_ms, pf_ms, fb, b_ms, pb_ms, bb)
        chain_us[B] = (
            device_us(lambda: wigner_fused._launch_residuals(
                angles, item_rep, 6)),
            device_us(lambda: wigner_fused._launch_backward(
                angles, item_rep, y, z, dout, 6, True)))
        print(f"   B={B} L=6 C=10 shared: forward with residuals {f_ms:.4f} "
              f"ms (device {chain_us[B][0]:.2f} us; plain with grad "
              f"{pf_ms:.4f}, bound {fb[0]:.6f} {fb[1]}); backward "
              f"{b_ms:.4f} ms (device {chain_us[B][1]:.2f} us; plain "
              f"autograd {pb_ms:.4f}, bound {bb[0]:.6f} {bb[1]})")

    # every degree the kernels take, and a spectrum wider than one channel
    # tile (128), against the plain chain and its autograd; drawn from a
    # generator of their own, so the later phases' inputs do not depend on
    # these checks
    gen_deg = torch.Generator(device="cpu").manual_seed(7)
    worst_deg = [0.0, 0.0]
    for L in range(wigner_fused.MAX_DEGREE + 1):
        S = (L + 1) ** 2
        for C in (3, 130):
            angles = group_matrix_to_eazyz(random_group_matrices(
                5, gen_deg, device="cpu").to(dev)).contiguous()
            dout = torch.randn((5, S, C), generator=gen_deg).to(dev)
            for shared in (True, False):
                x = torch.randn((S, C) if shared else (5, S, C),
                                generator=gen_deg).to(dev)
                got = fused(angles, x, L)
                res = []
                for fn in (fused, block_wigner_apply_zjz):
                    a = angles.clone().requires_grad_()
                    xx = x.clone().requires_grad_()
                    out = fn(a, xx, L)
                    res.append((out.detach(),) + torch.autograd.grad(
                        out, (a, xx), dout))
                e_out = max((got - res[1][0]).abs().max().item(),
                            (res[0][0] - res[1][0]).abs().max().item())
                r_grad = max(max_rel(g, w)[1]
                             for g, w in zip(res[0][1:], res[1][1:]))
                tol_out = KERNEL_TOL * max(1.0, x.abs().max().item())
                if not (e_out <= tol_out and r_grad <= GRAD_TOL):
                    raise AssertionError(
                        f"chain kernels != plain: L={L} C={C} B=5 "
                        f"shared={shared}: out {e_out:.3e} (tol "
                        f"{tol_out:.3e}), gradients {r_grad:.3e} (tol "
                        f"{GRAD_TOL})")
                worst_deg = [max(worst_deg[0], e_out),
                             max(worst_deg[1], r_grad)]
    print(f"   L=0..{wigner_fused.MAX_DEGREE}, C in (3, 130), B=5, shared and "
          f"per-sample: max |out - plain| {worst_deg[0]:.3e}, max grad error "
          f"{worst_deg[1]:.3e} of max(1, max|ref|)")

    # the same inputs twice give the same bits: fixed-order sums, no atomics
    n_rep = 0
    for shared in (True, False):
        for C in (10, 100):
            for B in (64, 4103):
                angles = group_matrix_to_eazyz(random_group_matrices(
                    B, gen_deg, device="cpu").to(dev)).contiguous()
                x = torch.randn((49, C) if shared else (B, 49, C),
                                generator=gen_deg).to(dev)
                dout = torch.randn((B, 49, C), generator=gen_deg).to(dev)
                runs = []
                for _ in range(2):
                    out = wigner_fused._launch(angles, x, 6)
                    res = wigner_fused._launch_residuals(angles, x, 6)
                    grads = wigner_fused._launch_backward(
                        angles, x, res[1], res[2], dout, 6, True)
                    runs.append((out,) + res + grads)
                same = [torch.equal(p, q) for p, q in zip(*runs)]
                if not all(same):
                    raise AssertionError(
                        f"chain kernels differ between two runs (out, out, "
                        f"y, z, dx, dangles: {same}): shared={shared} C={C} "
                        f"B={B}")
                n_rep += 1
    print(f"   K1, K2 forward and backward repeat bit for bit: {n_rep} "
          "cases (L=6; shared and per-sample, C in (10, 100), B in (64, "
          "4103))")
    done(t0)

    t0 = phase("K3/K4: wrapped SO(3) density and its backward vs the plain "
               "density and its autograd on the card")
    d_err = {"fwd": 0.0, "bwd": 0.0}
    for n, B in ((1, 1), (1, 64), (1, 4103), (4, 16384)):
        worst_v, worst_g = 0.0, 0.0
        for k in (0, 1, 10):
            v, sigma = density_inputs(n, B, seed=10 * k + n)
            g = torch.randn((n, B), generator=gen).to(dev)
            res = []
            for fn, dtype in ((dens, torch.float32),
                              (so3_wrapped_log_density_plain, torch.float64)):
                vt = torch.tensor(v, dtype=dtype, device=dev,
                                  requires_grad=True)
                st = torch.tensor(sigma, dtype=dtype, device=dev,
                                  requires_grad=True)
                out = fn(vt, st, k)
                res.append(tuple(t.double() for t in (out.detach(),) +
                                 torch.autograd.grad(out, (vt, st),
                                                     g.to(dtype))))
            (o1, dv1, ds1), (o2, dv2, ds2) = res
            excess = ((o1 - o2).abs()
                      / (DENSITY_TOL * (1.0 + o2.abs()))).max().item()
            gx = max(((a - b).abs().amax(-1) / (
                DENSITY_GRAD_TOL * (1.0 + b.abs().amax(-1)))).max().item()
                for a, b in ((dv1, dv2), (ds1, ds2)))
            if not (excess <= 1.0 and gx <= 1.0):
                raise AssertionError(
                    f"K3/K4 != plain: n={n} B={B} k={k}: value error "
                    f"{excess:.3f} of its tolerance, gradient error "
                    f"{gx:.3f} of its tolerance")
            d_err["fwd"] = max(d_err["fwd"], (o1 - o2).abs().max().item())
            d_err["bwd"] = max(d_err["bwd"], (dv1 - dv2).abs().max().item(),
                               (ds1 - ds2).abs().max().item())
            worst_v, worst_g = max(worst_v, excess), max(worst_g, gx)
        print(f"   N={n * B} (n={n}, B={B}), k in (0, 1, 10): worst value "
              f"error {worst_v:.3f}, worst gradient error {worst_g:.3f} of "
              "the tolerance")
    d_timing = {}
    for N in (64, 4096):
        v, sigma = density_inputs(1, N, seed=99)
        vf = torch.tensor(v, device=dev).reshape(N, 3)
        st = torch.tensor(sigma, device=dev)
        g = torch.randn((N,), generator=gen).to(dev)
        f_ms = cuda_ms(lambda: so3_density._launch_fwd(vf, st, 10, 1e-3))
        b_ms = cuda_ms(lambda: so3_density._launch_bwd(vf, st, g, 10, 1e-3))
        vr = torch.tensor(v, device=dev, requires_grad=True)
        sr = torch.tensor(sigma, device=dev, requires_grad=True)
        pf_ms = cuda_ms(lambda: so3_wrapped_log_density_plain(vr, sr, 10))
        ref = so3_wrapped_log_density_plain(vr, sr, 10)
        pb_ms = cuda_ms(lambda: torch.autograd.grad(
            ref, (vr, sr), g.view(1, N), retain_graph=True))
        fb = density_bound(N, N, 10, backward=False)
        bb = density_bound(N, N, 10, backward=True)
        d_timing[N] = (f_ms, pf_ms, fb, b_ms, pb_ms, bb)
        print(f"   N=B={N} k=10: forward {f_ms:.4f} ms (plain with grad "
              f"{pf_ms:.4f}, bound {fb[0]:.6f} {fb[1]}); backward "
              f"{b_ms:.4f} ms (plain autograd {pb_ms:.4f}, bound "
              f"{bb[0]:.6f} {bb[1]})")
    done(t0)

    t0 = phase("K5/K6: synthesise-then-apply Wigner kernel and its backward "
               "vs the plain version and its autograd on the card")
    k5_err = {"fwd": 0.0, "bwd": 0.0}

    for L in (0, 1, 3, 6, 10):
        S = (L + 1) ** 2
        n, worst_f, worst_g = 0, 0.0, 0.0
        for C in (1, 10, 16):
            for B in (1, 64, 4103):
                angles = group_matrix_to_eazyz(random_group_matrices(
                    B, gen, device="cpu").to(dev)).contiguous()
                for shared in (True, False):
                    x = torch.randn((S, C) if shared else (B, S, C),
                                    generator=gen).to(dev)
                    dout = torch.randn((B, S, C), generator=gen).to(dev)
                    for tr in (False, True):
                        e_out, tol_out, e_k6, r_grad = check_block(
                            L, angles, x, dout, tr)
                        if not (e_out <= tol_out and r_grad <= GRAD_TOL):
                            raise AssertionError(
                                f"K5/K6 != plain: L={L} C={C} B={B} "
                                f"shared={shared} transpose={tr}: out "
                                f"{e_out:.3e} (tol {tol_out:.3e}), K6 and "
                                f"the gradients through the Function "
                                f"{r_grad:.3e} of max(1, max|ref|) (tol "
                                f"{GRAD_TOL})")
                        k5_err["fwd"] = max(k5_err["fwd"], e_out)
                        k5_err["bwd"] = max(k5_err["bwd"], e_k6)
                        worst_f = max(worst_f, e_out)
                        worst_g = max(worst_g, r_grad)
                        n += 1
        print(f"   L={L:2d}: {n} cases, max |K5 - plain| {worst_f:.3e}, "
              f"max K6 / gradient error {worst_g:.3e} of max(1, max|ref|)")

    # every degree the kernels take (above 10 their rolled loops), and a
    # spectrum wider than one channel tile, from a generator of their own
    worst_deg = [0.0, 0.0]
    for L in range(wigner_block.MAX_DEGREE + 1):
        S = (L + 1) ** 2
        for C in (3, 130):
            angles = group_matrix_to_eazyz(random_group_matrices(
                5, gen_deg, device="cpu").to(dev)).contiguous()
            dout = torch.randn((5, S, C), generator=gen_deg).to(dev)
            for shared in (True, False):
                x = torch.randn((S, C) if shared else (5, S, C),
                                generator=gen_deg).to(dev)
                for tr in (False, True):
                    e_out, tol_out, _, r_grad = check_block(L, angles, x,
                                                           dout, tr)
                    if not (e_out <= tol_out and r_grad <= GRAD_TOL):
                        raise AssertionError(
                            f"K5/K6 != plain: L={L} C={C} B=5 "
                            f"shared={shared} transpose={tr}: out "
                            f"{e_out:.3e} (tol {tol_out:.3e}), gradients "
                            f"{r_grad:.3e} (tol {GRAD_TOL})")
                    worst_deg = [max(worst_deg[0], e_out),
                                 max(worst_deg[1], r_grad)]
    print(f"   L=0..{wigner_block.MAX_DEGREE}, C in (3, 130), B=5, shared and "
          f"per-sample, transpose on and off: max |K5 - plain| "
          f"{worst_deg[0]:.3e}, max K6 / gradient error {worst_deg[1]:.3e} "
          f"of max(1, max|ref|)")

    # the same inputs twice give the same bits: fixed-order sums, no atomics
    n_rep = 0
    for shared in (True, False):
        for C in (10, 100):
            for B in (64, 4103):
                angles = group_matrix_to_eazyz(random_group_matrices(
                    B, gen_deg, device="cpu").to(dev)).contiguous()
                x = torch.randn((49, C) if shared else (B, 49, C),
                                generator=gen_deg).to(dev)
                dout = torch.randn((B, 49, C), generator=gen_deg).to(dev)
                runs = [(wigner_block._launch(angles, x, 6, False),)
                        + wigner_block._launch_backward(angles, x, dout, 6,
                                                        False, True)
                        for _ in range(2)]
                same = [torch.equal(p, q) for p, q in zip(*runs)]
                if not all(same):
                    raise AssertionError(
                        f"K5/K6 differ between two runs (out, dangles, "
                        f"dspec: {same}): shared={shared} C={C} B={B}")
                n_rep += 1
    print(f"   K5 and K6 repeat bit for bit: {n_rep} cases (L=6; shared and "
          "per-sample, C in (10, 100), B in (64, 4103))")

    k5_timing, block_us, op_us = {}, {}, {}
    for B in (64, 4096):
        angles = group_matrix_to_eazyz(
            random_group_matrices(B, gen, device="cpu").to(dev)).contiguous()
        dout = torch.randn((B, 49, 10), generator=gen).to(dev)
        f_ms = cuda_ms(lambda: wigner_block._launch(angles, item_rep, 6,
                                                    False))
        b_ms = cuda_ms(lambda: wigner_block._launch_backward(
            angles, item_rep, dout, 6, False, True))
        a = angles.clone().requires_grad_()
        xx = item_rep.clone().requires_grad_()
        pf_ms = cuda_ms(lambda: plain_block(a, xx, 6))
        ref = plain_block(a, xx, 6)
        pb_ms = cuda_ms(lambda: torch.autograd.grad(ref, (a, xx), dout,
                                                    retain_graph=True))
        fb = block_bound(B, 6, 10, True, False)
        bb = block_bound(B, 6, 10, True, True)
        k5_timing[B] = (f_ms, pf_ms, fb, b_ms, pb_ms, bb)
        block_us[B] = (
            device_us(lambda: wigner_block._launch(angles, item_rep, 6,
                                                   False)),
            device_us(lambda: wigner_block._launch_backward(
                angles, item_rep, dout, 6, False, True)))
        # the whole op a model calls: forward, and forward with backward
        # (on leaves of its own: a capture fails where the leaves' autograd
        # state was first made by the plain version on the default stream)
        op_us[f"fwd_b{B}"] = device_us(lambda: block(angles, item_rep, 6))
        a_op = angles.clone().requires_grad_()
        x_op = item_rep.clone().requires_grad_()
        op_us[f"fwd_bwd_b{B}"] = device_us(lambda: torch.autograd.grad(
            block(a_op, x_op, 6), (a_op, x_op), dout))
        print(f"   B={B} L=6 C=10 shared: K5 {f_ms:.4f} ms (device "
              f"{block_us[B][0]:.2f} us; plain with grad {pf_ms:.4f}, bound "
              f"{fb[0]:.6f} {fb[1]}); K6 {b_ms:.4f} ms (device "
              f"{block_us[B][1]:.2f} us; plain autograd {pb_ms:.4f}, bound "
              f"{bb[0]:.6f} {bb[1]}); the op, device us: forward "
              f"{op_us[f'fwd_b{B}']:.2f}, forward and backward "
              f"{op_us[f'fwd_bwd_b{B}']:.2f}")
    done(t0)

    t0 = phase("serving: flagship, converged weights, batch 64, on the card")
    sess = InferenceSession.from_torch(CHECKPOINT, flagship_model(),
                                       batch_size=64, seed=0)
    fused.launches = 0
    steps = []

    def run(name, fn, chunks):
        before = fused.launches
        out = fn()
        steps.append((name, fused.launches - before, chunks))
        return out

    run("warmup", sess.warmup, 2)
    imgs = run("sample(64)", lambda: sess.sample(64), 1)
    enc = run("encode(64)", lambda: sess.encode(imgs), 0)
    rec = run("reconstruct(64)", lambda: sess.reconstruct(imgs), 1)
    pa, pb = enc["pose"][0], enc["pose"][1]
    geo = run("geodesic(16)", lambda: sess.geodesic(pa, pb, steps=16), 1)
    geo_poses = sess.geodesic(pa, pb, steps=16, decode=False)
    poses100 = np.concatenate([enc["pose"], enc["sample"][:36]])
    dec = run("decode(100)", lambda: sess.decode(poses100), 2)
    launches = fused.launches
    for name, got, want in steps:
        print(f"   {name}: {got} kernel launch(es), {want} decode chunk(s)")
        if got != want:
            raise AssertionError(f"{name}: {got} Wigner kernel launches, "
                                 f"expected one per decode chunk ({want})")
    if launches == 0:
        raise AssertionError("the serving path never launched the kernel")

    img = (64, 64, 3)
    check_images(imgs, (64,) + img, "sample")
    check_images(rec, (64,) + img, "reconstruct")
    check_images(geo, (16,) + img, "geodesic")
    check_images(dec, (100,) + img, "decode")
    if enc["sigma"].shape != (64, 3) or not np.isfinite(enc["sigma"]).all():
        raise AssertionError(f"encode sigma {enc['sigma'].shape}")
    check_rotations(enc["pose"], "encode poses")
    check_rotations(enc["sample"], "encode samples")
    check_rotations(geo_poses, "geodesic poses")

    cpu = InferenceSession.from_torch(CHECKPOINT, flagship_model("cpu"),
                                      batch_size=64, seed=0, device="cpu")
    cpu.warmup()
    c_imgs = cpu.sample(64)
    c_enc = cpu.encode(imgs)
    c_rec = cpu.reconstruct(imgs)
    c_geo = cpu.geodesic(pa, pb, steps=16)
    c_dec = cpu.decode(poses100)
    d_img = max(np.abs(a - b).max() for a, b in (
        (imgs, c_imgs), (rec, c_rec), (geo, c_geo), (dec, c_dec)))
    d_pose = max(np.abs(enc[k] - c_enc[k]).max()
                 for k in ("pose", "sigma", "sample"))
    print(f"   GPU vs CPU session: max |image diff| {d_img:.3e} (tol "
          f"{IMAGE_TOL}), max |pose/sigma diff| {d_pose:.3e} (tol "
          f"{POSE_TOL})")
    if not (d_img <= IMAGE_TOL and d_pose <= POSE_TOL):
        raise AssertionError("GPU serving disagrees with CPU serving")

    req = {"encode": lambda: sess.encode(imgs),
           "decode": lambda: sess.decode(enc["pose"]),
           "reconstruct": lambda: sess.reconstruct(imgs)}
    req_ms = {k: host_ms(fn) for k, fn in req.items()}
    print("   ms per request of 64 (host clock, numpy in and out): "
          + ", ".join(f"{k} {v:.3f}" for k, v in req_ms.items()))
    done(t0)

    t0 = phase("renders: sphere-cube poses of data_poses/spherecube.npz with "
               "the port's renderer")
    from lie_vae_tpu_torch.cli import gen_spherecube
    tr0 = time.perf_counter()
    renders = gen_spherecube.generate(
        RENDER_POSES, DATA_DIR,
        from_poses=os.path.join(ROOT, "data_poses", "spherecube.npz"))
    render_s = time.perf_counter() - tr0
    if renders.shape != (RENDER_POSES, 64, 64, 3) or renders.max() == 0:
        raise AssertionError(f"renders {renders.shape}, max {renders.max()}")
    print(f"   {RENDER_POSES} renders in {render_s:.2f} s -> {DATA_DIR}")
    done(t0)

    weights = compat.load_torch(CHECKPOINT)
    batch = renders[:64]
    counters = ((fused, "launches"), (fused, "launches_residuals"),
                (fused, "launches_backward"), (dens, "launches"),
                (dens, "launches_backward"), (block, "launches"),
                (block, "launches_backward"))

    def counts():
        prefix = {id(fused): "", id(dens): "density_", id(block): "block_"}
        return {prefix[id(obj)] + attr: getattr(obj, attr)
                for obj, attr in counters}

    train_runs = {}
    for impl, want in (("fused", [0, 1, 1, 1, 1, 0, 0]),
                       ("pallas", [0, 0, 0, 1, 1, 1, 1])):
        t0 = phase(f"training, kernel_impl={impl!r}: flagship as bench.py "
                   "trains it, batch 64 of the renders, beta 1")
        eps = torch.randn((1, 64, 3),
                          generator=torch.Generator().manual_seed(2))
        for obj, attr in counters:
            setattr(obj, attr, 0)
        mg, opt_g = step_card_vs_cpu(weights, batch, eps, impl)
        delta = [getattr(obj, attr) for obj, attr in counters]
        if delta != want:
            raise AssertionError(
                f"launches in the card's step (K1, K2 forward, K2 backward, "
                f"K3, K4, K5, K6): {delta}, expected {want}")
        for obj, attr in counters:
            setattr(obj, attr, 0)
        x_dev = torch.as_tensor(batch, device=dev)
        noise = torch.Generator().manual_seed(3)
        losses, step_ms = [], []
        for _ in range(TRAIN_STEPS):
            before = [getattr(obj, attr) for obj, attr in counters]
            ts = time.perf_counter()
            metrics = train_step(mg, opt_g, x_dev, 1.0, generator=noise)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - ts))
            delta = [getattr(obj, attr) - b
                     for (obj, attr), b in zip(counters, before)]
            if delta != want:
                raise AssertionError(
                    f"launches in one step (K1, K2 forward, K2 backward, "
                    f"K3, K4, K5, K6): {delta}, expected {want}")
            losses.append(metrics["loss"])
        losses = torch.stack(losses).cpu()
        if not torch.isfinite(losses).all():
            raise AssertionError(f"non-finite training loss: "
                                 f"{losses.tolist()}")
        train_ms = statistics.median(step_ms[2:])
        train_runs[impl] = (train_ms, step_ms[:2], losses, counts())
        print(f"   {TRAIN_STEPS} steps: losses {losses[0]:.4f} .. "
              f"{losses[-1]:.4f}, all finite; launches per step (K1, K2 "
              f"forward, K2 backward, K3, K4, K5, K6) {want}")
        print(f"   ms per step (host clock, synchronised, median of steps "
              f"3-{TRAIN_STEPS}): {train_ms:.3f}; first two "
              f"{step_ms[0]:.3f}, {step_ms[1]:.3f}")
        done(t0)
    print(f"   ms per step, kernel_impl 'pallas' {train_runs['pallas'][0]:.3f}"
          f" vs 'fused' {train_runs['fused'][0]:.3f}")

    t0 = phase("the CLI on the card: python -m lie_vae_tpu_torch.cli.main "
               "--kernel_impl pallas, flagship defaults, the renders")
    from lie_vae_tpu_torch.cli import main as cli_main
    from lie_vae_tpu_torch.train import UnsupervisedExperiment
    from lie_vae_tpu_torch.train.checkpoint import load_checkpoint
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    epoch_s = []
    train_epoch = UnsupervisedExperiment.train

    def timed_epoch(self, epoch):
        te = time.perf_counter()
        train_epoch(self, epoch)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - te)

    UnsupervisedExperiment.train = timed_epoch
    for obj, attr in counters:
        setattr(obj, attr, 0)
    try:
        experiment = cli_main.main([
            "--kernel_impl", "pallas", "--data_dir", DATA_DIR,
            "--epochs", str(CLI_EPOCHS), "--save_dir", CLI_DIR,
            "--log_dir", os.path.join(CLI_DIR, "logs"),
            "--ll_samples", str(LL_SAMPLES), "--ll_max_items",
            str(LL_ITEMS)])
    finally:
        UnsupervisedExperiment.train = train_epoch
    cli_launches = counts()
    print(f"   launches in the CLI run: {cli_launches}")
    if min(block.launches, block.launches_backward, dens.launches,
           dens.launches_backward) == 0 or max(
            fused.launches, fused.launches_residuals,
            fused.launches_backward) != 0:
        raise AssertionError("the CLI run with --kernel_impl pallas did not "
                             "go through K5, K6, K3 and K4 alone")
    with open(os.path.join(CLI_DIR, "logs", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [r["value"] for r in logged if r["tag"].endswith("_loss")]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"CLI losses: {losses}")
    print(f"   {len(losses)} logged losses, all finite: "
          + ", ".join(f"{r['tag']} {r['value']:.3f} (it {r['step']})"
                      for r in logged if r["tag"].endswith("_loss")))
    print("   seconds per epoch: " + ", ".join(f"{t:.2f}" for t in epoch_s))
    ckpt_path = os.path.join(CLI_DIR, cli_main.CHECKPOINT)
    ckpt = load_checkpoint(ckpt_path)
    final_step = experiment.optimizer.count
    ref_model = experiment.model
    if ckpt["step"] != final_step:
        ref_model = flagship_model(kernel_impl="pallas")
        ref_model.load_state_dict(ckpt["model"], strict=True)
    ref_model.eval()
    csess = InferenceSession.from_checkpoint(
        ckpt_path, flagship_model(kernel_impl="pallas"), batch_size=64)
    fixed = random_group_matrices(
        16, torch.Generator().manual_seed(4), device="cpu").numpy()
    with torch.inference_mode():
        want_img = ref_model.decode(
            torch.as_tensor(fixed, device=dev)[None])[0]
    before = (block.launches, fused.launches)
    got_img = csess.decode(fixed)
    if (block.launches - before[0], fused.launches - before[1]) != (1, 0):
        raise AssertionError("a decode chunk of the served checkpoint did "
                             "not launch K5 once and K1 never")
    d_ckpt = np.abs(got_img - want_img.cpu().numpy()).max()
    source = "experiment" if ref_model is experiment.model else "checkpoint"
    print(f"   best checkpoint: step {ckpt['step']} of {final_step}; "
          f"InferenceSession.from_checkpoint decodes 16 fixed poses (one "
          f"chunk, one launch of K5) within {d_ckpt:.3e} of the {source}'s "
          "model")
    if not d_ckpt <= 1e-5:
        raise AssertionError("the served checkpoint decodes otherwise than "
                             "the experiment's model")
    ll = experiment.last_ll
    if ll is None or len(ll["items"]) != LL_ITEMS:
        raise AssertionError(f"IW-LL items: {ll}")
    gap = ll["items"] - ll["mean_log_weights"]
    if not (np.isfinite(ll["items"]).all() and (gap >= 0).all()):
        raise AssertionError(f"IW-LL {ll['items']} against the mean "
                             f"log-weights {ll['mean_log_weights']}")
    print(f"   IW-LL over {LL_ITEMS} items, n={LL_SAMPLES}: mean "
          f"{ll['items'].mean():.3f}, each finite and above the mean of its "
          f"own log-weights by {gap.min():.3f} .. {gap.max():.3f}")
    done(t0)

    k64, p64, b64, by64, us64 = timing[64]
    k4k, p4k, b4k, _, us4k = timing[4096]
    src_chain = "lie_vae_tpu_torch/csrc/wigner_chain.cu"
    src_dens = "lie_vae_tpu_torch/csrc/so3_density.cu"
    src_block = "lie_vae_tpu_torch/csrc/wigner_block.cu"
    train_launches = train_runs["fused"][3]
    kernels = [{
        "name": "wigner_chain_fwd", "route": "cuda", "source": src_chain,
        "replaces": "lie_vae_tpu/ops/kernels/wigner_fused.py:127",
        "launches": launches, "max_abs_err": worst,
        "ms": k64, "plain_ms": p64, "bound_ms": b64, "bound_by": by64,
        "library_ms": None,
        "shape": "B=64 L=6 C=10 shared",
        "ms_b4096": k4k, "plain_ms_b4096": p4k, "bound_ms_b4096": b4k,
        "device_us": us64, "device_us_b4096": us4k}]
    chain_dev = {"wigner_chain_fwd_res": 0, "wigner_chain_bwd": 1}
    block_dev = {"wigner_block_fwd": 0, "wigner_block_bwd": 1}
    for name, src, replaces, tim, err, launch_key, shape, big in (
            ("wigner_chain_fwd_res", src_chain,
             "lie_vae_tpu/ops/kernels/wigner_fused.py:127", k2_timing,
             k2_err["fwd"], "launches_residuals", "B=64 L=6 C=10 shared",
             4096),
            ("wigner_chain_bwd", src_chain,
             "lie_vae_tpu/ops/kernels/wigner_fused.py:240", k2_timing,
             k2_err["bwd"], "launches_backward", "B=64 L=6 C=10 shared",
             4096),
            ("so3_density_fwd", src_dens,
             "lie_vae_tpu/ops/kernels/so3_density.py:22", d_timing,
             d_err["fwd"], "density_launches", "N=B=64 k=10", 4096),
            ("so3_density_bwd", src_dens,
             "lie_vae_tpu/ops/kernels/so3_density.py:57", d_timing,
             d_err["bwd"], "density_launches_backward", "N=B=64 k=10",
             4096),
            ("wigner_block_fwd", src_block,
             "lie_vae_tpu/ops/kernels/wigner_block.py:54", k5_timing,
             k5_err["fwd"], "block_launches", "B=64 L=6 C=10 shared", 4096),
            ("wigner_block_bwd", src_block,
             "lie_vae_tpu/ops/kernels/wigner_block.py:85", k5_timing,
             k5_err["bwd"], "block_launches_backward",
             "B=64 L=6 C=10 shared", 4096)):
        back = name.endswith("bwd")
        small, large = tim[64], tim[big]
        ms, plain_ms, (bound, bound_by) = small[3:] if back else small[:3]
        ms_l, plain_l, (bound_l, _) = large[3:] if back else large[:3]
        launches_main = (cli_launches if name.startswith("wigner_block")
                         else train_launches)[launch_key]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches_main,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "shape": shape, f"ms_b{big}": ms_l,
            f"plain_ms_b{big}": plain_l, f"bound_ms_b{big}": bound_l})
        if name in chain_dev:
            kernels[-1]["device_us"] = chain_us[64][chain_dev[name]]
            kernels[-1]["device_us_b4096"] = chain_us[4096][chain_dev[name]]
        if name in block_dev:
            kernels[-1]["device_us"] = block_us[64][block_dev[name]]
            kernels[-1]["device_us_b4096"] = block_us[4096][block_dev[name]]
    record = {"kernels": kernels, "build_s": build_s,
              "ptxas": ptxas_all, "pallas_op_device_us": op_us,
              "request_ms": req_ms,
              "render_s": render_s,
              "train_step_ms": train_runs["fused"][0],
              "train_step_ms_pallas": train_runs["pallas"][0],
              "train_step_ms_first": train_runs["fused"][1],
              "train_loss": [float(train_runs["fused"][2][0]),
                             float(train_runs["fused"][2][-1])],
              "cli_epoch_s": epoch_s,
              "cli_ll": float(ll["items"].mean()),
              "total_s": time.perf_counter() - t_start}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
