"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, each timed:

1. card: name and power limit (nvidia-smi), torch, CUDA and nvcc versions;
2. build: the Wigner chain kernels (csrc/wigner_chain.cu) and the density
   kernels (csrc/so3_density.cu), one nvcc each, started together;
3. K1, the chain kernel without residuals, against the plain chain on the
   card over L in {0, 1, 3, 6, 10}, C in {1, 10, 16}, B in {1, 64, 4103},
   shared and per-sample spectra, transpose on and off; then both timed
   with CUDA events at the flagship shape (B = 64) and at B = 4096;
4. K2, the chain forward with residuals and its backward kernel, against
   autograd of the plain chain over the same grid (and two shapes whose
   backward spans several channel tiles): output, d angles, d spectrum for
   a random cotangent; timed as K1;
5. K3 and K4, the wrapped SO(3) density and its backward, against the
   plain density and its autograd in float64: N in {1, 64, 4103, 65536}
   samples (the last as n = 4 samples of a batch of 16384), k in
   {0, 1, 10}, sigma from 1e-6 to pi * 10 / 2, v = 0 and |v| near
   multiples of 2 pi; timed at N = 64 and N = 4096;
6. serving: the flagship model with the converged reference weights
   (converged_state/torch_clean/best.pt), batch 64, on the card: warmup,
   sample, encode, reconstruct, geodesic and a ragged decode, checked for
   shape, finiteness, rotations and one kernel launch per decode chunk,
   then held against the same requests served on the CPU, and timed;
7. training: the flagship model as ``bench.py`` trains it (sigma clamp
   pi * 10 / 2; float32, TF32 off) from the same weights, fresh optimizer
   (lr 1e-3, clip 1e-5), beta 1, batch 64 of uint8 images that the serving
   session decodes from Haar-random poses: one step on the card against
   the same step on the CPU (loss, every gradient, parameters and
   BatchNorm statistics after it), then 20 steps with finite losses and
   one launch per step of each training kernel, timed per step.

The last lines are a JSON record of the kernels, the card line, and
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; it does so too without a CUDA card.
"""
import json
import math
import os
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
SIGMA_CLAMP = math.pi * 10 / 2
TRAIN_STEPS = 20
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
    from lie_vae_tpu_torch.ops.kernels import wigner_fused
    from lie_vae_tpu_torch.ops.wigner import block_wigner_apply_zjz
    from lie_vae_tpu_torch.serve import InferenceSession
    from lie_vae_tpu_torch.train import make_optimizer, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fused = wigner_fused.block_wigner_matrix_multiply_fused
    dens = so3_density.so3_wrapped_log_density_fused
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
    sources = ("wigner_chain", "so3_density")
    cached = {n: os.path.exists(_build.library_path(n)) for n in sources}

    def timed_build(name):
        tb = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - tb

    with ThreadPoolExecutor(len(sources)) as pool:
        build_s = dict(zip(sources, pool.map(timed_build, sources)))
    for n in sources:
        print(f"   {n}: {build_s[n]:.2f} s "
              f"({'already built' if cached[n] else 'nvcc'}) -> "
              f"{_build.library_path(n)}")
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
        bound, bound_by = chain_bound(B, 6, 10, shared=True)
        timing[B] = (k_ms, p_ms, bound, bound_by)
        print(f"   B={B} L=6 C=10 shared: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {bound:.6f} ms ({bound_by})")
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
        print(f"   L={L:2d}{' C>16 (several tiles)' if wide else ''}: {n} "
              f"cases, max |out - plain| {e_out:.3e}, max grad error "
              f"{r_grad:.3e} of max(1, max|ref|)")
    k2_timing = {}
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
        print(f"   B={B} L=6 C=10 shared: forward with residuals {f_ms:.4f} "
              f"ms (plain with grad {pf_ms:.4f}, bound {fb[0]:.6f} "
              f"{fb[1]}); backward {b_ms:.4f} ms (plain autograd "
              f"{pb_ms:.4f}, bound {bb[0]:.6f} {bb[1]})")
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

    t0 = phase("training: flagship as bench.py trains it, batch 64, beta 1")
    weights = compat.load_torch(CHECKPOINT)
    batch = (np.clip(sess.sample(64, seed=1), 0.0, 1.0) * 255.0).round() \
        .astype(np.uint8)
    eps = torch.randn((1, 64, 3), generator=torch.Generator().manual_seed(2))
    runs = {}
    for device in ("cuda", "cpu"):
        model = flagship_model(device, sigma_clamp=SIGMA_CLAMP)
        model.load_state_dict(weights, strict=True)
        opt = make_optimizer(model.named_parameters(), lr=1e-3,
                             clip_grads=1e-5)
        metrics = train_step(model, opt, torch.as_tensor(batch), 1.0,
                             eps=eps)
        runs[device] = (model, opt, metrics)
    (mg, opt_g, met_g), (mc, _, met_c) = runs["cuda"], runs["cpu"]
    loss_g, loss_c = float(met_g["loss"]), float(met_c["loss"])
    print(f"   one step: loss {loss_g:.6f} on the card, {loss_c:.6f} on the "
          f"CPU (recon {float(met_c['recon']):.4f}, KL "
          f"{float(met_c['kl']):.4f})")
    if not abs(loss_g - loss_c) <= LOSS_TOL * abs(loss_c):
        raise AssertionError(f"training loss {loss_g} on the card vs "
                             f"{loss_c} on the CPU")
    cpu_params = dict(mc.named_parameters())
    # a conv bias that feeds a BatchNorm has zero gradient in exact
    # arithmetic (the batch mean is subtracted): on both devices it must be
    # rounding, below BIAS_TOL of its conv weight's largest gradient
    enc = mg.encoder
    pre_bn = {f"encoder.{i}.bias" for i in range(len(enc) - 1)
              if isinstance(enc[i], torch.nn.Conv2d)
              and isinstance(enc[i + 1], torch.nn.BatchNorm2d)}
    worst_grad, worst_param, worst_bias = 0.0, 0.0, 0.0
    for name, p in mg.named_parameters():
        ref = cpu_params[name]
        if name in pre_bn:
            w = cpu_params[name[:-len("bias")] + "weight"].grad.abs().max()
            top = max(p.grad.abs().max().item(), ref.grad.abs().max().item())
            if not top <= BIAS_TOL * w.item():
                raise AssertionError(f"gradient of {name}: {top:.3e}, not "
                                     f"rounding against {w.item():.3e}")
            worst_bias = max(worst_bias, top / w.item())
        else:
            err = (p.grad.cpu() - ref.grad).abs().max().item()
            scale = ref.grad.abs().max().item()
            if not err <= TRAIN_GRAD_TOL * scale:
                raise AssertionError(f"gradient of {name}: {err:.3e} vs max "
                                     f"{scale:.3e} on the CPU")
            worst_grad = max(worst_grad, err / scale)
        d = (p.detach().cpu() - ref.detach()).abs().max().item()
        if not d <= PARAM_TOL:
            raise AssertionError(f"{name} after the step: {d:.3e}")
        worst_param = max(worst_param, d)
    cpu_buffers = dict(mc.named_buffers())
    worst_stat = 0.0
    for name, b in mg.named_buffers():
        ref = cpu_buffers[name]
        if name.endswith("num_batches_tracked"):
            if int(b) != int(ref):
                raise AssertionError(f"{name}: {int(b)} vs {int(ref)}")
            continue
        err = (b.cpu() - ref).abs().max().item() / ref.abs().max().item()
        if not err <= STATS_TOL:
            raise AssertionError(f"{name} after the step: {err:.3e}")
        worst_stat = max(worst_stat, err)
    print(f"   card vs CPU after one step: gradients {worst_grad:.3e} of "
          f"each tensor's max (tol {TRAIN_GRAD_TOL}); the biases before "
          f"BatchNorm at most {worst_bias:.3e} of their weight's gradient "
          f"(tol {BIAS_TOL}); parameters "
          f"{worst_param:.3e} (tol {PARAM_TOL}), BatchNorm statistics "
          f"{worst_stat:.3e} of max (tol {STATS_TOL})")

    counters = ((fused, "launches"), (fused, "launches_residuals"),
                (fused, "launches_backward"), (dens, "launches"),
                (dens, "launches_backward"))
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
        if delta != [0, 1, 1, 1, 1]:
            raise AssertionError(
                f"launches in one step (K1, K2 forward, K2 backward, K3, "
                f"K4): {delta}, expected [0, 1, 1, 1, 1]")
        losses.append(metrics["loss"])
    train_launches = {attr if obj is fused else f"density_{attr}":
                      getattr(obj, attr) for obj, attr in counters}
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses.tolist()}")
    train_ms = statistics.median(step_ms[2:])
    print(f"   {TRAIN_STEPS} steps: losses {losses[0]:.4f} .. "
          f"{losses[-1]:.4f}, all finite; launches per step: K1 0, K2 "
          f"forward 1, K2 backward 1, K3 1, K4 1 (totals {train_launches})")
    print(f"   ms per step (host clock, synchronised, median of steps "
          f"3-{TRAIN_STEPS}): {train_ms:.3f}; first two "
          f"{step_ms[0]:.3f}, {step_ms[1]:.3f}")
    done(t0)

    k64, p64, b64, by64 = timing[64]
    k4k, p4k, b4k, _ = timing[4096]
    src_chain = "lie_vae_tpu_torch/csrc/wigner_chain.cu"
    src_dens = "lie_vae_tpu_torch/csrc/so3_density.cu"
    kernels = [{
        "name": "wigner_chain_fwd", "route": "cuda", "source": src_chain,
        "replaces": "lie_vae_tpu/ops/kernels/wigner_fused.py:127",
        "launches": launches, "max_abs_err": worst,
        "ms": k64, "plain_ms": p64, "bound_ms": b64, "bound_by": by64,
        "library_ms": None,
        "shape": "B=64 L=6 C=10 shared",
        "ms_b4096": k4k, "plain_ms_b4096": p4k, "bound_ms_b4096": b4k}]
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
             4096)):
        back = name.endswith("bwd")
        small, large = tim[64], tim[big]
        ms, plain_ms, (bound, bound_by) = small[3:] if back else small[:3]
        ms_l, plain_l, (bound_l, _) = large[3:] if back else large[:3]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": train_launches[launch_key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "shape": shape, f"ms_b{big}": ms_l,
            f"plain_ms_b{big}": plain_l, f"bound_ms_b{big}": bound_l})
    record = {"kernels": kernels, "build_s": build_s, "request_ms": req_ms,
              "train_step_ms": train_ms, "train_step_ms_first": step_ms[:2],
              "train_loss": [float(losses[0]), float(losses[-1])],
              "total_s": time.perf_counter() - t_start}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
