"""Drive the PyTorch port's serving path, its training step (in float32
and in bench.py's bfloat16 recipe), its experiment CLI (sphere-cube renders,
the toy experiment, the Gaussian baseline), a Gaussian-latent session, the
vMF latents, the HTTP server, the serving CLI's export, the graphed
ahead-of-time session and the paper's regularised training on sc-pairs on
one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, each timed:

1. card: name and power limit (nvidia-smi), torch, CUDA and nvcc versions;
2. build: the Wigner chain kernels (csrc/wigner_chain.cu), the density
   kernels (csrc/so3_density.cu) and the synthesise-then-apply Wigner
   kernels (csrc/wigner_block.cu), one nvcc each, started together, each
   with ``-Xptxas -v``, whose report of each kernel's registers, stack frame
   and spills the build keeps beside the library;
3. K1, the chain kernel without residuals, against the plain chain on the
   card over L in {0, 1, 3, 6, 10}, C in {1, 10}, B in {1, 64, 4103},
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
   samples (the last as n = 4 samples of a batch of 16384) and the IW-LL's
   n = 500 samples of one item, k in {0, 1, 10}, sigma from 1e-6 to
   pi * 10 / 2, v = 0 and |v| near multiples of 2 pi; then the KL entry
   (K3 with the mean over n and the Haar prior folded in, K4 taking its
   (B,) cotangent) against the plain KL and its autograd, n in {1, 4}, on
   the same grid; every case run twice to repeat bit for bit; timed at
   N = 64 and N = 4096 with CUDA events, and by device time from a CUDA
   graph of 20 launches at N in {64, 4096, 65536} (the KL entry, the
   training path) and at n = 500, B = 1 (the per-sample entry, the IW-LL's
   call);
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
9. training, with ``kernel_impl='fused'`` (K2, K3, K4) and with
   ``'pallas'`` (K5, K6, K3, K4), first in float32 (IEEE: the entry
   points turn TF32 off), then in ``bench.py``'s recipe
   (``models.bench_model``: bfloat16 conv and transpose-conv stacks, a
   float32 image head): the flagship as
   ``bench.py`` trains it (sigma clamp pi * 10 / 2) from the converged
   weights, fresh optimizer (lr 1e-3, clip 1e-5), beta 1, batch 64 of the
   renders: one step on the card held against the exact float64 step on
   the CPU (loss, every gradient, parameters and BatchNorm statistics after
   it), each within its tolerance plus twice the CPU's own error in the
   same dtypes; then 20 steps with finite losses and one launch per step of
   each kernel of the path and none of the other's, timed per step, and 5
   more under ``torch.profiler`` (device busy time, device events per step,
   the costliest device items);
10. the CLI: ``cli.main.main --dataset spherecube`` with the flagship
   defaults and ``--kernel_impl pallas`` on the renders, two epochs,
   checkpoint and logs under chiprun_out/: every logged loss finite, K5,
   K6, K3 and K4 launched and K1, K2 not, the best checkpoint served by
   ``InferenceSession.from_checkpoint`` decoding fixed poses as the model
   it saved, and each test item's IW-LL finite and no lower than the mean
   of its own log-weights (Jensen's inequality); seconds per epoch;
11. the toy experiment, the CLI at its defaults (1000 items generated into
   chiprun_out/ by K1, L = 6, C = 10, the toy encoder, no deconv head),
   with ``--kernel_impl fused`` (K1, K2, K3, K4) and then ``pallas`` (K5,
   K6, K3, K4), two epochs each, checked as the CLI phase;
12. ``--config normal`` (Gaussian latent, MLP decoder: none of the
   kernels) on the renders, one epoch, checked as the CLI phase;
13. a Gaussian latent with the action decoder at the flagship's widths:
   five steps on the renders (K2 forward and backward each, the angle
   gradients through the tanh chart), then served at batch 64 (encode,
   decode, sample, reconstruct, geodesic: one launch of K1 per decode
   chunk) and held against the same requests served on the CPU;
14. the vMF latents at the flagship's widths on the renders (the layers
   they share with the flagship from its converged weights, the vMF heads
   and the MLP decoder from a seed): a ``vmfq``/``action`` model, five
   steps with ``kernel_impl``
   'fused' (K2) and five with 'pallas' (K5, K6), and a ``vmf``/``mlp``
   model, five steps (no kernel), the first step of each
   held against the exact float64 step from the card's weights, optimizer
   state and noise, as the flagship's step is held (the card's biases
   before BatchNorm to BIAS_TOL, the CPU's not); then the
   ``vmfq`` model served at batch 64 ('fused': K1 per decode chunk) and held
   against a CPU session (encode, decode, sample, reconstruct, geodesic);
15. ``cli.main --dataset spherecube --latent_mode vmfq --kernel_impl
   pallas``, one epoch on the renders, checked as the CLI phase;
16. the HTTP server (``serve_http.make_server``) over the flagship session
   in a thread on an ephemeral port, driven by a client written here with
   urllib and numpy: ``/healthz`` and every ``/v1/`` route in ``.npz`` and
   JSON, each answer equal to the same call of an in-process session with
   the same seed; ms per request of 64 through HTTP beside in process;
17. ``cli.serve export``: the CLI phase's checkpoint.pt to an ``.npz``
   artifact and back into a session that decodes as the checkpoint's, and
   ``cli.serve sample`` from it on the card;
18. the graphed session: ``serve.export_aot`` of the converged flagship
   into build/, opened as ``AotSession(path)`` with no model flags, for
   'fused' (K1 in the decode graph) and 'pallas' (K5): its construction
   launching the kernel exactly twice eagerly and once at capture for each
   of the decode and reconstruct graphs and nothing else (the path's
   count: the counts set to 0 just before it and read just after), captured
   with cuDNN's deterministic algorithms and held against an in-process
   ``InferenceSession`` of the same weights and seed (requests of 64 and
   of 100 rows: decode bit for bit, encode and reconstruct within 1e-6),
   the kernel named in a torch.profiler trace of one decode replay, and
   held again after 200 replays of varied requests; then, at torch's
   defaults, ms per request of 64 graphed and ungraphed in turns and the
   device's busy share of a decode ('fused'); a ``vmfq`` model's graphed
   session (the sampler's pick inside the graph) against its ungraphed
   twin;
19. ``bench_serve_load``: the graphed 'fused' session behind the HTTP
   server, /v1/reconstruct at 1 and 4 clients, 2 s each: requests/s,
   images/s, p50/p95 latency; replays only, no launch outside a graph;
20. sc-pairs: 320 seeded consecutive-pose pairs rendered by the port's
   generator into chiprun_out/;
21. the regularised step: the flagship from the converged weights with
   equivariance 100 and encoder continuity 3000 (the ``reg`` preset's), 64
   pairs = 128 images, with 'fused' and 'pallas' under the 'shear' rotation
   and 'fused' under 'gather', each held against the exact float64 step
   (theta and both passes' noise handed over) as the flagship's step is;
   then 20 timed and 5 profiled steps of each kernel_impl, one launch per
   step of each kernel of the path;
22. ``cli.main --config scpairs reg --kernel_impl pallas``, one epoch on
   the pairs with both schedules at their full weights from the first step
   (ramps that end at step 999, before they start), checked as the CLI
   phase, and its four regularizer tags finite, both weights above 0;
23. a fresh interpreter with torch's default precision settings: an
   ``InferenceSession`` decode of the flagship and one ``train_step``,
   which must run in IEEE float32 (``precision.ieee_float32``) and leave
   the settings as they found them; the flags seen inside, the cuDNN
   kernels named TF32, and the distance to the CPU, printed.

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
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "converged_state", "torch_clean",
                          "best.pt")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOP_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
FP64_FLOP_PER_S = 34e12        # H100 SXM float64, outside the tensor cores
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
# steps of each training configuration under torch.profiler (device busy
# time and device events per step); traces under build/profile/
PROFILE_STEPS = 5
PROFILE_DIR = os.path.join(ROOT, "build", "profile")
# the CLI phase: poses of data_poses/spherecube.npz rendered by the port,
# two epochs on them, and the IW-LL of a few test items
RENDER_POSES = 1024
DATA_DIR = os.path.join(ROOT, "chiprun_out", "smoke_data", "spherecube")
CLI_DIR = os.path.join(ROOT, "chiprun_out", "smoke_cli")
CLI_EPOCHS = 2
# the toy experiment at the CLI's defaults (1000 items, L = 6, C = 10),
# generated by the CLI into chiprun_out/
TOY_PATH = os.path.join(ROOT, "chiprun_out", "smoke_toy", "toy.npz")
# a Gaussian-latent model with the action decoder, trained a few steps on
# the renders and then served
NORMAL_STEPS = 5
LL_SAMPLES = 20
LL_ITEMS = 8
# GPU vs CPU serving, float32 with TF32 off: ten conv layers whose sums run
# in other orders (cuDNN's algorithms against the CPU's)
IMAGE_TOL = 1e-3
POSE_TOL = 1e-3
# the vMF models: the flagship's widths (conv 50, deconv 200, L = 6, C = 10,
# RGB, BatchNorm) from seeded weights, trained a few steps on the renders
VMF_CFG = dict(encode_mode="conv", deconv_mode="deconv", degrees=6,
               rep_copies=10, conv_hidden=50, deconv_hidden=200, rgb=True,
               batch_norm=True)
# (the first of each model's held against the exact step)
VMF_STEPS = 5
# HTTP requests of 64 timed (host clock, median) through the server and in
# process
HTTP_REPS = 20
# the graphed session: replays of varied requests before it is held again
AOT_REPLAYS = 200
# bench_serve_load against the graphed session: client counts, seconds each
LOAD_CLIENTS = (1, 4)
LOAD_SECONDS = 2.0
# the regularised step: the reg preset's weights, batch REG_PAIRS pairs of
# sc-pairs renders of the port's generator (seeded poses), REG_RENDER pairs
# rendered for it and for the scpairs CLI epoch
REG_EQ, REG_CONT = 100.0, 3000.0
REG_PAIRS = 64
REG_RENDER = 320
PAIRS_DIR = os.path.join(ROOT, "chiprun_out", "smoke_data", "sc-pairs")


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
    ``nvcc -Xptxas -v`` on csrc/<source>.cu; a Wigner kernel is named by
    its kind and its degree cap, e.g. ``fwd_res<6>``, a density kernel by
    its kind and its template arguments (k or -1 for any k, the lanes a
    sample, and for K4 whether the cotangent is per row), e.g.
    ``bwd<10,8,1>``."""
    report, name = {}, None
    for line in text.splitlines():
        m = re.search(rf"Compiling entry function '\S*?{source}_(fwd|bwd|"
                      r"sum|kl)_kernel(I(?:L[ib]n?\d+E)+E)?", line)
        if m:
            kind, args = m.groups()
            args = [("-" if neg else "") + val for neg, val in re.findall(
                r"L[ib](n?)(\d+)E", args or "")]
            if source == "so3_density":
                name = kind + (f"<{','.join(args)}>" if args else "")
            else:
                name = (kind + ("_res" if args[1:] == ["1"] else "")
                        + (f"<{args[0]}>" if args else ""))
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


def density_bound(N, B, k, backward, per_row=True):
    """The wrapped density of N samples with sigma (B, 3): v and sigma read,
    and the KL (B,) written, or with ``per_row`` False log q (N,); backward
    the cotangent (B,) or (N,) read, dv (N, 3) and dsigma (B, 3) written.
    About 30 + 11 (2k+1) float32 operations per sample forward and
    60 + 17 (2k+1) backward, there in float64, an exp counted as one.
    (Before the kernels took the KL's mean and dsigma's sum over n, the
    bound counted log q and the cotangent per sample, dsigma (N, 3) and the
    backward in float32: the same at n = 1, bytes bounding both.)"""
    shells, rows = 2 * k + 1, B if per_row else N
    if backward:
        return _bound(4 * (3 * N + 3 * B + rows + 3 * N + 3 * B),
                      N * (60 + 17 * shells), FP64_FLOP_PER_S)
    return _bound(4 * (3 * N + 3 * B + rows), N * (30 + 11 * shells))


def _bound(nbytes, flops, flop_per_s=FP32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
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


def train_once(device, dtype, weights, batch, eps, kernel_impl, recipe):
    """One training step of the flagship as bench.py trains it (sigma
    clamp pi * 10 / 2, lr 1e-3, clip 1e-5, beta 1) from ``weights`` on the
    uint8 ``batch`` with the noise ``eps``: in float32 throughout, or with
    ``recipe`` in bench.py's dtypes (``models.bench_model``: bfloat16
    stacks, float32 image head), cast to ``dtype``. Returns the model, its
    optimizer and the step's metrics."""
    from lie_vae_tpu_torch.models import bench_model, flagship_model
    from lie_vae_tpu_torch.train import make_optimizer, train_step
    model = (bench_model(device, kernel_impl=kernel_impl) if recipe
             else flagship_model(device, sigma_clamp=SIGMA_CLAMP,
                                 kernel_impl=kernel_impl))
    model.load_state_dict(weights, strict=True)
    model.to(dtype)
    opt = make_optimizer(model.named_parameters(), lr=1e-3, clip_grads=1e-5)
    metrics = train_step(model, opt, torch.as_tensor(batch), 1.0,
                         eps=eps.to(dtype))
    return model, opt, metrics


def step_card_vs_cpu(weights, batch, eps, kernel_impl, exact, recipe=False):
    """One flagship training step from ``weights`` on the uint8 ``batch``
    with the noise ``eps`` on the card, and on the CPU, in float32 (or with
    ``recipe`` in bench.py's bfloat16 stacks), held against ``exact``
    (:func:`train_once` in float64 on the CPU, which takes the plain ops
    whatever ``kernel_impl`` says) by :func:`check_against_exact`. Returns
    the card's model and optimizer."""
    runs = {key: train_once(device, torch.float32, weights, batch, eps,
                            kernel_impl, recipe)
            for key, device in (("card", "cuda"), ("cpu", "cpu"))}
    (mg, opt_g, met_g), (mc, _, met_c) = runs["card"], runs["cpu"]
    me, _, met_e = exact
    kind = "bfloat16" if recipe else "float32"
    loss_g, loss_c, loss_e = (float(m["loss"]) for m in (met_g, met_c,
                                                        met_e))
    print(f"   one step ({kind} stacks): loss {loss_g:.6f} on the card, "
          f"{loss_c:.6f} on the CPU, {loss_e:.6f} exact (recon "
          f"{float(met_e['recon']):.4f}, KL {float(met_e['kl']):.4f})")
    worst, worst_bias = check_against_exact(mg, met_g, mc, met_c, me, met_e,
                                            kind, recipe)
    print(f"   against the exact step (gradients and statistics as a share "
          f"of each tensor's max, parameters absolute): "
          + "; ".join(f"{k}: card {v[1]:.3e}, CPU {kind} {v[2]:.3e}, "
                      f"worst {v[0]:.3f} of the allowance"
                      for k, v in worst.items())
          + f"; the biases before BatchNorm at most {worst_bias[0]:.3e} "
          f"(card) and {worst_bias[1]:.3e} (CPU) of their weight's gradient "
          f"(tol {BIAS_TOL}" + (f" + {ARBITER} x the CPU's)" if recipe
                                else ")"))
    return mg, opt_g


def check_against_exact(mg, met_g, mc, met_c, me, met_e, kind="float32",
                        recipe=False, cpu_bias=True):
    """A training step on the card (model ``mg``, metrics ``met_g``) and the
    same step on the CPU in the same dtypes (``mc``, ``met_c``) held against
    the exact one (float64 on the CPU: ``me``, ``met_e``): loss, every
    gradient, the parameters and BatchNorm statistics after it, each within
    its stated tolerance plus twice the CPU's own error against the same
    exact step (where float32 loses digits on this input, as at a
    near-stationary point, or where bfloat16 rounds, that error says by how
    much). Returns, per kind (grad, param, stat), the worst share of the
    allowance and the largest card and CPU errors, and the largest
    gradients of the biases before BatchNorm on the card and the CPU as a
    share of their weight's. In float32 the CPU's bias gradients are held to
    BIAS_TOL too unless ``cpu_bias`` is False (the card's always are)."""
    loss_g, loss_c, loss_e = (float(m["loss"]) for m in (met_g, met_c,
                                                        met_e))
    if not abs(loss_g - loss_e) <= LOSS_TOL * abs(loss_e) \
            + ARBITER * abs(loss_c - loss_e):
        raise AssertionError(f"training loss {loss_g} on the card vs "
                             f"{loss_e} exact ({loss_c} on the CPU)")
    cpu_params = dict(mc.named_parameters())
    exact_params = dict(me.named_parameters())
    # a conv bias that feeds a BatchNorm has zero gradient in exact
    # arithmetic (the batch mean is subtracted): on both devices it must be
    # rounding, below BIAS_TOL of its conv weight's largest gradient; in
    # bfloat16 that rounding is bfloat16's, so the card's allowance adds
    # ARBITER times the CPU's own
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
    worst_bias = [0.0, 0.0]

    def note(group, name, res, what):
        if not res[0] <= 1.0:
            raise AssertionError(
                f"{what} of {name}: card {res[1]:.3e} from the exact step, "
                f"beyond its tolerance plus {ARBITER} x the CPU's {kind} "
                f"error {res[2]:.3e} ({res[0]:.3f} of the allowance)")
        worst[group] = [max(a, b) for a, b in zip(worst[group], res)]

    for name, p in mg.named_parameters():
        ref, exact = cpu_params[name], exact_params[name]
        if name in pre_bn:
            w = exact_params[name[:-len("bias")] + "weight"].grad.abs().max()
            r_card = p.grad.abs().max().item() / w.item()
            r_cpu = ref.grad.abs().max().item() / w.item()
            allow = BIAS_TOL + ARBITER * r_cpu if recipe else BIAS_TOL
            if not max(r_card, 0.0 if recipe or not cpu_bias
                       else r_cpu) <= allow:
                raise AssertionError(
                    f"gradient of {name}: card {r_card:.3e}, CPU "
                    f"{r_cpu:.3e} of its weight's {w.item():.3e}, not "
                    f"rounding (allowance {allow:.3e})")
            worst_bias = [max(worst_bias[0], r_card),
                          max(worst_bias[1], r_cpu)]
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
    return worst, worst_bias


def train_state(model, opt):
    """A ``train.checkpoint.load_checkpoint``-shaped dict of the model's and
    the optimizer's state, on the CPU."""
    return {"step": opt.count,
            "model": {k: v.detach().cpu() for k, v in
                      model.state_dict().items()},
            "optimizer": {"count": opt.count,
                          "mu": [m.detach().cpu() for m in opt.mu],
                          "nu": [n.detach().cpu() for n in opt.nu]}}


def vmf_steps(cfg, weights, batch, x_dev, seed, counters, want,
              checked=VMF_STEPS):
    """VMF_STEPS training steps of a vMF model on the card (lr 1e-3, clip
    1e-5, beta 1) on the uint8 ``batch`` (``x_dev`` on the card), the first
    ``checked`` of them each held against the same step on the CPU in
    float32 and in float64 (the exact step) from the card's weights and
    optimizer state before it, with the same noise, by
    :func:`check_against_exact`. The noise, the accepted Beta draw (a
    Beta(3/2, 3/2) from squared normals) and the tangent normal, comes from
    a generator seeded with ``seed``. Each step launches ``want`` of the
    kernels of ``counters``. Returns the card's model and optimizer, its
    launches, the worst shares of the allowances and the last loss."""
    from lie_vae_tpu_torch.models import LieVAE
    from lie_vae_tpu_torch.train import make_optimizer, train_step
    from lie_vae_tpu_torch.train.checkpoint import apply_state
    card = LieVAE(**cfg)
    card.load_state_dict(weights, strict=True)
    cpu = LieVAE(**dict(cfg, device="cpu"))
    exact = LieVAE(**dict(cfg, device="cpu")).double()
    opts = [make_optimizer(m.named_parameters(), lr=1e-3, clip_grads=1e-5)
            for m in (card, cpu, exact)]
    gen = torch.Generator().manual_seed(seed)
    n = batch.shape[0]
    worst, launched = {}, [0] * len(counters)
    for step in range(VMF_STEPS):
        if step < checked:
            state = train_state(card, opts[0])
            apply_state(state, cpu, opts[1])
            apply_state(state, exact, opts[2])
        g = torch.randn((2, 3, 1, n), generator=gen)
        x2, y2 = (g * g).sum(1)
        eps = (x2 / (x2 + y2), torch.randn((1, n, 4), generator=gen))
        before = [getattr(obj, attr) for obj, attr in counters]
        met_g = train_step(card, opts[0], x_dev, 1.0, eps=eps)
        delta = [getattr(obj, attr) - b
                 for (obj, attr), b in zip(counters, before)]
        launched = [a + d for a, d in zip(launched, delta)]
        if delta != want:
            raise AssertionError(f"a {cfg['latent_mode']} step launched "
                                 f"{delta} (K1, K2 forward, K2 backward, K3, "
                                 f"K4, K5, K6), expected {want}")
        if not torch.isfinite(met_g["loss"]):
            raise AssertionError(f"non-finite loss {float(met_g['loss'])}")
        if step < checked:
            met_c = train_step(cpu, opts[1], batch, 1.0, eps=eps)
            met_e = train_step(exact, opts[2], batch, 1.0,
                               eps=tuple(e.double() for e in eps))
            # a random model's CPU float32 rounding of the biases' exact 0
            # gradient reached 1.6e-3 of the weight's (an H100 host's CPU):
            # the card, not that reference, is held to BIAS_TOL there
            res, bias = check_against_exact(card, met_g, cpu, met_c, exact,
                                            met_e, cpu_bias=False)
            res["bias"] = [0.0, *bias]
            for k, v in res.items():
                worst[k] = [max(a, b) for a, b in zip(worst.get(k, v), v)]
    return card, opts[0], launched, worst, float(met_g["loss"])


def _urlopen(url, body=None, ctype=None):
    """(status, Content-Type, body) of a GET, or of a POST of ``body``."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def http_phase(counters, counts, images):
    """The flagship session behind ``serve_http.make_server`` (batch 64,
    'fused', seed 0) in a thread on an ephemeral port, driven by a client
    written here (urllib, numpy): ``/healthz``, every ``/v1/`` route in
    ``.npz`` (64 uint8 images) and JSON (8 float images), and two bad
    requests. Each answer must equal the same call of an in-process session
    of the same weights and seed made in the same order (bitwise for
    decode, within 1e-6 otherwise), with cuDNN's deterministic algorithms
    for the comparison. Returns the ms per request of 64 through HTTP and
    in process, and the kernels the server launched."""
    import io
    import threading
    from lie_vae_tpu_torch import serve_http
    from lie_vae_tpu_torch.models import flagship_model
    from lie_vae_tpu_torch.ops import random_group_matrices
    from lie_vae_tpu_torch.serve import InferenceSession
    served, ref = (InferenceSession.from_torch(
        CHECKPOINT, flagship_model(), batch_size=64, seed=0).warmup()
        for _ in range(2))
    server = serve_http.make_server(served)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    launched = dict.fromkeys(counts(), 0)

    def post(route, arrays, fmt):
        if fmt == "npz":
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            body, ctype = buf.getvalue(), "application/x-npz"
        else:
            body = json.dumps({k: np.asarray(v).tolist()
                               for k, v in arrays.items()}).encode()
            ctype = "application/json"
        before = counts()
        status, got_type, data = _urlopen(f"{url}/v1/{route}", body, ctype)
        for k, v in counts().items():
            launched[k] += v - before[k]
        if status != 200:
            raise AssertionError(f"/v1/{route}: HTTP {status} {data[:300]}")
        if fmt == "npz":
            with np.load(io.BytesIO(data)) as z:
                return {k: z[k] for k in z.files}
        return {k: np.asarray(v, np.float32)
                for k, v in json.loads(data).items()}

    def same(got, want, what, bitwise=False):
        err = np.abs(got - want).max()
        if got.shape != want.shape or not (
                np.array_equal(got, want) if bitwise else err <= 1e-6):
            raise AssertionError(f"{what}: HTTP {got.shape} vs in process "
                                 f"{want.shape}, max |diff| {err}")

    # cuDNN's transpose-conv algorithms sum in an order that varies between
    # calls, so two decodes of one request differ in the last bits: the
    # comparisons run with cudnn.deterministic set (the timing without it)
    deterministic = torch.backends.cudnn.deterministic
    try:
        poses = random_group_matrices(
            64, torch.Generator().manual_seed(14), device="cpu").numpy()
        repeat = np.abs(ref.decode(poses) - ref.decode(poses)).max()
        torch.backends.cudnn.deterministic = True
        status, _, data = _urlopen(f"{url}/healthz")
        health = json.loads(data)
        if status != 200 or health["latent_mode"] != "so3" \
                or health["batch_size"] != 64:
            raise AssertionError(f"/healthz: {status} {health}")
        floats = images[:8].astype(np.float32) / 255.0
        checked = 0
        for fmt, x, p in (("npz", images, poses), ("json", floats,
                                                   poses[:8])):
            enc, want = post("encode", {"images": x}, fmt), ref.encode(x)
            for k in ("pose", "sigma", "sample"):
                same(enc[k], want[k], f"{fmt} encode {k}")
            same(post("decode", {"poses": p}, fmt)["images"], ref.decode(p),
                 f"{fmt} decode", bitwise=True)
            same(post("reconstruct", {"images": x}, fmt)["images"],
                 ref.reconstruct(x), f"{fmt} reconstruct")
            same(post("sample", {"n": 8, "seed": 3}, fmt)["images"],
                 ref.sample(8, seed=3), f"{fmt} sample")
            same(post("geodesic", {"pose_a": p[0], "pose_b": p[1],
                                   "steps": 16}, fmt)["frames"],
                 ref.geodesic(p[0], p[1], steps=16), f"{fmt} geodesic")
            checked += 5
        bad = [_urlopen(f"{url}/v1/nope", b"{}", "application/json")[0],
               _urlopen(f"{url}/v1/decode", b"{}", "application/json")[0]]
        if bad != [400, 400]:
            raise AssertionError(f"bad route / missing field: HTTP {bad}")
        routes_launched = dict(launched)
        torch.backends.cudnn.deterministic = deterministic
        ms = {}
        for route, arrays, fn in (
                ("decode", {"poses": poses}, lambda: ref.decode(poses)),
                ("encode", {"images": images}, lambda: ref.encode(images))):
            ms[route] = {"http": host_ms(lambda: post(route, arrays, "npz"),
                                         reps=HTTP_REPS),
                         "in_process": host_ms(fn, reps=HTTP_REPS)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
        server.shutdown()
        server.server_close()
        thread.join()
    print(f"   /healthz {health}; {checked} answers in .npz and JSON equal "
          "the in-process session's (decode bitwise, with cuDNN's "
          "deterministic algorithms: without them two in-process decodes of "
          f"one request differ by {repeat:.1e}); a bad route and a missing "
          f"field answered 400; launches by the server's requests "
          f"{routes_launched}")
    print("   ms per request of 64 (host clock, median of "
          f"{HTTP_REPS}, .npz): " + "; ".join(
              f"{k} {v['http']:.3f} through HTTP, {v['in_process']:.3f} in "
              "process" for k, v in ms.items()))
    if not routes_launched["launches"]:
        raise AssertionError("the server never launched K1")
    return ms, routes_launched


def export_phase(cli_dir, flags):
    """``cli.serve export`` of the CLI run's checkpoint.pt (model flags
    ``flags``) to an .npz under build/, served by
    ``InferenceSession.from_npz`` with the checkpoint's weights bit for bit,
    decoding 16 fixed poses bit for bit as ``from_checkpoint`` does (with
    cuDNN's deterministic algorithms); then ``cli.serve sample`` from the
    artifact at its default device, the card."""
    from lie_vae_tpu_torch.cli import main as cli_main
    from lie_vae_tpu_torch.cli import serve as cli_serve
    from lie_vae_tpu_torch.ops import random_group_matrices
    from lie_vae_tpu_torch.serve import InferenceSession
    out_dir = os.path.join(ROOT, "build", "smoke_export")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ckpt = os.path.join(cli_dir, cli_main.CHECKPOINT)
    art = cli_serve.main(["export", "--checkpoint", ckpt, "--out",
                          os.path.join(out_dir, "artifact.npz")] + flags)
    args = cli_main.parse_args(flags)
    poses = random_group_matrices(
        16, torch.Generator().manual_seed(15), device="cpu").numpy()
    sessions = [InferenceSession.from_checkpoint(
        ckpt, cli_serve._build_model(args), batch_size=64),
        InferenceSession.from_npz(art, cli_serve._build_model(args),
                                  batch_size=64)]
    # (a JAX artifact has no BatchNorm step counter: the model keeps its own)
    sd_a, sd_b = (s.model.state_dict() for s in sessions)
    differ = [k for k in sd_a if not k.endswith("num_batches_tracked")
              and not torch.equal(sd_a[k], sd_b[k])]
    if sd_a.keys() != sd_b.keys() or differ:
        raise AssertionError(f"the artifact's weights differ from the "
                             f"checkpoint's: {differ}")
    # two sessions' transpose convs sum in cuDNN's varying order unless
    # its deterministic algorithms are asked for
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a, b = (s.decode(poses) for s in sessions)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    samples = cli_serve.main(["sample", "--artifact", art, "-n", "8",
                              "--out", os.path.join(out_dir, "samples.npz")]
                             + flags)
    with np.load(samples) as z:
        check_images(z["images"], (8, 64, 64, 3), "cli.serve sample")
    print(f"   {art}: {os.path.getsize(art) / 1e6:.1f} MB; served from the "
          "artifact, the weights and statistics equal the checkpoint's bit "
          "for bit and 16 "
          f"poses decode within {np.abs(a - b).max():.1e} of the "
          "checkpoint's (bit for bit required, with cuDNN's deterministic "
          "algorithms); cli.serve sample wrote 8 images")
    if not np.array_equal(a, b):
        raise AssertionError(f"the exported artifact decodes otherwise: max "
                             f"|diff| {np.abs(a - b).max()}")


def _replay_kernels(name, fn, want):
    """The device items of one call of ``fn`` under torch.profiler (a trace
    under build/profile/): fails unless an item's name holds ``want``."""
    from lie_vae_tpu_torch.profile_serve import profile_request
    items, prof = profile_request(name, fn, 1, PROFILE_DIR)
    if not any(want in k for k in items):
        raise AssertionError(f"{name}: no {want} among the device items of "
                             f"one replay: {sorted(items)[:20]}")
    return items, prof


# the graphed flagship session's launches at construction: the decode and
# reconstruct graphs hold the decoder's kernel (K1 or K5), each run twice
# eagerly and captured once; nothing else launches a counted kernel
AOT_CAPTURE_LAUNCHES = 2 * (2 + 1)


def open_aot(art, counters, counts, key):
    """``AotSession(art, seed=0)`` with every launch count set to 0 just
    before and read just after: fails unless the kernel counted ``key``
    launched exactly AOT_CAPTURE_LAUNCHES times and no other kernel did.
    Returns the session and the counts."""
    from lie_vae_tpu_torch.serve import AotSession
    for obj, attr in counters:
        setattr(obj, attr, 0)
    sess = AotSession(art, seed=0)
    got = counts()
    want = {k: AOT_CAPTURE_LAUNCHES if k == key else 0 for k in got}
    if got != want:
        raise AssertionError(f"the graphed session's construction launched "
                             f"{got}, not {want}")
    return sess, got


def aot_phase(impl, counters, counts, images, poses, timed=True):
    """``serve.export_aot`` of the flagship's converged weights (kernel_impl
    ``impl``) into build/ (git-ignored), opened as ``AotSession(path)`` with
    no model flags, twice: captured with cuDNN's deterministic algorithms,
    and at torch's defaults. The first against an in-process
    ``InferenceSession`` of the same weights and seed (deterministic too),
    a request of 64 and a ragged one of 100: decode bit for bit, encode
    (the same generator draws) and reconstruct within 1e-6; the kernel of
    the decode (K1 for 'fused', K5 for 'pallas') named in a torch.profiler
    trace of one decode replay, with the session's replay count up by one
    and the kernel's launch count not moved; then AOT_REPLAYS replays of
    varied requests and a request held again (a stale buffer would show).
    The second (with ``timed``) timed against the ungraphed session: ms
    per request of 64, in turns (host clock, median of 20), and the
    device's busy share of a request. Each graphed session's launches are
    read around its construction alone (:func:`open_aot`), so the twins'
    launches enter no count. Returns the timing session (None without
    ``timed``), the checks' and timings' record, the replays by surface,
    and the constructions' launches summed."""
    from lie_vae_tpu_torch.models import flagship_model
    from lie_vae_tpu_torch.profile_serve import profile_request
    from lie_vae_tpu_torch.serve import (InferenceSession,
                                         export_aot_from_torch)
    out_dir = os.path.join(ROOT, "build", "smoke_aot")
    os.makedirs(out_dir, exist_ok=True)
    art = export_aot_from_torch(
        CHECKPOINT, flagship_model("cpu", kernel_impl=impl),
        os.path.join(out_dir, f"flagship_{impl}.npz"))
    kernel = {"fused": "wigner_chain_fwd", "pallas": "wigner_block_fwd"}[impl]
    key = {"fused": "launches", "pallas": "block_launches"}[impl]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tc = time.perf_counter()
        aot, built = open_aot(art, counters, counts, key)
        capture_s = time.perf_counter() - tc
        ref = InferenceSession.from_torch(
            CHECKPOINT, flagship_model(kernel_impl=impl), batch_size=64,
            seed=0)
        worst = {"encode": 0.0, "reconstruct": 0.0}

        def held(x, z, what):
            got, want = aot.decode(z), ref.decode(z)
            if not np.array_equal(got, want):
                raise AssertionError(f"{what}: the graphed decode differs "
                                     f"by {np.abs(got - want).max()}")
            ge, we = aot.encode(x), ref.encode(x)
            gr, wr = aot.reconstruct(x), ref.reconstruct(x)
            worst["encode"] = max(worst["encode"], *(
                float(np.abs(ge[k] - we[k]).max()) for k in we))
            worst["reconstruct"] = max(worst["reconstruct"],
                                       float(np.abs(gr - wr).max()))
            if not (worst["encode"] <= 1e-6 and worst["reconstruct"]
                    <= 1e-6):
                raise AssertionError(f"{what}: the graphed session against "
                                     f"the in-process one: {worst}")
            check_images(got, (len(z), 64, 64, 3), f"{what} decode")

        ragged = np.concatenate([images, images[:36]])
        poses100 = np.concatenate([poses, poses[:36]])
        held(images, poses, "a request of 64")
        held(ragged, poses100, "a ragged request of 100")
        before, replays = counts()[key], dict(aot.replays)
        items, _ = _replay_kernels(f"aot_decode_replay_{impl}",
                                   lambda: aot.decode(poses), kernel)
        if counts()[key] != before or aot.replays["decode"] \
                != replays["decode"] + 2:
            raise AssertionError(f"the profiled replays: launches "
                                 f"{counts()[key] - before}, decode replays "
                                 f"{aot.replays['decode'] - replays['decode']}")
        in_trace = sorted(k[:60] for k in items if kernel in k)
        # varied requests; their encodes take noise handed over, so the
        # session's generator stays in step with the twin's
        gen = np.random.default_rng(17)
        varied = (lambda x, z, e: aot.decode(z),
                  lambda x, z, e: aot.encode(x, eps=e),
                  lambda x, z, e: aot.reconstruct(x))
        for i in range(AOT_REPLAYS):
            varied[i % 3](images[gen.permutation(64)],
                          poses[gen.permutation(64)],
                          gen.standard_normal((64, 3), np.float32))
        held(images, poses, f"after {AOT_REPLAYS} more replays")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"   {impl!r}: {art} ({os.path.getsize(art) / 1e6:.1f} MB), "
          f"captured in {capture_s:.2f} s; against the in-process session "
          f"(64 and 100 rows): decode bit for bit, encode within "
          f"{worst['encode']:.1e}, reconstruct {worst['reconstruct']:.1e}; "
          f"in the trace of one decode replay: {in_trace} (launch count "
          f"unmoved, replays counted); held again after {AOT_REPLAYS} "
          f"replays of varied requests; replays {aot.replays}")
    replayed = dict(aot.replays)
    aot.close()
    record = {"capture_s": capture_s, "encode_max_diff": worst["encode"],
              "reconstruct_max_diff": worst["reconstruct"],
              "in_replay_trace": in_trace}
    if not timed:
        return None, record, replayed, built
    fast, built_fast = open_aot(art, counters, counts, key)
    built = {k: v + built_fast[k] for k, v in built.items()}
    live = InferenceSession.from_torch(
        CHECKPOINT, flagship_model(kernel_impl=impl), batch_size=64,
        seed=0).warmup()
    reqs = {"decode": (lambda s: s.decode(poses)),
            "encode": (lambda s: s.encode(images)),
            "reconstruct": (lambda s: s.reconstruct(images))}
    ms = {}
    for name, fn in reqs.items():
        for sess in (fast, live):
            fn(sess)
        times = {"graphed": [], "ungraphed": []}
        for i in range(2 * HTTP_REPS):
            # in turns: graphed, ungraphed, ungraphed, graphed, ...
            which = "graphed" if i % 4 in (0, 3) else "ungraphed"
            t0 = time.perf_counter()
            fn(fast if which == "graphed" else live)
            times[which].append(1e3 * (time.perf_counter() - t0))
        ms[name] = {k: statistics.median(v) for k, v in times.items()}
    prof = {}
    for which, sess in (("graphed", fast), ("ungraphed", live)):
        _, prof[which] = profile_request(
            f"aot_{which}_decode_{impl}", lambda: sess.decode(poses),
            PROFILE_STEPS, PROFILE_DIR)
    replayed = {k: replayed[k] + fast.replays[k] for k in replayed}
    print("   ms per request of 64 (host clock, median of "
          f"{HTTP_REPS}, in turns), graphed / ungraphed: " + "; ".join(
              f"{k} {v['graphed']:.3f} / {v['ungraphed']:.3f}"
              for k, v in ms.items())
          + "; a decode's device busy share: " + ", ".join(
              f"{k} {v['busy_ms']:.3f} of {v['host_ms']:.3f} ms "
              f"({100 * v['busy_ms'] / v['host_ms']:.1f}%), "
              f"{v['events']:.0f} device events" for k, v in prof.items()))
    return fast, dict(record, ms=ms, decode_profiled=prof), replayed, built


def aot_vmfq_check(vcfg, vstate, images):
    """The vmfq model's graphed session (the sampler's proposals drawn
    outside the graph, the pick against kappa inside it) against its
    ungraphed twin of the same seed: encode twice (the generators advance
    alike) and with a given accepted draw, decode, reconstruct, within
    1e-6 (cuDNN's deterministic algorithms)."""
    from lie_vae_tpu_torch import compat
    from lie_vae_tpu_torch.models import LieVAE
    from lie_vae_tpu_torch.serve import (AotSession, InferenceSession,
                                         export_aot_from_torch)
    out_dir = os.path.join(ROOT, "build", "smoke_aot")
    os.makedirs(out_dir, exist_ok=True)
    ref_pt = compat.save_torch(os.path.join(out_dir, "vmfq.pt"), vstate)
    art = export_aot_from_torch(ref_pt, LieVAE(**dict(vcfg, device="cpu")),
                                os.path.join(out_dir, "vmfq_aot.npz"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        aot = AotSession(art, seed=5)
        ref = InferenceSession(LieVAE(**vcfg), vstate, batch_size=64, seed=5)
        gen = torch.Generator().manual_seed(19)
        g = torch.randn((2, 3, 64), generator=gen)
        x2, y2 = (g * g).sum(1)
        pair = ((x2 / (x2 + y2)).numpy(),
                torch.randn((64, 4), generator=gen).numpy())
        diffs = []
        for kw in ({}, {}, {"eps": pair}):
            a, b = aot.encode(images, **kw), ref.encode(images, **kw)
            diffs += [float(np.abs(a[k] - b[k]).max()) for k in b]
        diffs += [float(np.abs(aot.decode(b["pose"])
                               - ref.decode(b["pose"])).max()),
                  float(np.abs(aot.reconstruct(images)
                               - ref.reconstruct(images)).max())]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"   vmfq graphed session vs its ungraphed twin: max |diff| "
          f"{max(diffs):.1e} over encode (drawn twice, then a given accepted "
          f"draw), decode and reconstruct; replays {aot.replays}")
    if not max(diffs) <= 1e-6:
        raise AssertionError(f"the graphed vmfq session differs: {diffs}")
    aot.close()
    return max(diffs)


def reg_step(weights, batch, noise, impl, rotate, exact=None, cpu=None):
    """One regularised flagship step (sigma clamp pi * 10 / 2, lr 1e-3,
    clip 1e-5, beta 1, equivariance REG_EQ and encoder continuity REG_CONT,
    the ``reg`` preset's weights, on the pairs ``batch``) from ``weights``
    with ``noise`` = (posterior noise, theta, the equivariance pass's noise)
    on the card with ``kernel_impl`` ``impl``, held against the exact
    float64 step on the CPU (``exact``, computed here when None) by
    :func:`check_against_exact`, with the CPU's float32 step (``cpu``)
    arbitrating. Returns the card's model, optimizer and metrics, the worst
    shares, and the exact and CPU steps for reuse."""
    from lie_vae_tpu_torch.models import flagship_model
    from lie_vae_tpu_torch.train import make_optimizer, train_step
    eps, theta, eq_eps = noise

    def run(device, dtype):
        model = flagship_model(device, sigma_clamp=SIGMA_CLAMP,
                               kernel_impl=impl)
        model.load_state_dict(weights, strict=True)
        model.to(dtype)
        opt = make_optimizer(model.named_parameters(), lr=1e-3,
                             clip_grads=1e-5)
        met = train_step(model, opt, torch.as_tensor(batch), 1.0,
                         eps=eps.to(dtype), equivariance_lamb=REG_EQ,
                         encoder_continuity_lamb=REG_CONT,
                         equivariance_rotate=rotate, theta=theta,
                         eq_eps=eq_eps.to(dtype))
        return model, opt, met

    exact = exact or run("cpu", torch.float64)
    cpu = cpu or run("cpu", torch.float32)
    mg, opt_g, met_g = run("cuda", torch.float32)
    worst, bias = check_against_exact(mg, met_g, cpu[0], cpu[2], exact[0],
                                      exact[2])
    for k in ("equivariance", "encoder_continuity"):
        got, want = float(met_g[k]), float(exact[2][k])
        ref = abs(float(cpu[2][k]) - want)
        if not abs(got - want) <= LOSS_TOL * abs(want) + ARBITER * ref:
            raise AssertionError(f"{k}: {got} on the card, {want} exact")
    print(f"   {impl!r}, {rotate!r}: loss {float(met_g['loss']):.4f} on the "
          f"card, {float(exact[2]['loss']):.4f} exact (equivariance "
          f"{float(exact[2]['equivariance']):.4f}, continuity "
          f"{float(exact[2]['encoder_continuity']):.5f}); against the exact "
          "step: " + "; ".join(
              f"{k}: card {v[1]:.3e}, CPU float32 {v[2]:.3e}, worst "
              f"{v[0]:.3f} of the allowance" for k, v in worst.items())
          + f"; the biases before BatchNorm {bias[0]:.3e} (card), "
          f"{bias[1]:.3e} (CPU) of their weight's gradient")
    return mg, opt_g, met_g, worst, exact, cpu


# run by precision_subprocess in a fresh interpreter: torch's own defaults
_PRECISION_SCRIPT = r"""
import json, math, sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from lie_vae_tpu_torch import compat, precision
from lie_vae_tpu_torch.models import LieVAE, flagship_model
from lie_vae_tpu_torch.serve import InferenceSession
from lie_vae_tpu_torch.train import make_optimizer, train_step

ckpt, inputs_path = sys.argv[1:3]
with np.load(inputs_path) as f:
    batch, poses, cpu, exact_loss = (f["batch"], f["poses"], f["cpu_decode"],
                                     float(f["exact_loss"]))
before = precision.flags()
seen = {"encode": set(), "decode": set()}


def probe(name, fn):
    def wrapped(self, *a, **k):
        seen[name].add(precision.flags())
        return fn(self, *a, **k)
    return wrapped


encode, decode = LieVAE.encode, LieVAE.decode
LieVAE.encode, LieVAE.decode = probe("encode", encode), probe("decode", decode)


def tf32_kernels(fn):
    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sorted({e.name for e in prof.events()
                        if "tf32" in e.name.lower()})


sess = InferenceSession.from_torch(ckpt, flagship_model(), batch_size=64)
out, k_ieee = tf32_kernels(lambda: sess.decode(poses))
m = flagship_model(sigma_clamp=math.pi * 10 / 2)
m.load_state_dict(compat.load_torch(ckpt), strict=True)
opt = make_optimizer(m.named_parameters(), lr=1e-3, clip_grads=1e-5)
eps = torch.randn((1, 64, 3), generator=torch.Generator().manual_seed(2))
loss = float(train_step(m, opt, batch, 1.0, eps=eps)["loss"])
after = precision.flags()
inside = {k: sorted(v) for k, v in seen.items()}
LieVAE.encode, LieVAE.decode = encode, decode


def plain_decode():
    with torch.inference_mode():
        z = torch.as_tensor(poses, device="cuda")[None]
        return sess.model.decode(z)[0].cpu().numpy()


raw, k_default = tf32_kernels(plain_decode)
print(json.dumps({
    "torch": torch.__version__, "before": before, "after": after,
    "inside": inside, "tf32_kernels_in_session": k_ieee,
    "tf32_kernels_outside": k_default,
    "decode_vs_cpu": float(np.abs(out - cpu).max()),
    "decode_outside_vs_cpu": float(np.abs(raw - cpu).max()),
    "train_step_loss": loss,
    "train_step_loss_vs_exact": abs(loss - exact_loss) / abs(exact_loss)}))
"""


def precision_subprocess(batch, cpu_session, exact_loss):
    """In a fresh interpreter (torch's default settings): a flagship
    session's decode of 64 poses and one flagship train_step (the float32
    training phase's first: the converged weights, ``batch``, its noise),
    with a probe on LieVAE.encode / decode recording the precision settings
    each call sees. Fails unless every call saw IEEE float32 for cuDNN
    convolutions and cuBLAS matmuls, the process's own settings were the
    same before and after, no TF32 kernel ran in the session's decode, and
    that decode is within IMAGE_TOL of ``cpu_session``'s. Prints the same
    decode outside the helper (torch's defaults), and the step's loss
    against ``exact_loss`` (the exact step's), for the record."""
    from lie_vae_tpu_torch.ops import random_group_matrices
    poses = random_group_matrices(
        64, torch.Generator().manual_seed(16), device="cpu").numpy()
    path = os.path.join(ROOT, "build", "precision_inputs.npz")
    np.savez(path, batch=batch, poses=poses,
             cpu_decode=cpu_session.decode(poses), exact_loss=exact_loss)
    proc = subprocess.run(
        [sys.executable, "-c", _PRECISION_SCRIPT, CHECKPOINT, path],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"the fresh interpreter failed: "
                             f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"   torch {res['torch']}: settings (cuDNN conv, cuBLAS matmul) "
          f"before {res['before']}, inside the entry points "
          f"{res['inside']}, after {res['after']}")
    print(f"   TF32 kernels in the session's decode: "
          f"{res['tf32_kernels_in_session']}; in the same decode outside "
          f"the entry point (torch's defaults): "
          f"{res['tf32_kernels_outside']}")
    print(f"   decode vs the CPU: {res['decode_vs_cpu']:.3e} in the session "
          f"(tol {IMAGE_TOL}), {res['decode_outside_vs_cpu']:.3e} outside it;"
          f" train_step loss {res['train_step_loss']:.6f}, "
          f"{res['train_step_loss_vs_exact']:.2e} of the exact step's")
    ieee = [["ieee", "ieee"]]
    if not (res["inside"]["encode"] == ieee and res["inside"]["decode"]
            == ieee and res["before"] == res["after"]
            and not res["tf32_kernels_in_session"]
            and res["decode_vs_cpu"] <= IMAGE_TOL):
        raise AssertionError(f"the entry points' precision: {res}")
    return res


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() "
                 "is False")
    from lie_vae_tpu_torch import compat
    from lie_vae_tpu_torch.distributions.so3 import (
        so3_wrapped_log_density_plain)
    from lie_vae_tpu_torch.models import flagship_model
    from lie_vae_tpu_torch.ops import (group_matrix_to_eazyz,
                                       random_group_matrices,
                                       random_quaternions)
    from lie_vae_tpu_torch.ops.kernels import _build
    from lie_vae_tpu_torch.ops.kernels import so3_density
    from lie_vae_tpu_torch.ops.kernels import wigner_block
    from lie_vae_tpu_torch.ops.kernels import wigner_fused
    from lie_vae_tpu_torch.ops.wigner import block_wigner_apply_zjz
    from lie_vae_tpu_torch.precision import ieee_float32
    from lie_vae_tpu_torch.profile_serve import device_us, profile_request
    from lie_vae_tpu_torch.serve import InferenceSession
    from lie_vae_tpu_torch.train import make_optimizer, train_step

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
        with open(_build.ptxas_log_path(name)) as f:
            return ptxas_report(f.read(), name)

    with ThreadPoolExecutor(len(sources)) as pool:
        build_s = dict(zip(sources, pool.map(timed_build, sources)))
    ptxas_all = {n: ptxas(n) for n in sources}
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
        for C in (1, 10):
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
    cases = [(L, C, B) for L in (0, 1, 3, 6, 10) for C in (1, 10)
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

    t0 = phase("K3/K4: wrapped SO(3) density, its KL and their backward vs "
               "the plain versions and their autograd on the card")
    from lie_vae_tpu_torch.distributions.so3 import so3_wrapped_kl_plain
    kl_fused = so3_density.so3_wrapped_kl_fused
    d_err = {"fwd": 0.0, "bwd": 0.0}
    n_rep = 0

    def density_case(fn, plain, n, B, k, g_shape, seed):
        """``fn`` (float32, twice: the same bits) and ``plain`` (float64)
        on density_inputs with a random cotangent: the value's and the
        gradients' worst shares of their tolerances, one forward and one
        backward launch a call."""
        v, sigma = density_inputs(n, B, seed=seed)
        g = torch.randn(g_shape, generator=gen).to(dev)
        res = []
        for f, dtype in ((fn, torch.float32), (fn, torch.float32),
                         (plain, torch.float64)):
            vt = torch.tensor(v, dtype=dtype, device=dev, requires_grad=True)
            st = torch.tensor(sigma, dtype=dtype, device=dev,
                              requires_grad=True)
            before = dens.launches, dens.launches_backward
            out = f(vt, st, k)
            res.append((out.detach(),) + torch.autograd.grad(
                out, (vt, st), g.to(dtype)))
            if dtype == torch.float32 and (
                    dens.launches - before[0],
                    dens.launches_backward - before[1]) != (1, 1):
                raise AssertionError(f"{fn.__name__}: n={n} B={B} k={k}: "
                                     "not one launch each of K3 and K4")
        if not all(torch.equal(p, q) for p, q in zip(res[0], res[1])):
            raise AssertionError(f"{fn.__name__} differs between two runs: "
                                 f"n={n} B={B} k={k}")
        (o1, dv1, ds1), (o2, dv2, ds2) = [[t.double() for t in r]
                                          for r in res[1:]]
        excess = ((o1 - o2).abs()
                  / (DENSITY_TOL * (1.0 + o2.abs()))).max().item()
        gx = max(((a - b).abs().amax(-1) / (
            DENSITY_GRAD_TOL * (1.0 + b.abs().amax(-1)))).max().item()
            for a, b in ((dv1, dv2), (ds1, ds2)))
        if not (excess <= 1.0 and gx <= 1.0):
            raise AssertionError(
                f"{fn.__name__} != plain: n={n} B={B} k={k}: value error "
                f"{excess:.3f} of its tolerance, gradient error {gx:.3f} of "
                "its tolerance")
        d_err["fwd"] = max(d_err["fwd"], (o1 - o2).abs().max().item())
        d_err["bwd"] = max(d_err["bwd"], (dv1 - dv2).abs().max().item(),
                           (ds1 - ds2).abs().max().item())
        return excess, gx

    for what, fn, plain, shapes in (
            ("log q", dens, so3_wrapped_log_density_plain,
             ((1, 1), (1, 64), (1, 4103), (4, 16384), (500, 1))),
            ("KL", kl_fused, so3_wrapped_kl_plain,
             ((1, 1), (4, 1), (1, 64), (4, 64), (1, 4103), (4, 16384)))):
        for n, B in shapes:
            worst_v, worst_g = 0.0, 0.0
            for k in (0, 1, 10):
                ex, gx = density_case(fn, plain, n, B, k,
                                      (n, B) if what == "log q" else (B,),
                                      seed=10 * k + n)
                worst_v, worst_g = max(worst_v, ex), max(worst_g, gx)
                n_rep += 1
            print(f"   {what}, N={n * B} (n={n}, B={B}), k in (0, 1, 10): "
                  f"worst value error {worst_v:.3f}, worst gradient error "
                  f"{worst_g:.3f} of the tolerance; twice the same bits")
    print(f"   K3 and K4 repeat bit for bit: {n_rep} cases")
    d_timing, dens_us = {}, {}
    for N in (64, 4096, 65536):
        v, sigma = density_inputs(1, N, seed=99)
        vf = torch.tensor(v, device=dev).reshape(N, 3)
        st = torch.tensor(sigma, device=dev)
        g = torch.randn((N,), generator=gen).to(dev)
        dens_us[N] = (
            device_us(lambda: so3_density._launch_kl(vf, st, 10, 1e-3)),
            device_us(lambda: so3_density._launch_bwd(vf, st, g, 10, 1e-3,
                                                      True)))
        if N == 65536:
            continue
        f_ms = cuda_ms(lambda: so3_density._launch_kl(vf, st, 10, 1e-3))
        b_ms = cuda_ms(lambda: so3_density._launch_bwd(vf, st, g, 10, 1e-3,
                                                       True))
        vr = torch.tensor(v, device=dev, requires_grad=True)
        sr = torch.tensor(sigma, device=dev, requires_grad=True)
        pf_ms = cuda_ms(lambda: so3_wrapped_kl_plain(vr, sr, 10))
        ref = so3_wrapped_kl_plain(vr, sr, 10)
        pb_ms = cuda_ms(lambda: torch.autograd.grad(
            ref, (vr, sr), g, retain_graph=True))
        fb = density_bound(N, N, 10, backward=False)
        bb = density_bound(N, N, 10, backward=True)
        d_timing[N] = (f_ms, pf_ms, fb, b_ms, pb_ms, bb)
        print(f"   KL, N=B={N} k=10: K3 {f_ms:.4f} ms (device "
              f"{dens_us[N][0]:.2f} us; plain with grad {pf_ms:.4f}, bound "
              f"{fb[0]:.6f} {fb[1]}); K4 {b_ms:.4f} ms (device "
              f"{dens_us[N][1]:.2f} us; plain autograd {pb_ms:.4f}, bound "
              f"{bb[0]:.6f} {bb[1]})")
    print(f"   KL, N=B=65536 k=10: device us K3 {dens_us[65536][0]:.2f}, K4 "
          f"{dens_us[65536][1]:.2f} (bounds "
          f"{1e3 * density_bound(65536, 65536, 10, False)[0]:.3f}, "
          f"{1e3 * density_bound(65536, 65536, 10, True)[0]:.3f} us)")
    v, sigma = density_inputs(500, 1, seed=98)
    vf, st = torch.tensor(v, device=dev).reshape(500, 3), torch.tensor(
        sigma, device=dev)
    iwll_us = device_us(lambda: so3_density._launch_fwd(vf, st, 10, 1e-3))
    print(f"   log q per sample, n=500 B=1 (the IW-LL's call) k=10: device "
          f"{iwll_us:.2f} us (bound "
          f"{1e3 * density_bound(500, 1, 10, False, per_row=False)[0]:.4f}"
          " us)")
    done(t0)

    t0 = phase("K5/K6: synthesise-then-apply Wigner kernel and its backward "
               "vs the plain version and its autograd on the card")
    k5_err = {"fwd": 0.0, "bwd": 0.0}

    for L in (0, 1, 3, 6, 10):
        S = (L + 1) ** 2
        n, worst_f, worst_g = 0, 0.0, 0.0
        for C in (1, 10):
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

    eps = torch.randn((1, 64, 3), generator=torch.Generator().manual_seed(2))
    exact = train_once("cpu", torch.float64, weights, batch, eps, "fused",
                       recipe=False)
    x_dev = torch.as_tensor(batch, device=dev)
    os.makedirs(PROFILE_DIR, exist_ok=True)
    train_runs = {}
    for recipe, impl, want in (
            (False, "fused", [0, 1, 1, 1, 1, 0, 0]),
            (False, "pallas", [0, 0, 0, 1, 1, 1, 1]),
            (True, "fused", [0, 1, 1, 1, 1, 0, 0]),
            (True, "pallas", [0, 0, 0, 1, 1, 1, 1])):
        key = ("bf16_" if recipe else "") + impl
        t0 = phase(
            f"training, kernel_impl={impl!r}: "
            + ("bench.py's recipe (bfloat16 stacks, float32 image head)"
               if recipe else "the flagship in float32, as bench.py "
               "trains it but for the dtypes")
            + ", sigma clamp pi * 10 / 2, batch 64 of the renders, beta 1")
        for obj, attr in counters:
            setattr(obj, attr, 0)
        mg, opt_g = step_card_vs_cpu(weights, batch, eps, impl, exact,
                                     recipe=recipe)
        delta = [getattr(obj, attr) for obj, attr in counters]
        if delta != want:
            raise AssertionError(
                f"launches in the card's step (K1, K2 forward, K2 backward, "
                f"K3, K4, K5, K6): {delta}, expected {want}")
        for obj, attr in counters:
            setattr(obj, attr, 0)
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
        launched = counts()
        losses = torch.stack(losses).cpu()
        if not torch.isfinite(losses).all():
            raise AssertionError(f"non-finite training loss: "
                                 f"{losses.tolist()}")
        train_ms = statistics.median(step_ms[2:])
        _, prof = profile_request(
            f"train_step_{key}", lambda: train_step(
                mg, opt_g, x_dev, 1.0, generator=noise),
            PROFILE_STEPS, PROFILE_DIR, unit="step of 64",
            watch=("wigner", "so3_density"))
        train_runs[key] = (train_ms, step_ms[:2], losses, launched, prof)
        print(f"   {TRAIN_STEPS} steps: losses {losses[0]:.4f} .. "
              f"{losses[-1]:.4f}, all finite; launches per step (K1, K2 "
              f"forward, K2 backward, K3, K4, K5, K6) {want}")
        print(f"   ms per step (host clock, synchronised, median of steps "
              f"3-{TRAIN_STEPS}): {train_ms:.3f}; first two "
              f"{step_ms[0]:.3f}, {step_ms[1]:.3f}")
        done(t0)
    print("   ms per step (host clock, median of steps 3-20; device busy ms "
          "and device events per step under the profiler): " + "; ".join(
              f"{k} {v[0]:.3f} ({v[4]['busy_ms']:.3f}, {v[4]['events']:.0f})"
              for k, v in train_runs.items()))

    from lie_vae_tpu_torch.cli import main as cli_main
    from lie_vae_tpu_torch.data import ToyDataset
    from lie_vae_tpu_torch.train import UnsupervisedExperiment
    from lie_vae_tpu_torch.train.checkpoint import load_checkpoint
    fused_keys = ("launches", "launches_residuals", "launches_backward")
    block_keys = ("block_launches", "block_launches_backward")
    dens_keys = ("density_launches", "density_launches_backward")

    def cli_run(argv, out_dir, positive, zero, decode_key):
        """``cli.main.main(argv)`` with its checkpoint and logs in
        ``out_dir`` and the IW-LL of LL_ITEMS test items with LL_SAMPLES
        samples: every epoch timed, the kernels of ``positive`` launched and
        those of ``zero`` not (counts set to 0 just before the run), every
        logged loss finite, the best checkpoint served by
        ``InferenceSession.from_checkpoint`` decoding 16 fixed poses as the
        model it saved (one chunk: one launch of ``decode_key``'s kernel
        and none of the other Wigner kernels'), each IW-LL item finite and
        no lower than the mean of its own log-weights (Jensen's
        inequality). Returns the experiment, the seconds per epoch and the
        launch counts."""
        shutil.rmtree(out_dir, ignore_errors=True)
        argv = argv + [
            "--save_dir", out_dir, "--log_dir", os.path.join(out_dir, "logs"),
            "--ll_samples", str(LL_SAMPLES), "--ll_max_items", str(LL_ITEMS)]
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
            experiment = cli_main.main(argv)
        finally:
            UnsupervisedExperiment.train = train_epoch
        launched = counts()
        print(f"   launches in the run: {launched}")
        bad = [k for k in positive if not launched[k]] + [
            k for k in zero if launched[k]]
        if bad:
            raise AssertionError(f"the run launched {launched}: expected "
                                 f"{positive} and not {zero}")
        with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        losses = [r["value"] for r in logged if r["tag"].endswith("_loss")]
        if not losses or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"CLI losses: {losses}")
        print(f"   {len(losses)} logged losses, all finite: "
              + ", ".join(f"{r['tag']} {r['value']:.3f} (it {r['step']})"
                          for r in logged if r["tag"].endswith("_loss")))
        print("   seconds per epoch: "
              + ", ".join(f"{t:.2f}" for t in epoch_s))
        args = cli_main.parse_args(argv)

        def build():
            return cli_main.build_model(
                args, types.SimpleNamespace(rgb=experiment.model.rgb), None)

        ckpt_path = os.path.join(out_dir, cli_main.CHECKPOINT)
        ckpt = load_checkpoint(ckpt_path)
        final_step = experiment.optimizer.count
        ref_model = experiment.model
        if ckpt["step"] != final_step:
            ref_model = build()
            ref_model.load_state_dict(ckpt["model"], strict=True)
        ref_model.eval()
        csess = InferenceSession.from_checkpoint(ckpt_path, build(),
                                                 batch_size=64)
        pose_gen = torch.Generator().manual_seed(4)
        if args.latent_mode == "so3":
            fixed = random_group_matrices(16, pose_gen, device="cpu")
        elif args.latent_mode in ("vmf", "vmfq"):
            fixed = random_quaternions(16, pose_gen, device="cpu")
        else:
            fixed = torch.randn((16, args.normal_dims), generator=pose_gen)
        fixed = fixed.numpy()
        with torch.inference_mode(), ieee_float32():
            want_out = ref_model.decode(
                torch.as_tensor(fixed, device=dev)[None])[0]
        before = counts()
        got_out = csess.decode(fixed)
        after = counts()
        wigner = {k: after[k] - before[k] for k in ("launches",
                                                    "block_launches")}
        if decode_key is not None and (wigner.pop(decode_key) != 1
                                       or any(wigner.values())):
            raise AssertionError(f"a decode chunk of the served checkpoint "
                                 f"launched {wigner}, expected one launch "
                                 f"of {decode_key}")
        d_ckpt = np.abs(got_out - want_out.cpu().numpy()).max()
        source = ("experiment" if ref_model is experiment.model
                  else "checkpoint")
        print(f"   best checkpoint: step {ckpt['step']} of {final_step}; "
              f"InferenceSession.from_checkpoint decodes 16 fixed poses (one "
              f"chunk) within {d_ckpt:.3e} of the {source}'s model")
        if not d_ckpt <= 1e-5:
            raise AssertionError("the served checkpoint decodes otherwise "
                                 "than the experiment's model")
        ll = experiment.last_ll
        if ll is None or len(ll["items"]) != LL_ITEMS:
            raise AssertionError(f"IW-LL items: {ll}")
        gap = ll["items"] - ll["mean_log_weights"]
        if not (np.isfinite(ll["items"]).all() and (gap >= 0).all()):
            raise AssertionError(f"IW-LL {ll['items']} against the mean "
                                 f"log-weights {ll['mean_log_weights']}")
        print(f"   IW-LL over {LL_ITEMS} items, n={LL_SAMPLES}: mean "
              f"{ll['items'].mean():.3f}, each finite and above the mean of "
              f"its own log-weights by {gap.min():.3f} .. {gap.max():.3f}")
        return experiment, epoch_s, launched

    t0 = phase("the CLI on the card: python -m lie_vae_tpu_torch.cli.main "
               "--dataset spherecube --kernel_impl pallas, flagship defaults, "
               "the renders")
    experiment, epoch_s, cli_launches = cli_run(
        ["--dataset", "spherecube", "--kernel_impl", "pallas", "--data_dir",
         DATA_DIR, "--epochs", str(CLI_EPOCHS)], CLI_DIR,
        block_keys + dens_keys, fused_keys, "block_launches")
    ll = experiment.last_ll
    done(t0)

    # the toy set is generated by the CLI's first run (K1 rotating the
    # spectrum); count and time it there
    toy_gen = {}
    from_poses = ToyDataset.from_poses

    def counted_from_poses(*a, **k):
        before, tg = fused.launches, time.perf_counter()
        out = from_poses(*a, **k)
        torch.cuda.synchronize()
        toy_gen.update(k1=fused.launches - before,
                       s=time.perf_counter() - tg)
        return out

    shutil.rmtree(os.path.dirname(TOY_PATH), ignore_errors=True)
    toy_runs = {}
    ToyDataset.from_poses = counted_from_poses
    try:
        for impl, positive, zero, key in (
                ("fused", fused_keys + dens_keys, block_keys, "launches"),
                ("pallas", block_keys + dens_keys, fused_keys,
                 "block_launches")):
            t0 = phase(f"the toy experiment: python -m "
                       f"lie_vae_tpu_torch.cli.main --kernel_impl {impl} at "
                       f"the CLI's defaults (toy dataset, L = 6, C = 10)")
            exp_t, toy_s, toy_l = cli_run(
                ["--kernel_impl", impl, "--toy_path", TOY_PATH, "--epochs",
                 str(CLI_EPOCHS)], os.path.join(CLI_DIR, f"toy_{impl}"),
                positive, zero, key)
            toy_runs[impl] = (toy_s, float(exp_t.last_ll["items"].mean()),
                              toy_l)
            done(t0)
    finally:
        ToyDataset.from_poses = from_poses
    toy_len = len(ToyDataset(path=TOY_PATH))
    print(f"   the toy set: {toy_len} items generated in {toy_gen['s']:.2f} "
          f"s with {toy_gen['k1']} launches of K1")
    if toy_len != 1000 or toy_gen.get("k1", 0) < 1:
        raise AssertionError(f"the toy set: {toy_len} items, {toy_gen}")

    t0 = phase("--config normal (Gaussian latent, MLP decoder) on the "
               "renders, one epoch")
    _, normal_cli_s, normal_launches = cli_run(
        ["--config", "normal", "--dataset", "spherecube", "--data_dir",
         DATA_DIR, "--epochs", "1"], os.path.join(CLI_DIR, "normal"), (),
        fused_keys + dens_keys + block_keys, None)
    done(t0)

    t0 = phase(f"a Gaussian latent with the action decoder: {NORMAL_STEPS} "
               "steps on the renders, then served at batch 64 on the card "
               "and on the CPU")
    from lie_vae_tpu_torch.models import LieVAE
    normal_cfg = dict(latent_mode="normal", decoder_mode="action",
                      encode_mode="conv", deconv_mode="deconv", degrees=6,
                      rep_copies=10, conv_hidden=50, deconv_hidden=200,
                      rgb=True, kernel_impl="fused")
    torch.manual_seed(5)
    nmodel = LieVAE(**normal_cfg)
    nopt = make_optimizer(nmodel.named_parameters(), lr=1e-3,
                          clip_grads=1e-5)
    noise = torch.Generator().manual_seed(6)
    want = [0, 1, 1, 0, 0, 0, 0]
    for _ in range(NORMAL_STEPS):
        before = [getattr(obj, attr) for obj, attr in counters]
        metrics = train_step(nmodel, nopt, x_dev, 1.0, generator=noise)
        delta = [getattr(obj, attr) - b
                 for (obj, attr), b in zip(counters, before)]
        if delta != want or not torch.isfinite(metrics["loss"]):
            raise AssertionError(f"a normal/action step: launches {delta} "
                                 f"(expected {want}), loss "
                                 f"{float(metrics['loss'])}")
    print(f"   {NORMAL_STEPS} steps, loss {float(metrics['loss']):.4f}; "
          f"launches per step (K1, K2 forward, K2 backward, K3, K4, K5, "
          f"K6) {want}")
    state = {k: v.detach().cpu() for k, v in nmodel.state_dict().items()}
    nsess = InferenceSession(LieVAE(**normal_cfg), state, batch_size=64)
    ncpu = InferenceSession(LieVAE(**dict(normal_cfg, device="cpu")), state,
                            batch_size=64, device="cpu")
    k1 = fused.launches
    n_enc = nsess.encode(batch)
    n_dec = nsess.decode(n_enc["pose"])
    n_smp = nsess.sample(64, seed=7)
    n_rec = nsess.reconstruct(batch)
    n_geo = nsess.geodesic(n_enc["pose"][0], n_enc["pose"][1], steps=16)
    n_k1 = fused.launches - k1
    if n_k1 != 4:
        raise AssertionError(f"{n_k1} launches of K1 for four decode "
                             "chunks")
    check_images(n_dec, (64, 64, 64, 3), "decode")
    check_images(n_geo, (16, 64, 64, 3), "geodesic")
    if n_enc["pose"].shape != (64, 3) or n_enc["sigma"].shape != (64, 3):
        raise AssertionError(f"encode {n_enc['pose'].shape}")
    c_enc = ncpu.encode(batch)
    d_img_n = max(np.abs(a - b).max() for a, b in (
        (n_dec, ncpu.decode(n_enc["pose"])), (n_smp, ncpu.sample(64, seed=7)),
        (n_rec, ncpu.reconstruct(batch)),
        (n_geo, ncpu.geodesic(n_enc["pose"][0], n_enc["pose"][1],
                              steps=16))))
    d_pose_n = max(np.abs(n_enc[k] - c_enc[k]).max()
                   for k in ("pose", "sigma", "sample"))
    print(f"   encode/decode/sample/reconstruct/geodesic at batch 64: "
          f"{n_k1} launches of K1 (one per decode chunk); card vs CPU: max "
          f"|output diff| {d_img_n:.3e} (tol {IMAGE_TOL}), max |pose/sigma "
          f"diff| {d_pose_n:.3e} (tol {POSE_TOL})")
    if not (d_img_n <= IMAGE_TOL and d_pose_n <= POSE_TOL):
        raise AssertionError("the normal/action session on the card "
                             "disagrees with the CPU's")
    done(t0)

    t0 = phase(f"the vMF latents at the flagship's widths: a vmfq/action "
               f"model, {VMF_STEPS} steps 'fused' and {VMF_STEPS} 'pallas', "
               f"a vmf/mlp model, {VMF_STEPS} steps, the first of each "
               "held against the CPU's")
    vcfg = dict(VMF_CFG, latent_mode="vmfq", decoder_mode="action",
                kernel_impl="fused")

    def seeded(cfg, seed):
        """The layers a vMF model shares with the flagship from the
        converged weights, the rest (the vMF heads, an MLP decoder) from
        ``seed``: from random weights alone the float32 conv gradients
        cancel so far that the CPU's own float32 step is 13% of a
        gradient's largest entry from the exact step, and no device can be
        held to it."""
        torch.manual_seed(seed)
        own = LieVAE(**dict(cfg, device="cpu")).state_dict()
        return {k: (weights[k] if k in weights and weights[k].shape
                    == v.shape else v) for k, v in own.items()}

    vweights = seeded(vcfg, 8)
    vmf_paths, vmf_worst = {}, {}

    def shares(worst):
        bias = worst["bias"]
        return "; ".join(f"{k}: card {v[1]:.3e}, CPU float32 {v[2]:.3e}, "
                         f"worst {v[0]:.3f} of the allowance"
                         for k, v in worst.items() if k != "bias") + (
            f"; the biases before BatchNorm at most {bias[1]:.3e} (card, "
            f"tol {BIAS_TOL}) and {bias[2]:.3e} (CPU) of their weight's "
            "gradient")

    for impl, want in (("fused", [0, 1, 1, 0, 0, 0, 0]),
                       ("pallas", [0, 0, 0, 0, 0, 1, 1])):
        tv = time.perf_counter()
        vmodel, vopt, vmf_paths[impl], vmf_worst[impl], vloss = vmf_steps(
            dict(vcfg, kernel_impl=impl), vweights, batch, x_dev, 9,
            counters, want, checked=1)
        print(f"   vmfq/action, {impl!r}: {VMF_STEPS} steps, loss {vloss:.4f}"
              f" after them, launches {vmf_paths[impl]} (K1, K2 forward, K2 "
              f"backward, K3, K4, K5, K6); the first against the exact "
              "step: "
              + shares(vmf_worst[impl])
              + f"; {time.perf_counter() - tv:.2f} s")
        if impl == "fused":
            vstate = {k: v.detach().cpu()
                      for k, v in vmodel.state_dict().items()}
            # the step as the harness runs it: the sampler's proposals from
            # a CPU generator, accept/reject on the card
            noise = torch.Generator().manual_seed(18)
            # beside it, the same step with its noise already on the card
            # (the sampler's host work left out): the difference is what
            # the generator's path costs the host
            g = torch.randn((2, 3, 1, 64), generator=noise)
            x2, y2 = (g * g).sum(1)
            fixed = ((x2 / (x2 + y2)).to(dev),
                     torch.randn((1, 64, 4), generator=noise).to(dev))
            vms, fixed_ms = [], []
            for i in range(2 * TRAIN_STEPS):
                kw = {"generator": noise} if i % 2 else {"eps": fixed}
                ts = time.perf_counter()
                met = train_step(vmodel, vopt, x_dev, 1.0, **kw)
                torch.cuda.synchronize()
                (vms if i % 2 else fixed_ms).append(
                    1e3 * (time.perf_counter() - ts))
                if not torch.isfinite(met["loss"]):
                    raise AssertionError("non-finite vmfq loss")
            _, vprof = profile_request(
                "train_step_vmfq_fused", lambda: train_step(
                    vmodel, vopt, x_dev, 1.0, generator=noise),
                PROFILE_STEPS, PROFILE_DIR, unit="step of 64",
                watch=("wigner",))
            vmf_step_ms = statistics.median(vms[2:])
            vmf_fixed_ms = statistics.median(fixed_ms[2:])
            print(f"   vmfq 'fused', the generator's noise: ms per step "
                  f"(host clock, median of steps 3-{TRAIN_STEPS}, taken in "
                  f"turns with steps whose noise is on the card already) "
                  f"{vmf_step_ms:.3f} ({vmf_fixed_ms:.3f} with the noise on "
                  f"the card); under the profiler: device busy "
                  f"{vprof['busy_ms']:.3f} ms, {vprof['events']:.0f} device "
                  "events per step")
    mcfg = dict(VMF_CFG, latent_mode="vmf", decoder_mode="mlp")
    mweights = seeded(mcfg, 10)
    *_, vmf_worst["vmf_mlp"], mloss = vmf_steps(
        mcfg, mweights, batch, x_dev, 11, counters, [0] * 7, checked=1)
    print(f"   vmf/mlp: {VMF_STEPS} steps, loss {mloss:.4f}, no kernel "
          "launched; the first against the exact step: "
          + shares(vmf_worst["vmf_mlp"]))
    done(t0)

    t0 = phase("the vmfq model served at batch 64 on the card ('fused') and "
               "on the CPU")
    qsess = InferenceSession(LieVAE(**vcfg), vstate, batch_size=64)
    qcpu = InferenceSession(LieVAE(**dict(vcfg, device="cpu")), vstate,
                            batch_size=64, device="cpu")
    for obj, attr in counters:
        setattr(obj, attr, 0)
    q_enc = qsess.encode(batch)
    pair_gen = torch.Generator().manual_seed(12)
    g = torch.randn((2, 3, 64), generator=pair_gen)
    x2, y2 = (g * g).sum(1)
    pair = ((x2 / (x2 + y2)).numpy(),
            torch.randn((64, 4), generator=pair_gen).numpy())
    q_encp = qsess.encode(batch, eps=pair)
    q_dec = qsess.decode(q_enc["pose"])
    q_smp = qsess.sample(64, seed=13)
    q_rec = qsess.reconstruct(batch)
    q_geo = qsess.geodesic(q_enc["pose"][0], q_enc["pose"][1], steps=16)
    vmfq_serve = counts()
    if vmfq_serve["launches"] != 4 or any(
            v for k, v in vmfq_serve.items() if k != "launches"):
        raise AssertionError(f"the vmfq session launched {vmfq_serve}, "
                             "expected K1 once per decode chunk (4)")
    check_images(q_dec, (64, 64, 64, 3), "decode")
    check_images(q_geo, (16, 64, 64, 3), "geodesic")
    kappa = q_enc["sigma"]
    if q_enc["pose"].shape != (64, 4) or kappa.shape != (64, 1) or not (
            np.isfinite(kappa).all() and (kappa >= 1).all()):
        raise AssertionError(f"vmfq encode: pose {q_enc['pose'].shape}, "
                             f"kappa {kappa.shape}")
    norms = np.linalg.norm(np.concatenate([q_enc["pose"], q_enc["sample"]]),
                           axis=-1)
    c_enc = qcpu.encode(batch)
    c_encp = qcpu.encode(batch, eps=pair)
    d_img_q = max(np.abs(a - b).max() for a, b in (
        (q_dec, qcpu.decode(q_enc["pose"])), (q_smp, qcpu.sample(64, seed=13)),
        (q_rec, qcpu.reconstruct(batch)),
        (q_geo, qcpu.geodesic(q_enc["pose"][0], q_enc["pose"][1],
                              steps=16))))
    d_pose_q = max(np.abs(a[k] - b[k]).max() for a, b in (
        (q_enc, c_enc), (q_encp, c_encp)) for k in ("pose", "sigma",
                                                    "sample"))
    print(f"   kappa from the heads: {kappa.min():.4f} .. {kappa.max():.4f}; "
          f"|pose|, |sample| within {np.abs(norms - 1).max():.2e} of 1; "
          f"launches {vmfq_serve['launches']} of K1 for four decode chunks; "
          f"card vs CPU: max |output diff| {d_img_q:.3e} (tol {IMAGE_TOL}), "
          f"max |pose/kappa/sample diff| {d_pose_q:.3e} (tol {POSE_TOL}), "
          "the generator's draws and handed-over noise both")
    if not (d_img_q <= IMAGE_TOL and d_pose_q <= POSE_TOL
            and np.abs(norms - 1).max() < 1e-5):
        raise AssertionError("the vmfq session on the card disagrees with "
                             "the CPU's")
    done(t0)

    t0 = phase("the CLI on vMF: python -m lie_vae_tpu_torch.cli.main "
               "--dataset spherecube --latent_mode vmfq --kernel_impl "
               "pallas, one epoch")
    _, vmfq_cli_s, vmfq_cli_launches = cli_run(
        ["--dataset", "spherecube", "--latent_mode", "vmfq", "--kernel_impl",
         "pallas", "--data_dir", DATA_DIR, "--epochs", "1"],
        os.path.join(CLI_DIR, "vmfq"), block_keys,
        fused_keys + dens_keys, "block_launches")
    done(t0)

    t0 = phase("the HTTP server on the card: serve_http over the flagship "
               "session (batch 64, 'fused'), one client, against an "
               "in-process session with the same seed")
    http_ms, http_launches = http_phase(counters, counts, batch)
    done(t0)

    t0 = phase("cli.serve export: the CLI phase's checkpoint.pt -> .npz -> "
               "a session; cli.serve sample from it on the card")
    export_phase(CLI_DIR, ["--dataset", "spherecube", "--kernel_impl",
                           "pallas"])
    done(t0)

    t0 = phase("the graphed session: serve.export_aot of the flagship, "
               "AotSession(path) with no model flags, 'fused' (K1 in the "
               "decode graph) and 'pallas' (K5), and a vmfq model's")
    aot_poses = random_group_matrices(
        64, torch.Generator().manual_seed(20), device="cpu").numpy()
    aot_runs, aot_replays, aot_launches = {}, {}, dict.fromkeys(counts(), 0)
    for impl in ("fused", "pallas"):
        aot_sess, aot_runs[impl], aot_replays[impl], built = aot_phase(
            impl, counters, counts, batch, aot_poses, timed=impl == "fused")
        aot_launches = {k: v + built[k] for k, v in aot_launches.items()}
        if impl == "fused":
            aot_fused = aot_sess
    aot_vmfq = aot_vmfq_check(vcfg, vstate, batch)
    print(f"   launches of the graphed flagship sessions' constructions "
          f"({AOT_CAPTURE_LAUNCHES} a session: two eager runs and a capture "
          f"of the decode and reconstruct graphs): {aot_launches}; graph "
          f"replays {aot_replays}")
    done(t0)

    t0 = phase(f"bench_serve_load against the graphed session ('fused') "
               f"behind the HTTP server: /v1/reconstruct (both graphs), "
               f"{LOAD_CLIENTS} clients, {LOAD_SECONDS} s each, requests of "
               "64")
    from lie_vae_tpu_torch import bench_serve_load
    for obj, attr in counters:
        setattr(obj, attr, 0)
    load_before = dict(aot_fused.replays)
    load_rows = bench_serve_load.run(
        aot_fused, clients=LOAD_CLIENTS, routes=("reconstruct",),
        duration=LOAD_SECONDS, req_batch=64)
    load_launches = counts()
    load_replays = {k: aot_fused.replays[k] - load_before[k]
                    for k in load_before}
    aot_fused.close()
    if any(load_launches.values()) or not (
            load_replays["reconstruct"] and load_replays["encode"] == 0):
        raise AssertionError(f"the load run launched {load_launches} and "
                             f"replayed {load_replays}")
    print(f"   graph replays in the run {load_replays}, no kernel launched "
          "outside a graph")
    done(t0)

    t0 = phase(f"sc-pairs renders: {REG_RENDER} seeded consecutive-pose "
               "pairs with the port's generator")
    tr0 = time.perf_counter()
    pair_images = gen_spherecube.generate(REG_RENDER, PAIRS_DIR, pairs=True)
    pairs_s = time.perf_counter() - tr0
    if pair_images.shape != (2 * REG_RENDER, 64, 64, 3):
        raise AssertionError(f"pair renders {pair_images.shape}")
    print(f"   {2 * REG_RENDER} renders in {pairs_s:.2f} s -> {PAIRS_DIR}")
    done(t0)

    from lie_vae_tpu_torch.data import ScPairsDataset
    pbatch = ScPairsDataset.prep_batch(ScPairsDataset(PAIRS_DIR).gather(
        np.arange(REG_PAIRS)))[-1]
    px_dev = torch.as_tensor(pbatch, device=dev)
    n_rows = pbatch.shape[0]
    reg_gen = torch.Generator().manual_seed(21)
    reg_noise = (torch.randn((1, n_rows, 3), generator=reg_gen),
                 torch.rand((n_rows,), generator=reg_gen) * (2 * math.pi),
                 torch.randn((1, n_rows, 3), generator=reg_gen))
    reg_runs, reg_worst = {}, {}
    reg_exact = reg_cpu = None
    for obj, attr in counters:
        setattr(obj, attr, 0)
    reg_total = dict.fromkeys(counts(), 0)
    for impl, rotate, want in (("fused", "shear", [0, 1, 1, 1, 1, 0, 0]),
                               ("pallas", "shear", [0, 0, 0, 1, 1, 1, 1]),
                               ("fused", "gather", [0, 1, 1, 1, 1, 0, 0])):
        t0 = phase(f"the regularised step, kernel_impl={impl!r}, rotation "
                   f"{rotate!r}: the flagship from the converged weights, "
                   f"equivariance {REG_EQ:g}, encoder continuity "
                   f"{REG_CONT:g}, {REG_PAIRS} pairs = {n_rows} images, held "
                   "against the exact float64 step")
        before = counts()
        mg, opt_g, _, reg_worst[f"{impl}_{rotate}"], ex, cp = reg_step(
            weights, pbatch, reg_noise, impl, rotate,
            *((reg_exact, reg_cpu) if rotate == "shear" else (None, None)))
        if rotate == "shear":
            reg_exact, reg_cpu = ex, cp
        delta = [counts()[k] - before[k] for k in before]
        if delta != want:
            raise AssertionError(f"launches in the card's regularised step "
                                 f"(K1, K2 forward, K2 backward, K3, K4, K5, "
                                 f"K6): {delta}, expected {want}")
        if rotate == "gather":
            reg_total = {k: reg_total[k] + d for k, d in zip(before, delta)}
            done(t0)
            continue
        noise = torch.Generator().manual_seed(22)

        def reg_train_step():
            return train_step(mg, opt_g, px_dev, 1.0, generator=noise,
                              equivariance_lamb=REG_EQ,
                              encoder_continuity_lamb=REG_CONT)

        step_ms, losses = [], []
        for _ in range(TRAIN_STEPS):
            b4 = counts()
            ts = time.perf_counter()
            met = reg_train_step()
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - ts))
            d = [counts()[k] - b4[k] for k in b4]
            if d != want:
                raise AssertionError(f"launches in one regularised step: "
                                     f"{d}, expected {want}")
            losses.append(met["loss"])
        losses = torch.stack(losses).cpu()
        if not torch.isfinite(losses).all():
            raise AssertionError(f"non-finite losses {losses.tolist()}")
        _, rprof = profile_request(
            f"train_step_reg_{impl}", reg_train_step, PROFILE_STEPS,
            PROFILE_DIR, unit=f"step of {n_rows}",
            watch=("wigner", "so3_density"))
        reg_runs[impl] = {"ms": statistics.median(step_ms[2:]),
                          "first_ms": step_ms[:2],
                          "loss": [float(losses[0]), float(losses[-1])],
                          "profiled": rprof}
        after = counts()
        reg_total = {k: reg_total[k] + after[k] - before[k] for k in after}
        print(f"   {TRAIN_STEPS} steps: losses {losses[0]:.4f} .. "
              f"{losses[-1]:.4f}, launches per step {want}; ms per step "
              f"(host clock, median of steps 3-{TRAIN_STEPS}) "
              f"{reg_runs[impl]['ms']:.3f}, first two {step_ms[0]:.3f}, "
              f"{step_ms[1]:.3f}; profiled: device busy "
              f"{rprof['busy_ms']:.3f} ms, {rprof['events']:.0f} device "
              "events per step")
        done(t0)
    reg_launches = reg_total

    t0 = phase("the paper's regularised CLI: python -m "
               "lie_vae_tpu_torch.cli.main --config scpairs reg "
               "--kernel_impl pallas, one epoch on the pair renders, both "
               "regularizers at the preset's full weights")
    scp_dir = os.path.join(CLI_DIR, "scpairs")
    # LinearSchedule(0, v, 1000, 999) holds v up to step 999: the short
    # epoch trains with both losses weighted (the presets' ramps start at
    # step 1000)
    _, scp_epoch_s, scp_launches = cli_run(
        ["--config", "scpairs", "reg", "--kernel_impl", "pallas",
         "--data_dir", PAIRS_DIR, "--epochs", "1",
         "--equivariance_end_it", "999",
         "--encoder_continuity_end_it", "999"], scp_dir,
        block_keys + dens_keys, fused_keys, "block_launches")
    with open(os.path.join(scp_dir, "logs", "metrics.jsonl")) as f:
        scp_tags = {r["tag"]: r["value"] for r in map(json.loads, f)}
    reg_tags = {k: scp_tags.get(k) for k in (
        "equivariance", "equivariance_lamb", "encoder_continuity",
        "encoder_continuity_lamb")}
    print(f"   regularizer tags: {reg_tags}")
    if not (all(v is not None and math.isfinite(v)
                for v in reg_tags.values())
            and reg_tags["equivariance_lamb"] == REG_EQ
            and reg_tags["encoder_continuity_lamb"] == REG_CONT):
        raise AssertionError(f"the regularizer tags: {reg_tags}")
    done(t0)

    t0 = phase("precision in a fresh interpreter with torch's defaults: "
               "a session's decode and one train_step")
    c5 = precision_subprocess(batch, cpu, float(exact[2]["loss"]))
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
             d_err["fwd"], "density_launches", "KL entry, N=B=64 k=10",
             4096),
            ("so3_density_bwd", src_dens,
             "lie_vae_tpu/ops/kernels/so3_density.py:57", d_timing,
             d_err["bwd"], "density_launches_backward",
             "KL cotangent, N=B=64 k=10", 4096),
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
        if name.startswith("so3_density"):
            kernels[-1]["device_us"] = dens_us[64][back]
            kernels[-1]["device_us_b4096"] = dens_us[4096][back]
            kernels[-1]["device_us_n65536"] = dens_us[65536][back]
            if not back:
                kernels[-1]["device_us_iwll_n500"] = iwll_us
    # each kernel's launches on every path this script drives, counts set
    # to 0 just before the path and read just after
    paths = {f"train_{k}": v[3] for k, v in train_runs.items()}
    paths["cli_spherecube_pallas"] = cli_launches
    paths.update({f"toy_cli_{k}": v[2] for k, v in toy_runs.items()})
    paths["normal_cli"] = normal_launches
    paths["vmfq_train"] = dict(zip(counts(), (
        a + b for a, b in zip(vmf_paths["fused"], vmf_paths["pallas"]))))
    paths["vmfq_serve"] = vmfq_serve
    paths["vmfq_cli"] = vmfq_cli_launches
    paths["http"] = http_launches
    paths["aot_serve"] = aot_launches
    paths["aot_http"] = load_launches
    paths["reg_train"] = reg_launches
    paths["scpairs_cli"] = scp_launches
    # graph replays run the kernels captured in them without their wrapper:
    # counted apart, per graph holding the kernel
    graph_replays = {
        "launches": sum(aot_replays["fused"][k] for k in ("decode",
                                                          "reconstruct"))
        + load_replays["reconstruct"],
        "block_launches": sum(aot_replays["pallas"][k]
                              for k in ("decode", "reconstruct"))}
    for entry in kernels:
        key = {"wigner_chain_fwd": "launches",
               "wigner_chain_fwd_res": "launches_residuals",
               "wigner_chain_bwd": "launches_backward",
               "so3_density_fwd": "density_launches",
               "so3_density_bwd": "density_launches_backward",
               "wigner_block_fwd": "block_launches",
               "wigner_block_bwd": "block_launches_backward"}[entry["name"]]
        entry["launches_by_path"] = {p: c[key] for p, c in paths.items()}
        entry["launches_by_path"]["toy_generate"] = (
            toy_gen["k1"] if key == "launches" else 0)
        entry["launches_by_path"]["aot_graph_replays"] = graph_replays.get(
            key, 0)
        if not entry["launches"] or not any(
                entry["launches_by_path"].values()):
            raise AssertionError(f"{entry['name']} was launched on no path: "
                                 f"{entry['launches_by_path']}")
    record = {"kernels": kernels, "build_s": build_s,
              "ptxas": ptxas_all, "pallas_op_device_us": op_us,
              "request_ms": req_ms,
              "render_s": render_s,
              "train_step_ms": {k: v[0] for k, v in train_runs.items()},
              "train_step_ms_first": {k: v[1] for k, v in train_runs.items()},
              "train_step_profiled": {k: v[4] for k, v in train_runs.items()},
              "train_loss": {k: [float(v[2][0]), float(v[2][-1])]
                             for k, v in train_runs.items()},
              "cli_epoch_s": epoch_s,
              "cli_ll": float(ll["items"].mean()),
              "toy_generate_s": toy_gen["s"],
              "toy_epoch_s": {k: v[0] for k, v in toy_runs.items()},
              "toy_ll": {k: v[1] for k, v in toy_runs.items()},
              "normal_cli_epoch_s": normal_cli_s,
              "normal_session_max_diff": [float(d_img_n), float(d_pose_n)],
              "vmf_step_worst_share": vmf_worst,
              "vmfq_step_ms": vmf_step_ms,
              "vmfq_step_ms_noise_on_card": vmf_fixed_ms,
              "vmfq_step_profiled": vprof,
              "vmfq_session_max_diff": [float(d_img_q), float(d_pose_q)],
              "vmfq_kappa_range": [float(kappa.min()), float(kappa.max())],
              "vmfq_cli_epoch_s": vmfq_cli_s,
              "http_request_ms": http_ms,
              "precision_fresh_process": c5,
              "aot": aot_runs, "aot_replays": aot_replays,
              "aot_vmfq_max_diff": aot_vmfq, "aot_load": load_rows,
              "aot_load_replays": load_replays, "pairs_render_s": pairs_s,
              "reg_step": reg_runs, "reg_step_worst_share": reg_worst,
              "scpairs_cli_epoch_s": scp_epoch_s, "scpairs_tags": reg_tags,
              "total_s": time.perf_counter() - t_start}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
