"""Drive the PyTorch port's serving path, its training step (in float32
and in bench.py's bfloat16 recipe), its data path (native renders, PNG
datasets, the disk cache, the threaded loader), its experiment CLI
(sphere-cube renders, the toy experiment, the Gaussian baseline), a
Gaussian-latent session, the vMF latents, the HTTP server, the serving
CLI's export, the graphed ahead-of-time session, the paper's regularised
training on sc-pairs, the latent-space analysis and checkpoint
evaluation, the toy drivers, and training and serving over meshes on one
NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, each timed:

1. card: name and power limit (nvidia-smi), torch, CUDA and nvcc versions;
2. build: the Wigner chain kernels (csrc/wigner_chain.cu), the density
   kernels (csrc/so3_density.cu) and the synthesise-then-apply Wigner
   kernels (csrc/wigner_block.cu), one nvcc each, and the data path's host
   library (csrc/render_native.cpp: the native renderer and the PNG
   unfilter) with g++, all started together, each nvcc with ``-Xptxas
   -v``, whose report of each kernel's registers, stack frame and spills
   the build keeps beside the library; beside the builds, the profiler's
   first use (seconds of host time) and the start of phase 23's fresh
   interpreter;
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
   pi * 10 / 2, v = 0 and |v| near multiples of 2 pi, and k = 30 (the
   generic-k instantiation, which the evaluation's k = 30 runs); then the
   KL entry
   (K3 with the mean over n and the Haar prior folded in, K4 taking its
   (B,) cotangent) against the plain KL and its autograd, n in {1, 4}, on
   the same grid; every case run twice to repeat bit for bit; timed at
   N = 64 and N = 4096 with CUDA events, and by device time from a CUDA
   graph of 20 launches at N in {64, 4096, 65536} (the KL entry, the
   training path) and at n = 500, B = 1 (the per-sample entry, the IW-LL's
   call, at k = 10 and k = 30);
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
8. renders: 1024 poses of data_poses/spherecube.npz rendered natively into
   a directory of PNG files in the JAX package's layout
   (``cli/gen_spherecube.py``) in chiprun_out/; 64 of them also by the numpy
   ray-caster, held within 1e-4, the uint8 bytes that differ counted;
   seconds per 1024 images natively and with numpy (timed on those 64);
   the dataset opened cold (ms per image decoded, on 256), ``warm_cache``
   decoding and writing the disk cache, and an open that reads it, each
   open's items equal to the rendered bytes; the threaded ``BatchLoader``
   giving the serial batches; every later phase that trains on renders
   takes the images read back;
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
   kernels) on the renders with ``--device_data`` (the dataset's
   ``warm_cache`` reading the renders phase's disk cache), one epoch,
   checked as the CLI phase;
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
   pallas --device_data``, one epoch on the renders, checked as the CLI
   phase;
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
   of 100 rows: decode bit for bit, encode and reconstruct within 1e-6;
   the uint8 request's reconstruct bit for bit its float32 twin's, scaled
   by numpy, and every byte scaled on the card numpy's x / 255),
   the kernel named in a torch.profiler trace of one decode replay (a
   trace with under half the device events of the same call ungraphed is
   taken again, at most 3 in all; one with them and no kernel fails), and
   held again after 200 replays of varied requests; then, at torch's
   defaults, ms per request of 64 graphed and ungraphed in turns and the
   device's busy share of a decode ('fused'); a ``vmfq`` model's graphed
   session (the sampler's pick inside the graph) against its ungraphed
   twin;
19. ``bench_serve_load``: the graphed 'fused' session behind the HTTP
   server, /v1/reconstruct at 1 and 4 clients, 2 s each: requests/s,
   images/s, p50/p95 latency; replays only, no launch outside a graph;
   then ``python -m lie_vae_tpu_torch.cli.serve bench --aot`` of the same
   artifact in a fresh interpreter, whose JSON line must give
   ``device_ms_per_batch`` (CUDA events around graph replays) for encode
   and reconstruct;
20. sc-pairs: 320 seeded consecutive-pose pairs rendered natively by the
   port's generator as PNG pairs into chiprun_out/;
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
23. a fresh interpreter with torch's default precision settings (started
   in the build phase, where it imports and warms its profiler up, and
   handed its inputs here): an ``InferenceSession`` decode of the
   flagship and one ``train_step``, which must run in IEEE float32
   (``precision.ieee_float32``) and leave the settings as they found them;
   the flags seen inside, the cuDNN kernels named TF32, and the distance
   to the CPU, printed;
24. the analysis: ``cli.analyze_spherecube`` on the converged flagship at
   full width on the card, 200 poses of each trajectory rendered natively,
   encoded, their discontinuity and PCA, the encoded-pose and recon strips,
   run twice: 'fused' (K1 in the decodes) and ``--kernel_impl pallas``
   (K5), each a path of its own; each held against the same analysis on
   the CPU (the encodings to POSE_TOL, the recon strip to IMAGE_TOL, the
   discontinuity means and maxima and the reconstruction error to 1e-3
   relative, the outlier counts up to the jumps within 1e-3 of their
   threshold), each model's modes, flags, shell count and weights as
   before; ``analysis.toy_inputs_for_trajectory`` with 'fused' (K1) and
   'pallas' (K5), a path of its own, against the plain chain to
   KERNEL_TOL;
25. ``cli.eval_checkpoint`` on the CLI phase's best checkpoint at
   ``--density_k 10 30``, ``--ll_n 500``, a few items (K1 in the decode,
   K3 at k = 10 and at k = 30): both IW-LLs finite, each item's no lower
   than the mean of its own log-weights; the difference printed.

26. the toy drivers: ``cli.run_degree_sweep --degrees 3 10 16`` for 3
   epochs at the script's widths (n = 1024, 4 copies; 'fused': K1
   generates each toy set, K2 trains, up to its degree-16 instantiation),
   its table merged into chiprun_out/; at each swept degree the toy set
   by K1 and K1/K2 on its first 64 poses against the plain chain and its
   autograd; device us of K1, K2 forward and backward, K5 and K6 at B =
   64, C = 4 for L = 10 and 16 beside their bounds; ``cli.analyze_toy
   --configs all`` for one epoch ('fused': K1, K2, K3, K4) and its six
   defaults with ``--kernel_impl pallas`` (K5, K6, K3, K4), every result
   finite, K5/K6 at the toy shape against the plain version;
27. training over process meshes: the flagship from the converged weights
   at a global batch of 64 renders, each rank a child process of
   ``python -m torch.distributed.run`` running ``parallel.run_steps``
   (which trains through ``UnsupervisedExperiment.train``) under a time
   limit (a rank that fails or runs out of time fails the script): 2 ranks
   x 32 on the one card over gloo (the mesh 2 x 1, 5 steps, 'fused' and
   'pallas') and the mesh 1 x 2 (the big layers split, 3 steps) in one
   launch of 2 ranks, and one rank over NCCL (3 steps); after every step
   each rank's loss, parameters and BatchNorm statistics held against the
   single-process card step on the same rows and noise, each tolerance
   plus twice the CPU's own float32 error against the exact float64 step
   there (C3); the backend, host ms a step per rank and each rank's
   launches of K2-K6 printed. Then the entry point a user runs, ``python
   -m torch.distributed.run --nproc_per_node 4 -m lie_vae_tpu_torch.cli.main
   --mesh_data 2 --mesh_model 2`` (gloo, the one card) on 320 of the
   renders from the converged weights, one epoch of 3 steps, ``test()``,
   the IW-LL and the checkpoint rank 0 writes: the checkpoint and the
   IW-LL held against the single-process CLI's (the card, and the CPU in
   float32 and float64), each rank's launches counted. Every launch is
   started right after the builds, each rank importing torch and the port
   and making its CUDA context while the first phases run, and waits for
   its inputs;
28. serving over a data mesh: ``InferenceSession(mesh=make_mesh(2,
   devices=['cuda:0', 'cuda:0']))`` and the graphed session of an
   ``export_aot`` over 2 data devices (one graph per surface and replica)
   answer encode, decode and reconstruct at 64 as the single-device
   session does, within POSE_TOL and IMAGE_TOL; K1 once per replica per
   decode, graph replays counted; each session's three requests timed once
   more warm, the single-device session's beside them;
29. the decoder's transposed convolutions: each layer of the flagship's
   decoder and the grayscale head on the port's path at 512 images in
   IEEE float32 against ``F.conv_transpose2d`` (forward, dx, dw, 1e-4 of
   the largest entry), each pass's µs by CUDA events beside its floor at
   67 TFLOP/s and beside ``F.conv_transpose2d``'s, the weight-gradient
   kernel K7 (csrc/deconv_wgrad.cu, built in phase 2) launched once for
   the dw of each hidden layer, never for the heads or the first layer (a
   matrix product); K7 alone at deconv.7 (ms, device µs from a CUDA graph,
   its plain version's ms, cuDNN's dw beside its bound, its error against
   float64); then one float32 flagship step at 512 images under the
   profiler: no kernel named TF32, bf16 or fp16. K7's launches are counted
   with K1-K6 on every path above (3 a float32 step of the flagship
   decoder, none in the bf16 recipe or in serving) and go into the
   kernels record with them.

The last lines are a JSON record of the kernels, the card line, and
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; it does so too without a CUDA card.
"""
import atexit
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
# the renders phase: poses also rendered (and timed) by the numpy
# ray-caster, held to the native ones within the JAX package's tolerance
# between its backends; the renders decoded cold and timed
NUMPY_CHECK = 64
RENDER_TOL = 1e-4
COLD_DECODE = 256
# the analysis: poses per trajectory, and its outputs
N_TRAJ = 200
ANALYSIS_DIR = os.path.join(ROOT, "chiprun_out", "smoke_analysis")
# the checkpoint evaluation: shell counts, importance samples, items
EVAL_K = (10, 30)
EVAL_N = 500
EVAL_ITEMS = 4


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
                                 f"K4, K5, K6, K7), expected {want}")
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


# A trace of a graph replay is held to the trace of the same call in the
# ungraphed twin session. The profiler has once come back with 2 device
# events of a replay's 88 (a memcpy and an add), the graph's kernels missing
# from the trace while the session's answers held (NVIDIA H100 80GB HBM3,
# 700.00 W): a trace with under half the twin's events lost the replay and
# is taken again, up to TRACE_ATTEMPTS traces in all; a trace with the
# events and without the kernel fails at once.
TRACE_ATTEMPTS = 3


def _traced_kernels(name, fn, want, floor=None):
    """The device items of one call of ``fn`` under torch.profiler (a trace
    under build/profile/), its trace's figures and the traces taken.
    Returns when an item's name holds ``want``. A trace without it fails
    at once if it holds at least ``floor`` device events; one with fewer
    (any, without ``floor``: a call known to launch the kernel) is printed
    and taken again, up to TRACE_ATTEMPTS traces (each runs ``fn`` twice:
    once before the profiler starts, once under it)."""
    from lie_vae_tpu_torch.profile_serve import profile_request
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        items, prof = profile_request(name, fn, 1, PROFILE_DIR)
        if any(want in k for k in items):
            return items, prof, attempt
        print(f"   {name}: trace {attempt} of {TRACE_ATTEMPTS} holds "
              f"{prof['events']:.0f} device events (at least "
              f"{floor} hold the call) and no {want}: {sorted(items)[:20]}")
        if floor is not None and prof["events"] >= floor:
            raise AssertionError(f"{name}: {prof['events']:.0f} device "
                                 f"events and no {want}: the call ran "
                                 "without its kernel")
    raise AssertionError(f"{name}: the profiler lost the call in "
                         f"{TRACE_ATTEMPTS} traces")


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
    trace of one decode replay (:func:`_traced_kernels`, against the
    ungraphed twin's trace of the same call), with the session's replay
    count up by one a trace and the kernel's launch count not moved; then
    AOT_REPLAYS replays of varied requests and a request held again (a
    stale buffer would show). The second (with ``timed``) timed against
    the ungraphed session: ms per request of 64, in turns (host clock,
    median of 20), and the device's busy share of a request. Each graphed
    session's launches are read around its construction alone
    (:func:`open_aot`), so the twins' launches enter no count. Returns the
    timing session (None without ``timed``), the checks' and timings'
    record, the replays by surface, and the constructions' launches
    summed."""
    from lie_vae_tpu_torch.models import flagship_model
    from lie_vae_tpu_torch.profile_serve import profile_request
    from lie_vae_tpu_torch.serve import (BYTE_SCALE, InferenceSession,
                                         export_aot_from_torch, scale_uint8)
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
            # uint8 is scaled on the card, as numpy scaled it on the host
            if not np.array_equal(
                    gr, aot.reconstruct(x.astype(np.float32) / 255.0)):
                raise AssertionError(f"{what}: the uint8 request's answer "
                                     "differs from its float32 twin's")
            check_images(got, (len(z), 64, 64, 3), f"{what} decode")

        scaled = scale_uint8(
            torch.arange(256, device="cuda").to(torch.uint8),
            torch.from_numpy(BYTE_SCALE).cuda(), torch.empty(256,
                                                             device="cuda"))
        if not np.array_equal(scaled.cpu().numpy(), np.arange(
                256, dtype=np.uint8).astype(np.float32) / 255.0):
            raise AssertionError("the bytes scaled on the card differ from "
                                 "numpy's x / 255")
        ragged = np.concatenate([images, images[:36]])
        poses100 = np.concatenate([poses, poses[:36]])
        held(images, poses, "a request of 64")
        held(ragged, poses100, "a ragged request of 100")
        # the same call ungraphed launches the kernel: its trace's events
        # are what a replay's trace holds when the profiler kept it
        _, twin, _ = _traced_kernels(f"aot_decode_twin_{impl}",
                                     lambda: ref.decode(poses), kernel)
        before, replays = counts()[key], dict(aot.replays)
        items, traced, traces = _traced_kernels(
            f"aot_decode_replay_{impl}", lambda: aot.decode(poses), kernel,
            floor=twin["events"] / 2)
        if counts()[key] != before or aot.replays["decode"] \
                != replays["decode"] + 2 * traces:
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
          f"in the trace of one decode replay: {in_trace} (trace {traces},"
          f" {traced['events']:.0f} device events, the ungraphed call's "
          f"{twin['events']:.0f}; launch count unmoved, replays counted); "
          f"held again after "
          f"{AOT_REPLAYS} "
          f"replays of varied requests; replays {aot.replays}")
    replayed = dict(aot.replays)
    aot.close()
    record = {"capture_s": capture_s, "encode_max_diff": worst["encode"],
              "reconstruct_max_diff": worst["reconstruct"],
              "in_replay_trace": in_trace, "replay_traces": traces,
              "replay_trace_events": [traced["events"], twin["events"]]}
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


def serve_bench_aot(art):
    """``python -m lie_vae_tpu_torch.cli.serve bench --aot art`` in a fresh
    interpreter on the card: its JSON line (the last of its output) must
    give ``device_ms_per_batch`` above 0 for encode and reconstruct.
    Returns the two surfaces' entries."""
    proc = subprocess.run(
        [sys.executable, "-m", "lie_vae_tpu_torch.cli.serve", "bench",
         "--aot", art, "--iters", "5", "--stream_chunks", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"cli.serve bench --aot exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    out = {k: res[k] for k in ("encode", "reconstruct")}
    if not all(v.get("device_ms_per_batch", 0) > 0 for v in out.values()):
        raise AssertionError(f"cli.serve bench --aot printed no device ms: "
                             f"{res}")
    print(f"   cli.serve bench --aot {os.path.relpath(art, ROOT)}: "
          + "; ".join(f"{k} {v['ms_per_batch']} host ms, "
                      f"{v['device_ms_per_batch']} device ms a batch of "
                      f"{res['batch_size']}" for k, v in out.items()))
    return out


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
import json, math, os, sys, time
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from lie_vae_tpu_torch import compat, precision
from lie_vae_tpu_torch.models import LieVAE, flagship_model
from lie_vae_tpu_torch.serve import InferenceSession
from lie_vae_tpu_torch.train import make_optimizer, train_step

ckpt, inputs_path = sys.argv[1:3]
parent = os.getppid()
# the profiler's first use takes seconds: made while the parent builds
with profile(activities=[ProfilerActivity.CUDA]):
    torch.ones(1, device="cuda").sum().item()
# the parent moves the inputs into place when it has them
while not os.path.exists(inputs_path):
    if os.getppid() != parent:
        sys.exit("the parent process is gone")
    time.sleep(0.05)
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


PRECISION_INPUTS = os.path.join(ROOT, "build", "precision_inputs.npz")


def start_precision_child():
    """The fresh interpreter of :func:`precision_subprocess`, started early:
    it imports torch and the port and warms the profiler up (seconds of
    host time, overlapping the builds), then waits for its inputs. Killed
    at exit if the script ends first."""
    if os.path.exists(PRECISION_INPUTS):
        os.remove(PRECISION_INPUTS)
    os.makedirs(os.path.dirname(PRECISION_INPUTS), exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-c", _PRECISION_SCRIPT, CHECKPOINT,
         PRECISION_INPUTS], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def precision_subprocess(proc, batch, cpu_session, exact_loss):
    """In the fresh interpreter ``proc`` (:func:`start_precision_child`;
    torch's default settings): a flagship
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
    tmp = PRECISION_INPUTS + ".tmp.npz"
    np.savez(tmp, batch=batch, poses=poses,
             cpu_decode=cpu_session.decode(poses), exact_loss=exact_loss)
    os.replace(tmp, PRECISION_INPUTS)     # whole, as the child polls
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    if proc.returncode:
        raise AssertionError(f"the fresh interpreter failed: "
                             f"{err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
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


# the toy drivers: degrees swept, epochs, outputs
SWEEP_DEGREES = (3, 10, 16)
SWEEP_EPOCHS = 3
SWEEP_DIR = os.path.join(ROOT, "chiprun_out", "smoke_sweep")
TOY_ANALYSIS_DIR = os.path.join(ROOT, "chiprun_out", "smoke_toy_analysis")
# data-parallel training: steps of the 2 x 1 mesh, of the 1 x 2 mesh and
# of the one NCCL rank; the children's time limit once their inputs are
# there, and the longest a rank started early waits for them; their inputs
DP_STEPS = 5
DP_SHORT_STEPS = 3
DP_TIMEOUT_S = 240
DP_WAIT_S = 900
DP_DIR = os.path.join(ROOT, "build", "smoke_dp")
# the CLI over the mesh 2 x 2: 320 of the renders (192 to train on, one
# epoch of 3 steps at 64), the IW-LL of 2 items at n = 4
DP_CLI_DIR = os.path.join(ROOT, "chiprun_out", "smoke_dp_cli")
DP_CLI_ARGV = ["--dataset", "spherecube", "--data_dir", DATA_DIR,
               "--subsample", "0.3125", "--epochs", "1", "--sigma_clamp",
               "auto", "--torch_checkpoint", CHECKPOINT, "--ll_samples",
               "4", "--ll_max_items", "2"]
DP_CLI_STEPS = 3


def reset(counters):
    for obj, attr in counters:
        setattr(obj, attr, 0)


def chain_check(L, angles, spectrum, dout):
    """K1, and K2 forward with residuals and backward, through the chain's
    autograd Function on ``angles`` (B, 3) and a shared ``spectrum``,
    against the plain chain and its autograd: (|K1 - plain| of max(1,
    max|x|), the worst gradient error of max(1, max|ref|))."""
    from lie_vae_tpu_torch.ops.kernels import wigner_fused
    from lie_vae_tpu_torch.ops.wigner import block_wigner_apply_zjz
    with torch.no_grad():
        k1 = wigner_fused.block_wigner_matrix_multiply_fused(angles, spectrum,
                                                             L)
    res = []
    for fn in (wigner_fused.block_wigner_matrix_multiply_fused,
               block_wigner_apply_zjz):
        a = angles.clone().requires_grad_()
        xx = spectrum.clone().requires_grad_()
        out = fn(a, xx, L)
        res.append((out.detach(),) + torch.autograd.grad(out, (a, xx), dout))
    (o1, da1, dx1), (o2, da2, dx2) = res
    scale = max(1.0, spectrum.abs().max().item())
    torch.cuda.synchronize()
    return (max((k1 - o2).abs().max().item(), (o1 - o2).abs().max().item())
            / scale, max(max_rel(da1, da2)[1], max_rel(dx1, dx2)[1]))


def toy_sweep_phase(counters, counts):
    """run_degree_sweep at SWEEP_DEGREES, analyze_toy --configs all
    ('fused') and its six defaults with 'pallas'; the kernels at the swept
    degrees and the toy shape held against their plain versions; device us
    of K1, K2, K5, K6 at B = 64, C = 4 for L = 10 and 16."""
    from lie_vae_tpu_torch.cli import analyze_toy, run_degree_sweep
    from lie_vae_tpu_torch.data import ToyDataset
    from lie_vae_tpu_torch.ops import quaternions_to_eazyz
    from lie_vae_tpu_torch.ops.kernels import wigner_block, wigner_fused
    from lie_vae_tpu_torch.profile_serve import device_us
    out = {}
    t0 = phase(f"the degree sweep: python -m lie_vae_tpu_torch.cli."
               f"run_degree_sweep --degrees "
               f"{' '.join(map(str, SWEEP_DEGREES))} --epochs {SWEEP_EPOCHS} "
               "(n = 1024, 4 copies, 'fused')")
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    reset(counters)
    ts = time.perf_counter()
    res = run_degree_sweep.main(
        ["--degrees", *map(str, SWEEP_DEGREES), "--epochs", str(SWEEP_EPOCHS),
         "--out_dir", SWEEP_DIR])
    out["sweep_s"] = time.perf_counter() - ts
    out["sweep_launches"] = counts()
    table = open(os.path.join(SWEEP_DIR, "TOY_RESULTS.md")).read()
    for L in SWEEP_DEGREES:
        r = res[("ae-action-s2s2", L)]
        vals = [r["test_recon"]] + [r[f"discontinuity_{t}"][k]
                                    for t in ("circle", "random_walk")
                                    for k in ("mean", "max")]
        if not (np.isfinite(vals).all() and f"| L={L} (" in table):
            raise AssertionError(f"the sweep at L = {L}: {r}")
        print(f"   L={L:2d}: test recon {r['test_recon']:.3f}, pose "
              f"coverage {r['pose_err_deg']['frac_within_10deg']:.3f} "
              f"within 10 deg, {r['pose_err_deg']['frac_near_flip']:.3f} "
              f"at a flip, {r['train_s']} s")
    got = out["sweep_launches"]
    if not all(got[k] for k in ("launches", "launches_residuals",
                                "launches_backward")) \
            or got["block_launches"]:
        raise AssertionError(f"the sweep's launches: {got}")
    print(f"   launches in the path: {got}; {out['sweep_s']:.2f} s; the "
          "table merged into chiprun_out/smoke_sweep/TOY_RESULTS.md")
    gen = torch.Generator().manual_seed(11)
    worst = [0.0, 0.0]
    for L in SWEEP_DEGREES:
        # the phase's inputs: its toy set (K1 on the card, the plain chain
        # on the CPU) and K2 on its first 64 poses and spectrum
        card = ToyDataset.generate(n=1024, degrees=L, rep_copies=4)
        plain = ToyDataset.generate(n=1024, degrees=L, rep_copies=4,
                                    device="cpu")
        err_x = float(np.abs(card.x - plain.x).max()) / max(
            1.0, float(np.abs(plain.x).max()))
        angles = quaternions_to_eazyz(torch.as_tensor(
            card.quaternions[:64], device="cuda")).contiguous()
        spectrum = torch.as_tensor(card.harmonics, device="cuda")
        dout = torch.randn(((64,) + tuple(card.x.shape[1:])),
                           generator=gen).cuda()
        e_out, e_grad = chain_check(L, angles, spectrum, dout)
        if not (err_x <= KERNEL_TOL and e_out <= KERNEL_TOL
                and e_grad <= GRAD_TOL):
            raise AssertionError(f"the chain kernels at L = {L}: toy set "
                                 f"{err_x:.3e}, K1/K2 {e_out:.3e}, "
                                 f"gradients {e_grad:.3e}")
        worst = [max(worst[0], err_x, e_out), max(worst[1], e_grad)]
        print(f"   L={L:2d}: the toy set by K1 vs the plain chain "
              f"{err_x:.3e}, K1/K2 on its first 64 poses {e_out:.3e} of "
              f"max(1, max|x|), gradients {e_grad:.3e} (tol {KERNEL_TOL}, "
              f"{GRAD_TOL})")
    out["sweep_kernel_err"] = worst
    tim = {}
    for L in (10, 16):
        S = (L + 1) ** 2
        angles = group_matrix_to_eazyz_cuda(64, gen)
        spectrum = torch.randn((S, 4), generator=gen).cuda()
        dout = torch.randn((64, S, 4), generator=gen).cuda()
        _, y, z = wigner_fused._launch_residuals(angles, spectrum, L)
        tim[L] = {
            "wigner_chain_fwd": (device_us(lambda: wigner_fused._launch(
                angles, spectrum, L)), chain_bound(64, L, 4, True)),
            "wigner_chain_fwd_res": (device_us(
                lambda: wigner_fused._launch_residuals(angles, spectrum, L)),
                chain_res_bound(64, L, 4, True)),
            "wigner_chain_bwd": (device_us(
                lambda: wigner_fused._launch_backward(
                    angles, spectrum, y, z, dout, L, True)),
                chain_bwd_bound(64, L, 4, True)),
            "wigner_block_fwd": (device_us(lambda: wigner_block._launch(
                angles, spectrum, L, False)),
                block_bound(64, L, 4, True, False)),
            "wigner_block_bwd": (device_us(
                lambda: wigner_block._launch_backward(
                    angles, spectrum, dout, L, False, True)),
                block_bound(64, L, 4, True, True))}
        print(f"   L={L}, B=64, C=4, shared: device us (bound us): "
              + "; ".join(f"{k} {v[0]:.2f} ({1e3 * v[1][0]:.3f} {v[1][1]})"
                          for k, v in tim[L].items()))
    out["toy_shape_device_us"] = {
        L: {k: {"device_us": v[0], "bound_us": 1e3 * v[1][0],
                "bound_by": v[1][1]} for k, v in t.items()}
        for L, t in tim.items()}
    done(t0)

    for impl, configs in (("fused", ["all"]),
                          ("pallas", analyze_toy.DEFAULT_CONFIGS)):
        t0 = phase(f"the toy matrix: python -m lie_vae_tpu_torch.cli."
                   f"analyze_toy --configs {' '.join(configs)} --epochs 1 "
                   f"--kernel_impl {impl}")
        out_dir = os.path.join(TOY_ANALYSIS_DIR, impl)
        shutil.rmtree(out_dir, ignore_errors=True)
        reset(counters)
        ts = time.perf_counter()
        res = analyze_toy.main(["--configs", *configs, "--epochs", "1",
                                "--kernel_impl", impl, "--out_dir", out_dir])
        secs = time.perf_counter() - ts
        got = counts()
        want = (("launches", "launches_residuals", "launches_backward",
                 "density_launches", "density_launches_backward")
                if impl == "fused" else
                ("block_launches", "block_launches_backward",
                 "density_launches", "density_launches_backward"))
        zero = (("block_launches",) if impl == "fused"
                else ("launches_residuals", "launches_backward"))
        if not all(got[k] for k in want) or any(got[k] for k in zero):
            raise AssertionError(f"analyze_toy ({impl}): launches {got}")
        for name, r in res.items():
            vals = [r["test_recon"]] + [r[f"discontinuity_{t}"][k]
                                        for t in ("circle", "random_walk")
                                        for k in ("mean", "max")]
            if not np.isfinite(vals).all():
                raise AssertionError(f"analyze_toy {name}: {r}")
        with np.load(os.path.join(out_dir, "arrays.npz")) as z:
            if not all(np.isfinite(z[k]).all() for k in z.files):
                raise AssertionError(f"analyze_toy ({impl}): arrays")
        print(f"   {len(res)} configs, every result finite; launches in the "
              f"path: {got}; {secs:.2f} s")
        out[f"toy_matrix_{impl}"] = {"configs": len(res), "s": secs,
                                     "launches": got}
        if impl == "pallas":
            gen5 = torch.Generator().manual_seed(12)
            angles = group_matrix_to_eazyz_cuda(64, gen5)
            x = torch.randn((16, 4), generator=gen5).cuda()
            dout = torch.randn((64, 16, 4), generator=gen5).cuda()
            e5, tol5, _, r6 = check_block(3, angles, x, dout, False)
            if not (e5 <= tol5 and r6 <= GRAD_TOL):
                raise AssertionError(f"K5/K6 at the toy shape: {e5:.3e}, "
                                     f"{r6:.3e}")
            print(f"   K5/K6 at the toy shape (L = 3, C = 4, B = 64) vs the "
                  f"plain version: {e5:.3e} (tol {tol5:.1e}), gradients "
                  f"{r6:.3e}")
        done(t0)
    return out


def group_matrix_to_eazyz_cuda(b, gen):
    from lie_vae_tpu_torch.ops import (group_matrix_to_eazyz,
                                       random_group_matrices)
    return group_matrix_to_eazyz(random_group_matrices(
        b, gen, device="cpu").cuda()).contiguous()


def rank_after(argv):
    """``chip_smoke.py --rank-after GO OUT -m MODULE ARGS...``: one rank of
    a launch that the script starts before its inputs exist. It imports
    torch and the port's training modules and makes its CUDA context while
    the script's first phases run, waits for the file GO (and ends if the script that
    started it has ended, or after DP_WAIT_S), runs MODULE as ``python -m
    MODULE ARGS`` does, and writes the kernels' launches in that run to
    ``OUT/launches_rank<RANK>.json``."""
    import runpy
    import lie_vae_tpu_torch.cli  # noqa: F401
    import lie_vae_tpu_torch.parallel  # noqa: F401
    import lie_vae_tpu_torch.train  # noqa: F401
    from lie_vae_tpu_torch.ops.kernels import kernel_counts
    go, out, flag, module, args = argv[0], argv[1], argv[2], argv[3], argv[4:]
    assert flag == "-m", argv
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")
    parent = int(os.environ["SMOKE_PID"])
    deadline = time.monotonic() + DP_WAIT_S
    while not os.path.exists(go):
        try:
            os.kill(parent, 0)
        except ProcessLookupError:
            sys.exit("the script that started this rank has ended")
        if time.monotonic() > deadline:
            sys.exit(f"no {go} after {DP_WAIT_S} s")
        time.sleep(0.05)
    before = kernel_counts()
    sys.argv = [module] + args
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    after = kernel_counts()
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"launches_rank{os.environ['RANK']}.json"),
              "w") as f:
        json.dump({k: after[k] - before[k] for k in after}, f)


class Launch:
    """``n`` ranks of ``python -m MODULE ARGS`` under torch.distributed.run,
    started early (:func:`rank_after`) in a child process group of their
    own, which is killed at exit if it is still there. :meth:`finish`
    hands them their inputs and waits DP_TIMEOUT_S at most: a rank that
    fails or runs out of time fails the phase."""

    def __init__(self, name, n, module, args, cwd=ROOT):
        self.name, self.n = name, n
        self.go = os.path.join(DP_DIR, f"{name}.go")
        self.out = os.path.join(DP_DIR, name)
        self.log_path = os.path.join(DP_DIR, f"{name}.log")
        os.makedirs(cwd, exist_ok=True)
        env = dict(os.environ, OMP_NUM_THREADS="2", SMOKE_PID=str(os.getpid()),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                                  ""))
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node", str(n),
                 os.path.abspath(__file__), "--rank-after", self.go,
                 self.out, "-m", module, *args],
                cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)
        atexit.register(self.stop)

    def stop(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, 9)
            self.proc.wait()

    def finish(self):
        """Go, and wait: returns the log and each rank's launches."""
        tl = time.perf_counter()
        open(self.go, "w").close()
        try:
            rc = self.proc.wait(timeout=DP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.stop()
            rc = "a timeout"
        self.seconds = time.perf_counter() - tl
        with open(self.log_path) as f:
            text = f.read()
        if rc != 0:
            raise AssertionError(f"the {self.n}-rank launch {self.name} "
                                 f"ended with {rc}:\n{text[-6000:]}")
        launches = []
        for r in range(self.n):
            with open(os.path.join(self.out, f"launches_rank{r}.json")) as f:
                launches.append(json.load(f))
        return text, launches

    def ranks(self, spec):
        """Each rank's results of ``parallel.run_steps``'s spec-th spec."""
        return [dict(np.load(os.path.join(self.out, f"rank{r}_{spec}.npz")))
                for r in range(self.n)]


def start_dp_launches():
    """The launches of the data-parallel phase, started after the builds:
    2 ranks over gloo (``run_steps`` of the meshes 2 x 1 and 1 x 2), one
    rank over NCCL, and the CLI over the mesh 2 x 2 (4 ranks, gloo)."""
    shutil.rmtree(DP_DIR, ignore_errors=True)
    shutil.rmtree(DP_CLI_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    steps = "lie_vae_tpu_torch.parallel.run_steps"
    spec = lambda name: os.path.join(DP_DIR, f"{name}.npz")  # noqa: E731
    return {
        "gloo2": Launch("gloo2", 2, steps, [spec("2x1_gloo"),
                                            spec("1x2_gloo"),
                                            os.path.join(DP_DIR, "gloo2")]),
        "nccl1": Launch("nccl1", 1, steps, [spec("1_nccl"),
                                            os.path.join(DP_DIR, "nccl1")]),
        "cli4": Launch("cli4", 4, "lie_vae_tpu_torch.cli.main",
                       DP_CLI_ARGV + [
                           "--mesh_data", "2", "--mesh_model", "2",
                           "--save_dir", os.path.join(DP_CLI_DIR, "mesh")],
                       cwd=os.path.join(DP_CLI_DIR, "mesh"))}


def _median_ms(ms):
    """The median host ms of the steps after the first."""
    return float(np.median(ms[1:] if len(ms) > 1 else ms))


def _state_of(out, impl, step):
    head = f"{impl}/state{step}/"
    return {k[len(head):]: v for k, v in out.items() if k.startswith(head)}


def hold_dp(got, card, cpu, exact, impl, steps, what):
    """Each step of a rank (``got``) against the single-process card step
    (``card``): the loss within LOSS_TOL of the exact one's, each parameter
    within PARAM_TOL and each BatchNorm statistic within STATS_TOL of its
    largest value, each plus ARBITER times the CPU's own float32 error
    against the exact float64 step at that step (C3). Returns the worst
    share of the allowance."""
    worst = 0.0
    for i in range(steps):
        l_g, l_c = (float(r[f"{impl}/loss"][i]) for r in (got, card))
        l_32, l_64 = (float(r["fused/loss"][i]) for r in (cpu, exact))
        allow = LOSS_TOL * abs(l_64) + ARBITER * abs(l_32 - l_64)
        worst = max(worst, abs(l_g - l_c) / allow)
        s_g, s_c = _state_of(got, impl, i), _state_of(card, impl, i)
        s_32, s_64 = _state_of(cpu, "fused", i), _state_of(exact, "fused", i)
        for k, ref in s_c.items():
            if k.endswith("num_batches_tracked"):
                if int(s_g[k]) != int(ref):
                    raise AssertionError(f"{what}, step {i}: {k}")
                continue
            own = float(np.abs(s_32[k].astype(np.float64) - s_64[k]).max())
            tol = (STATS_TOL * float(np.abs(s_64[k]).max())
                   if "running_" in k else PARAM_TOL)
            share = float(np.abs(s_g[k] - ref).max()) / (tol + ARBITER * own)
            if not share <= 1.0:
                raise AssertionError(
                    f"{what}, step {i}: {k} {np.abs(s_g[k] - ref).max():.3e} "
                    f"from the single-process card step, beyond "
                    f"{tol:.3e} + {ARBITER} x the CPU's float32 error "
                    f"{own:.3e}")
            worst = max(worst, share)
        if not abs(l_g - l_c) <= allow:
            raise AssertionError(f"{what}, step {i}: loss {l_g} vs {l_c}")
    return worst


def _cli_tensors(path):
    """A CLI checkpoint's tensors by kind (``model``, ``mu``, ``nu``), and
    the whole of it."""
    from lie_vae_tpu_torch.train.checkpoint import load_checkpoint
    ckpt = load_checkpoint(path)
    opt = ckpt["optimizer"]
    return {"model": {k: v.double() for k, v in ckpt["model"].items()
                      if not k.endswith("num_batches_tracked")},
            "mu": dict(enumerate(t.double() for t in opt["mu"])),
            "nu": dict(enumerate(t.double() for t in opt["nu"]))}, ckpt


def hold_cli(dirs):
    """The CLI's checkpoint and IW-LL over the mesh (``dirs["mesh"]``)
    against the exact single-process CLI (the CPU in float64): each tensor
    of the model and of Adam's mu and nu within PARAM_TOL of its scale,
    plus ARBITER times the farther of the two single-process float32 runs
    (the card's, the CPU's) from the exact one (C3); a parameter's or
    statistic's scale is its exact tensor's largest magnitude, a moment's
    the largest magnitude of that moment over all parameters. The IW-LL in
    ``ll.txt`` within LOSS_TOL of the exact one's plus the same ARBITER
    term, the step, Adam's count and BatchNorm's counts the same. Returns
    the worst share of the allowance."""
    from lie_vae_tpu_torch.cli import main as cli_main
    runs = {k: _cli_tensors(os.path.join(d, cli_main.CHECKPOINT))
            for k, d in dirs.items()}
    worst = 0.0
    for kind in ("model", "mu", "nu"):
        got, exact = runs["mesh"][0][kind], runs["cpu64"][0][kind]
        if got.keys() != exact.keys():
            raise AssertionError(f"the mesh CLI's checkpoint: {kind} keys")
        top = max(t.abs().max().item() for t in exact.values())
        for k, want in exact.items():
            scale = want.abs().max().item() if kind == "model" else top
            own = max((runs[t][0][kind][k] - want).abs().max().item()
                      for t in ("card", "cpu32"))
            err = (got[k] - want).abs().max().item()
            share = err / (PARAM_TOL * scale + ARBITER * own)
            if not share <= 1.0:
                raise AssertionError(
                    f"the mesh CLI's {kind} {k}: {err:.3e} from the exact "
                    f"run, beyond {PARAM_TOL} x {scale:.3e} + {ARBITER} x "
                    f"{own:.3e}")
            worst = max(worst, share)
    ckpt, single = runs["mesh"][1], runs["card"][1]
    counts = [(c["step"], c["optimizer"]["count"], {
        k: int(v) for k, v in c["model"].items()
        if k.endswith("num_batches_tracked")}) for c in (ckpt, single)]
    if counts[0] != counts[1] or ckpt["step"] != DP_CLI_STEPS:
        raise AssertionError(f"the mesh CLI's counts {counts}")
    ll = {}
    for k, d in dirs.items():
        with open(os.path.join(d, "ll.txt")) as f:
            lines = f.read().splitlines()
        if len(lines) != 1:
            raise AssertionError(f"{k}: ll.txt {lines}")
        ll[k] = float(lines[0].split(":")[1])
    own = max(abs(ll[t] - ll["cpu64"]) for t in ("card", "cpu32"))
    allow = LOSS_TOL * abs(ll["cpu64"]) + ARBITER * own
    if not abs(ll["mesh"] - ll["cpu64"]) <= allow:
        raise AssertionError(f"the mesh CLI's IW-LL {ll}")
    return max(worst, abs(ll["mesh"] - ll["cpu64"]) / allow), ll


def dp_train_phase(weights, batch, counters, launches):
    """The flagship from the converged weights over process meshes on the
    one card, each rank a child process started after the builds: 2 x 1
    over gloo ('fused' and 'pallas') and 1 x 2 in one launch of 2 ranks, 1
    rank over NCCL; every rank's loss, parameters and statistics after
    every step held against the single-process card step on the same 64
    rows and noise. Then the CLI over the mesh 2 x 2 (4 ranks), its
    checkpoint and IW-LL against the single-process CLI's."""
    from lie_vae_tpu_torch.cli import main as cli_main
    from lie_vae_tpu_torch.models import flagship_model
    from lie_vae_tpu_torch.parallel import run_steps
    from lie_vae_tpu_torch.ops.kernels import KERNEL_COUNTERS
    t0 = phase(f"data-parallel training: the flagship from the converged "
               f"weights, a global batch of 64 renders; 2 ranks x 32 on the "
               f"card over gloo ({DP_STEPS} steps, 'fused' and 'pallas'), "
               f"the mesh 1 x 2 ({DP_SHORT_STEPS} steps) and one rank over "
               "NCCL, each against the single-process card step; then "
               "python -m lie_vae_tpu_torch.cli.main --mesh_data 2 "
               "--mesh_model 2 against the single-process CLI")
    cfg = {k: v for k, v in flagship_model(
        "cpu", sigma_clamp=SIGMA_CLAMP).config.items()
        if k not in ("kernel_impl", "fixed_item_rep")}
    spec = dict(model=cfg, dtype="float32", device="cuda", batch_size=64,
                seed=0, lr=1e-3, clip_grads=1e-5, beta=1.0, steps=DP_STEPS,
                timeout_s=120, kernel_impls=["fused", "pallas"])
    arrays = {f"w/{k}": v.numpy() for k, v in weights.items()}
    arrays.update(train_x=np.asarray(batch), test_x=np.asarray(batch[:2]))
    runs = (("2x1_gloo", "gloo2", 0, [2, 1], DP_STEPS, ["fused", "pallas"]),
            ("1x2_gloo", "gloo2", 1, [1, 2], DP_SHORT_STEPS, ["fused"]),
            ("1_nccl", "nccl1", 0, [1, 1], DP_SHORT_STEPS, ["fused"]))
    for name, _, _, mesh, steps, impls in runs:
        run_steps.write_spec(os.path.join(DP_DIR, f"{name}.npz"),
                             dict(spec, mesh=mesh, steps=steps,
                                  kernel_impls=impls), arrays)
    tr = time.perf_counter()
    card = run_steps.run(spec, arrays, device="cuda")
    cpu = run_steps.run(dict(spec, kernel_impls=["fused"]), arrays,
                        device="cpu")
    exact = run_steps.run(dict(spec, dtype="float64",
                               kernel_impls=["fused"]), arrays, device="cpu")
    print(f"   the single-process twins: card ('fused' "
          f"{_median_ms(card['fused/step_ms']):.2f}, 'pallas' "
          f"{_median_ms(card['pallas/step_ms']):.2f} host ms a step), CPU "
          f"float32 and float64; {time.perf_counter() - tr:.2f} s")
    out, logs = {}, {}
    for launch in ("gloo2", "nccl1"):
        reset(counters)
        logs[launch] = launches[launch].finish()[0]
    for name, launch, index, mesh, steps, impls in runs:
        ranks, log, n = (launches[launch].ranks(index), logs[launch],
                         launches[launch].n)
        backends = sorted(set(re.findall(r"backend (\w+) on (cuda:\d)",
                                         log)))
        want = {"gloo" if "gloo" in name else "nccl"}
        if {b for b, _ in backends} != want:
            raise AssertionError(f"{name}: backends {backends}")
        for impl in impls:
            worst = max(hold_dp(r, card, cpu, exact, impl, steps,
                                f"{name} rank {i} {impl}")
                        for i, r in enumerate(ranks))
            ms = [_median_ms(r[f"{impl}/step_ms"]) for r in ranks]
            counted = [dict(zip(KERNEL_COUNTERS,
                                r[f"{impl}/launches"].tolist()))
                       for r in ranks]
            want_k = (("launches_residuals", "launches_backward",
                       "density_launches", "density_launches_backward")
                      if impl == "fused" else
                      ("block_launches", "block_launches_backward",
                       "density_launches", "density_launches_backward"))
            for lr in counted:
                if any(lr[k] != steps for k in want_k):
                    raise AssertionError(f"{name} {impl}: launches {lr}")
            out[f"{name}_{impl}"] = {
                "backend": backends[0][0], "ranks": n, "mesh": mesh,
                "steps": steps, "host_ms_per_step": ms,
                "card_host_ms_per_step": _median_ms(card[f"{impl}/step_ms"]),
                "worst_share": worst, "launches_per_rank": counted,
                "launch_s": launches[launch].seconds}
            print(f"   {name} ({backends[0][0]}, {n} rank(s), mesh "
                  f"{mesh[0]}x{mesh[1]}) {impl}: {steps} steps, every rank "
                  f"within {worst:.3f} of the allowance; host ms a step per "
                  f"rank {', '.join(f'{m:.2f}' for m in ms)} (one process "
                  f"{out[f'{name}_{impl}']['card_host_ms_per_step']:.2f}); "
                  f"launches per rank {counted[0]}; the launch from its "
                  f"inputs to its end {launches[launch].seconds:.1f} s")

    # the CLI: one process on the card, and on the CPU in float32 and in
    # float64 (the exact run: torch's default dtype float64, the weights
    # from the same file, the noise drawn in float32 as ever)
    tc = time.perf_counter()
    dirs = {k: os.path.join(DP_CLI_DIR, k)
            for k in ("mesh", "card", "cpu32", "cpu64")}
    for name, device, dtype in (("card", "cuda", torch.float32),
                                ("cpu32", "cpu", torch.float32),
                                ("cpu64", "cpu", torch.float64)):
        os.makedirs(dirs[name])
        os.chdir(dirs[name])
        torch.set_default_dtype(dtype)
        try:
            cli_main.main(DP_CLI_ARGV + ["--device", device,
                                         "--save_dir", dirs[name]])
        finally:
            torch.set_default_dtype(torch.float32)
            os.chdir(ROOT)
    single_s = time.perf_counter() - tc
    log, cli_launches = launches["cli4"].finish()
    backends = sorted(set(re.findall(r"backend (\w+) on (cuda:\d)", log)))
    if backends != [("gloo", "cuda:0")] or log.count(
            f"Epoch 0 it {DP_CLI_STEPS} train recon") != 1:
        raise AssertionError(f"the mesh CLI: backends {backends}, or not "
                             f"one epoch line from rank 0:\n{log[-3000:]}")
    for lr in cli_launches:
        if any(lr[k] != DP_CLI_STEPS for k in (
                "launches_residuals", "launches_backward",
                "density_launches_backward")) or not (
                lr["launches"] and lr["density_launches"]) or any(
                lr[k] for k in ("block_launches", "block_launches_backward")):
            raise AssertionError(f"the mesh CLI's launches {cli_launches}")
    worst, ll = hold_cli(dirs)
    out["cli_2x2_gloo"] = {
        "backend": "gloo", "ranks": 4, "mesh": [2, 2], "steps": DP_CLI_STEPS,
        "worst_share": worst, "ll": ll, "launches_per_rank": cli_launches,
        "launch_s": launches["cli4"].seconds, "single_process_s": single_s}
    print(f"   the CLI over the mesh 2 x 2 (gloo, 4 ranks, {DP_CLI_STEPS} "
          f"steps, test() and the IW-LL): its checkpoint and IW-LL within "
          f"{worst:.3f} of the allowance against the exact single-process "
          f"CLI (IW-LL {ll}); launches per rank {cli_launches[0]}; the "
          f"launch from its inputs to its end "
          f"{launches['cli4'].seconds:.1f} s; the three single-process CLI "
          f"runs {single_s:.1f} s")
    done(t0)
    return out


def dp_serve_phase(weights, images, counters, counts):
    """The flagship served over a 2-device mesh on the one card (two
    replicas), eager and graphed (an export_aot over 2 data devices),
    against the single-device session."""
    from lie_vae_tpu_torch.models import flagship_model
    from lie_vae_tpu_torch.parallel import make_mesh
    from lie_vae_tpu_torch.serve import (AotSession, InferenceSession,
                                         export_aot_from_torch)
    t0 = phase("serving over a data mesh: InferenceSession(mesh=make_mesh(2, "
               "devices=['cuda:0', 'cuda:0'])) and the graphed session of an "
               "export_aot over 2 data devices, encode/decode/reconstruct at "
               "64, against the single-device session")
    devices = ["cuda:0", "cuda:0"]
    mesh = make_mesh(2, devices=devices)

    def answers(sess):
        enc = sess.encode(images)
        return enc, sess.decode(enc["pose"]), sess.reconstruct(images)

    def timed(sess):
        """Host ms of the three requests once more, the session warm."""
        torch.cuda.synchronize()
        tq = time.perf_counter()
        answers(sess)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - tq)

    single = InferenceSession(flagship_model("cuda"), weights,
                              batch_size=64, seed=0)
    want = answers(single)
    single_ms = timed(single)
    art = os.path.join(DP_DIR, "mesh_aot.npz")
    os.makedirs(DP_DIR, exist_ok=True)
    export_aot_from_torch(CHECKPOINT, flagship_model("cpu"), art,
                          batch_size=64, mesh=mesh)
    out = {}
    for name, make in (
            ("eager", lambda: InferenceSession(
                flagship_model("cuda"), weights, batch_size=64, seed=0,
                mesh=mesh)),
            ("graphed", lambda: AotSession(art, seed=0, devices=devices))):
        sess = make()
        reset(counters)
        tq = time.perf_counter()
        got = answers(sess)
        torch.cuda.synchronize()
        secs = time.perf_counter() - tq
        launches = counts()
        d_pose = max(np.abs(got[0][k] - want[0][k]).max()
                     for k in ("pose", "sigma", "sample"))
        d_img = max(np.abs(got[1] - want[1]).max(),
                    np.abs(got[2] - want[2]).max())
        if not (d_pose <= POSE_TOL and d_img <= IMAGE_TOL):
            raise AssertionError(f"the {name} mesh session: poses "
                                 f"{d_pose:.3e}, images {d_img:.3e}")
        if name == "eager" and launches["launches"] != 4:
            raise AssertionError(f"the eager mesh session's launches "
                                 f"{launches} (K1: one per replica per "
                                 "decode)")
        if name == "graphed" and (sess.replays["decode"] != 2
                                  or launches["launches"] != 0):
            raise AssertionError(f"the graphed mesh session: replays "
                                 f"{sess.replays}, launches {launches}")
        out[name] = {"max_diff_pose": float(d_pose),
                     "max_diff_image": float(d_img), "s": secs,
                     "launches": launches,
                     "replays": dict(getattr(sess, "replays", {})),
                     "warm_ms": timed(sess), "single_device_warm_ms":
                     single_ms}
        print(f"   {name}: poses within {d_pose:.3e}, images within "
              f"{d_img:.3e} of the single-device session; launches "
              f"{launches}; replays {out[name]['replays']}; "
              f"{1e3 * secs:.1f} ms for the three requests, "
              f"{out[name]['warm_ms']:.1f} ms once more (the single-device "
              f"session {single_ms:.1f} ms)")
        if name == "graphed":
            sess.close()
    done(t0)
    return out


DECONV_LAYERS = {  # name: (C_in, C_out, H_in, stride, padding)
    "deconv.1": (490, 200, 1, 1, 0), "deconv.3": (200, 200, 4, 2, 1),
    "deconv.5": (200, 200, 8, 2, 1), "deconv.7": (200, 200, 16, 2, 1),
    "deconv.9": (200, 3, 32, 2, 1), "head1": (200, 1, 32, 2, 1)}
LOW_PRECISION = re.compile(r"tf32|bf16|f16", re.I)


def deconv_phase(weights):
    """Phase 29: each decoder layer's path (``nets.ConvTranspose2d``) at 512
    images in IEEE float32 against ``F.conv_transpose2d`` (forward, dx, dw;
    1e-4 of the largest entry), each pass's µs (CUDA events) beside its
    floor at 67 TFLOP/s, the kernel's launches; K7 alone at deconv.7
    (ms by CUDA events, device µs from a CUDA graph, its plain version's
    ms, its largest error against float64); then one float32 flagship
    step at 512 images under the profiler, whose trace must hold the
    kernel (else it lost events) and no TF32, bf16 or fp16 kernel.
    Returns (the layers' rows, K7's numbers)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from lie_vae_tpu_torch.models import flagship_model, nets
    from lie_vae_tpu_torch.ops.kernels.deconv_wgrad import (
        deconv_wgrad, deconv_wgrad_plain, supports)
    from lie_vae_tpu_torch.precision import ieee_float32
    from lie_vae_tpu_torch.profile_serve import device_us
    from lie_vae_tpu_torch.profile_train import passes
    from lie_vae_tpu_torch.train import make_optimizer, train_step
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    with ieee_float32():
        for name, (c_in, c_out, h, stride, pad) in DECONV_LAYERS.items():
            layer = nets.ConvTranspose2d(c_in, c_out, 4, stride, pad).cuda()
            x = torch.randn((512, c_in, h, h), device="cuda", generator=gen)
            w, b = layer.weight.detach(), layer.bias.detach()
            flops = 2.0 * c_in * c_out * 16 * h * h * 512
            row = {"floor_us": 1e6 * flops / FP32_FLOP_PER_S}
            for route, fn in (
                    ("port", lambda x, w, b: torch.func.functional_call(
                        layer, {"weight": w, "bias": b}, (x,))),
                    ("conv_transpose2d", lambda x, w, b: F.conv_transpose2d(
                        x, w, b, stride, pad))):
                torch.manual_seed(0)
                calls = passes(fn, x, w, b)
                before = deconv_wgrad.launches
                outs = {p: c() for p, c in calls.items()}
                row[route + "_launches"] = deconv_wgrad.launches - before
                row[route] = {p: 1e3 * cuda_ms(c, trials=3, per_trial=3)
                              for p, c in calls.items()}
                if route == "port":
                    got = outs
            row["gap"] = {p: float((got[p] - outs[p]).abs().max()
                                   / outs[p].abs().max()) for p in outs}
            was = row["conv_transpose2d"]
            print(f"   {name}: " + ", ".join(
                f"{p} {row['port'][p]:.1f} us (was {was[p]:.1f}, gap "
                f"{row['gap'][p]:.1e})" for p in outs)
                + f"; floor {row['floor_us']:.1f} us a pass; kernel "
                f"launches {row['port_launches']}")
            if max(row["gap"].values()) > 1e-4:
                raise AssertionError(f"{name}: the port's transposed conv "
                                     f"against F.conv_transpose2d: {row}")
            want = int(stride == 2 and supports(c_out, h))
            if row["port_launches"] != want:
                raise AssertionError(f"{name}: {row['port_launches']} "
                                     f"kernel launches, expected {want}")
            rows[name] = row
            if name == "deconv.7":
                dy = torch.randn((512, c_out, 2 * h, 2 * h), device="cuda",
                                 generator=gen)
                exact = torch.ops.aten.convolution_backward(
                    dy.double(), x.double(), w.double(), None, [2, 2],
                    [1, 1], [1, 1], True, [0, 0], 1,
                    [False, True, False])[1]
                err = float((deconv_wgrad(x, dy).double() - exact)
                            .abs().max())
                k7 = {"shape": "deconv.7: B=512, C_in=C_out=200, 16x16 "
                               "-> 32x32",
                      "ms": cuda_ms(lambda: deconv_wgrad(x, dy), trials=3,
                                    per_trial=3),
                      "device_us": device_us(lambda: deconv_wgrad(x, dy)),
                      "plain_ms": cuda_ms(
                          lambda: deconv_wgrad_plain(x, dy), trials=3,
                          per_trial=3),
                      "library_ms": row["conv_transpose2d"]["dw"] / 1e3,
                      "bound_ms": 1e3 * flops / FP32_FLOP_PER_S,
                      "bound_by": "operations",
                      "max_abs_err": err,
                      "max_rel_err": err / float(exact.abs().max())}
                del dy, exact
                print(f"   K7 alone at deconv.7: {k7['ms']:.3f} ms (CUDA "
                      f"events), {k7['device_us']:.1f} device us (a CUDA "
                      f"graph), plain {k7['plain_ms']:.3f} ms, cuDNN's dw "
                      f"{k7['library_ms']:.3f} ms, bound "
                      f"{k7['bound_ms']:.3f} ms; against float64 "
                      f"{err:.3e} ({k7['max_rel_err']:.1e} of the largest)")
                if not k7["max_rel_err"] <= 1e-5:
                    raise AssertionError(f"K7 against float64: {k7}")
        model = flagship_model()
        model.load_state_dict(weights, strict=True)
        opt = make_optimizer(model.named_parameters(), lr=1e-3,
                             clip_grads=1e-5)
        images = torch.randint(0, 256, (512, 64, 64, 3), dtype=torch.uint8,
                               device="cuda", generator=gen)
        noise = torch.Generator().manual_seed(0)
        train_step(model, opt, images, 1.0, generator=noise)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            train_step(model, opt, images, 1.0, generator=noise)
            torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    low = [n for n in names if LOW_PRECISION.search(n)]
    print(f"   the float32 step at 512 images: {len(names)} device kernels "
          f"by name, {len(low)} named TF32, bf16 or fp16; the kernel's: "
          f"{[n for n in names if 'deconv_wgrad' in n]}")
    if low or not any("deconv_wgrad" in n for n in names):
        raise AssertionError(f"the float32 step's trace: low-precision "
                             f"kernels {low} among {len(names)} names")
    return rows, k7


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
    from lie_vae_tpu_torch.ops.kernels.deconv_wgrad import deconv_wgrad
    from lie_vae_tpu_torch.ops.wigner import block_wigner_apply_zjz
    from lie_vae_tpu_torch.precision import ieee_float32
    from lie_vae_tpu_torch.profile_serve import device_us, profile_request
    from lie_vae_tpu_torch.serve import InferenceSession
    from lie_vae_tpu_torch.train import make_optimizer, train_step
    from torch.profiler import ProfilerActivity, profile

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

    t0 = phase("build (one nvcc per source and g++ for the host library, "
               "all started together; beside them the profiler's first use "
               "and a fresh interpreter's start)")
    sources = ("wigner_chain", "so3_density", "wigner_block", "deconv_wgrad")
    host = "render_native"
    cached = {n: os.path.exists(_build.library_path(n)) for n in sources}
    cached[host] = os.path.exists(_build.host_library_path(host))

    def timed_build(name):
        tb = time.perf_counter()
        (_build.build_host if name == host else _build.build)(name)
        return time.perf_counter() - tb

    def ptxas(name):
        with open(_build.ptxas_log_path(name)) as f:
            return ptxas_report(f.read(), name)

    precision_child = start_precision_child()
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        builds = pool.map(timed_build, sources + (host,))
        # the profiler's first use takes seconds of host time: made here,
        # beside nvcc, and not in the first phase that profiles
        tw = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).sum().item()
        profiler_warm_s = time.perf_counter() - tw
        build_s = dict(zip(sources + (host,), builds))
    ptxas_all = {n: ptxas(n) for n in sources}
    for n in sources:
        print(f"   {n}: {build_s[n]:.2f} s "
              f"({'already built' if cached[n] else 'nvcc'}) -> "
              f"{_build.library_path(n)}")
        print(f"   {n}.cu, ptxas (registers, stack frame, spill stores, "
              "spill loads in bytes): " + "; ".join(
                  f"{k} {v}" for k, v in ptxas_all[n].items()))
    print(f"   {host}: {build_s[host]:.2f} s "
          f"({'already built' if cached[host] else 'g++'}) -> "
          f"{_build.host_library_path(host)}")
    print(f"   beside the builds: the profiler's first use "
          f"{profiler_warm_s:.2f} s; the fresh interpreter of the precision "
          "phase started")
    # the ranks of the data-parallel phase start here, after the builds
    # (beside them they slowed nvcc by a quarter), and wait for their inputs
    dp_launches = start_dp_launches()
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
            for k in (0, 1, 10, 30):
                ex, gx = density_case(fn, plain, n, B, k,
                                      (n, B) if what == "log q" else (B,),
                                      seed=10 * k + n)
                worst_v, worst_g = max(worst_v, ex), max(worst_g, gx)
                n_rep += 1
            print(f"   {what}, N={n * B} (n={n}, B={B}), k in (0, 1, 10, "
                  "30): "
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
    iwll30_us = device_us(lambda: so3_density._launch_fwd(vf, st, 30, 1e-3))
    print(f"   log q per sample, n=500 B=1 (the IW-LL's call): device "
          f"{iwll_us:.2f} us at k=10 (bound "
          f"{1e3 * density_bound(500, 1, 10, False, per_row=False)[0]:.4f}"
          f" us), {iwll30_us:.2f} us at k=30, the generic-k instantiation "
          f"(bound "
          f"{1e3 * density_bound(500, 1, 30, False, per_row=False)[0]:.4f}"
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

    t0 = phase("renders: sphere-cube poses of data_poses/spherecube.npz, "
               "natively, into PNG files; the dataset cold, its disk cache, "
               "the threaded loader")
    from lie_vae_tpu_torch.cli import gen_spherecube
    from lie_vae_tpu_torch.data import (BatchLoader, SphereCubeDataset,
                                        render_spherecube)
    manifest = os.path.join(ROOT, "data_poses", "spherecube.npz")
    with np.load(manifest) as f:
        poses = f["r"][:RENDER_POSES, 0]
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    tr0 = time.perf_counter()
    renders = gen_spherecube.generate(RENDER_POSES, DATA_DIR,
                                      from_poses=manifest)
    gen_s = time.perf_counter() - tr0
    if renders.shape != (RENDER_POSES, 64, 64, 3) or renders.max() == 0:
        raise AssertionError(f"renders {renders.shape}, max {renders.max()}")
    tr0 = time.perf_counter()
    native = render_spherecube(poses)
    native_s = time.perf_counter() - tr0
    tr0 = time.perf_counter()
    plain = render_spherecube(poses[:NUMPY_CHECK], backend="numpy")
    numpy_s = (time.perf_counter() - tr0) * RENDER_POSES / NUMPY_CHECK
    render_err = float(np.abs(native[:NUMPY_CHECK] - plain).max())
    bytes_differ = int(((native[:NUMPY_CHECK] * 255).astype(np.uint8)
                        != (plain * 255).astype(np.uint8)).sum())
    print(f"   {RENDER_POSES} PNG renders in {gen_s:.3f} s (render and "
          f"write) -> {DATA_DIR}; s per {RENDER_POSES} images: native "
          f"{native_s:.4f}, numpy {numpy_s:.3f} (timed on {NUMPY_CHECK})")
    print(f"   native vs numpy on {NUMPY_CHECK} poses: max |diff| "
          f"{render_err:.3e} (tol {RENDER_TOL}); {bytes_differ} of "
          f"{NUMPY_CHECK * 64 * 64 * 3} uint8 bytes differ")
    if not render_err <= RENDER_TOL:
        raise AssertionError("the native renderer disagrees with numpy")
    if not np.array_equal((native * 255).astype(np.uint8), renders):
        raise AssertionError("the written renders are not the native ones")
    everything = np.arange(RENDER_POSES)
    tr0 = time.perf_counter()
    cold_set = SphereCubeDataset(DATA_DIR)
    cold = cold_set.gather(everything[:COLD_DECODE])
    decode_ms = 1e3 * (time.perf_counter() - tr0) / COLD_DECODE
    tr0 = time.perf_counter()
    SphereCubeDataset(DATA_DIR).warm_cache()
    warm_cache_s = time.perf_counter() - tr0
    tr0 = time.perf_counter()
    warm = SphereCubeDataset(DATA_DIR)
    warm.warm_cache()
    cache_read_s = time.perf_counter() - tr0
    warm_items = warm.gather(everything)
    for what, items in (("cold", cold), ("warm", warm_items)):
        n = len(items[2])
        if not (np.array_equal(items[2], renders[:n])
                and np.array_equal(items[1][:COLD_DECODE], cold[1])):
            raise AssertionError(f"the {what} open's items differ from the "
                                 "rendered bytes")
    renders = warm_items[2]       # later phases take the images read back
    # the threaded loader over the cold open (decoding the rest in its
    # threads): the serial loader's batches
    serial = BatchLoader(warm, 64, seed=0, num_threads=0)
    threaded = BatchLoader(cold_set, 64, seed=0)
    tr0 = time.perf_counter()
    threaded_batches = list(threaded)
    loader_s = time.perf_counter() - tr0
    for a, b in zip(serial, threaded_batches, strict=True):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("the threaded loader's batches differ "
                                 "from the serial ones")
    print(f"   dataset cold: {decode_ms:.4f} ms per image decoded ("
          f"{COLD_DECODE} images); "
          f"warm_cache (decode and write the disk cache) {warm_cache_s:.3f}"
          f" s; an open reading it {cache_read_s:.4f} s; cold and warm "
          f"items equal to the rendered bytes; {threaded.num_threads} "
          f"loader threads: {len(threaded_batches)} batches of 64 in "
          f"{loader_s:.3f} s, the serial ones")
    render_s = {"generate_s": gen_s, "native_s_per_1024": native_s * 1024
                / RENDER_POSES, "numpy_s_per_1024": numpy_s * 1024
                / RENDER_POSES, "numpy_max_abs_diff": render_err,
                "bytes_differ": bytes_differ,
                "bytes_compared": NUMPY_CHECK * 64 * 64 * 3,
                "decode_ms_per_image": decode_ms,
                "warm_cache_s": warm_cache_s, "disk_cache_read_s":
                cache_read_s, "threaded_loader_s": loader_s}
    done(t0)

    weights = compat.load_torch(CHECKPOINT)
    batch = renders[:64]
    counters = ((fused, "launches"), (fused, "launches_residuals"),
                (fused, "launches_backward"), (dens, "launches"),
                (dens, "launches_backward"), (block, "launches"),
                (block, "launches_backward"), (deconv_wgrad, "launches"))

    def counts():
        prefix = {id(fused): "", id(dens): "density_", id(block): "block_",
                  id(deconv_wgrad): "deconv_"}
        return {prefix[id(obj)] + attr: getattr(obj, attr)
                for obj, attr in counters}

    eps = torch.randn((1, 64, 3), generator=torch.Generator().manual_seed(2))
    exact = train_once("cpu", torch.float64, weights, batch, eps, "fused",
                       recipe=False)
    x_dev = torch.as_tensor(batch, device=dev)
    os.makedirs(PROFILE_DIR, exist_ok=True)
    train_runs = {}
    for recipe, impl, want in (
            (False, "fused", [0, 1, 1, 1, 1, 0, 0, 3]),
            (False, "pallas", [0, 0, 0, 1, 1, 1, 1, 3]),
            (True, "fused", [0, 1, 1, 1, 1, 0, 0, 0]),
            (True, "pallas", [0, 0, 0, 1, 1, 1, 1, 0])):
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
                f"K3, K4, K5, K6, K7): {delta}, expected {want}")
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
                    f"K3, K4, K5, K6, K7): {delta}, expected {want}")
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
              f"forward, K2 backward, K3, K4, K5, K6, K7) {want}")
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
               "renders, --device_data, one epoch")
    _, normal_cli_s, normal_launches = cli_run(
        ["--config", "normal", "--dataset", "spherecube", "--data_dir",
         DATA_DIR, "--epochs", "1", "--device_data"],
        os.path.join(CLI_DIR, "normal"), (),
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
    want = [0, 1, 1, 0, 0, 0, 0, 3]
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
          f"K6, K7) {want}")
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

    for impl, want in (("fused", [0, 1, 1, 0, 0, 0, 0, 3]),
                       ("pallas", [0, 0, 0, 0, 0, 1, 1, 3])):
        tv = time.perf_counter()
        vmodel, vopt, vmf_paths[impl], vmf_worst[impl], vloss = vmf_steps(
            dict(vcfg, kernel_impl=impl), vweights, batch, x_dev, 9,
            counters, want, checked=1)
        print(f"   vmfq/action, {impl!r}: {VMF_STEPS} steps, loss {vloss:.4f}"
              f" after them, launches {vmf_paths[impl]} (K1, K2 forward, K2 "
              f"backward, K3, K4, K5, K6, K7); the first against the exact "
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
        mcfg, mweights, batch, x_dev, 11, counters, [0] * 7 + [3],
        checked=1)
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
               "pallas --device_data, one epoch")
    _, vmfq_cli_s, vmfq_cli_launches = cli_run(
        ["--dataset", "spherecube", "--latent_mode", "vmfq", "--kernel_impl",
         "pallas", "--data_dir", DATA_DIR, "--epochs", "1", "--device_data"],
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
    bench_aot = serve_bench_aot(os.path.join(ROOT, "build", "smoke_aot",
                                             "flagship_fused.npz"))
    done(t0)

    t0 = phase(f"sc-pairs renders: {REG_RENDER} seeded consecutive-pose "
               "pairs with the port's generator")
    tr0 = time.perf_counter()
    pair_images = gen_spherecube.generate(REG_RENDER, PAIRS_DIR, pairs=True)
    pairs_s = time.perf_counter() - tr0
    if pair_images.shape != (2 * REG_RENDER, 64, 64, 3):
        raise AssertionError(f"pair renders {pair_images.shape}")
    print(f"   {2 * REG_RENDER} PNG renders (native) in {pairs_s:.3f} s -> "
          f"{PAIRS_DIR}")
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
    for impl, rotate, want in (
            ("fused", "shear", [0, 1, 1, 1, 1, 0, 0, 3]),
            ("pallas", "shear", [0, 0, 0, 1, 1, 1, 1, 3]),
            ("fused", "gather", [0, 1, 1, 1, 1, 0, 0, 3])):
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
                                 f"K6, K7): {delta}, expected {want}")
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
    c5 = precision_subprocess(precision_child, batch, cpu,
                              float(exact[2]["loss"]))
    done(t0)

    t0 = phase(f"the analysis: python -m lie_vae_tpu_torch.cli."
               f"analyze_spherecube on the converged flagship, {N_TRAJ} poses "
               "a trajectory, on the card ('fused', then --kernel_impl "
               "pallas) and on the CPU; toy inputs along the circle")
    from lie_vae_tpu_torch import analysis
    from lie_vae_tpu_torch.cli import analyze_spherecube
    argv = ["--torch_checkpoint", CHECKPOINT, "--n_traj", str(N_TRAJ)]
    card_runs = {}
    for impl in ("fused", "pallas"):
        for obj, attr in counters:
            setattr(obj, attr, 0)
        ta = time.perf_counter()
        res, arr, model = analyze_spherecube.main(
            argv + ["--kernel_impl", impl, "--out_dir",
                    os.path.join(ANALYSIS_DIR, impl)])
        card_runs[impl] = (res, arr, model, time.perf_counter() - ta,
                           counts())
    analysis_s = {k: v[3] for k, v in card_runs.items()}
    analysis_launches = card_runs["fused"][4]
    analysis_pallas_launches = card_runs["pallas"][4]
    print(f"   launches: 'fused' {analysis_launches}, 'pallas' "
          f"{analysis_pallas_launches}; on the card "
          + ", ".join(f"{k} {v:.2f} s" for k, v in analysis_s.items()))
    # toy observations along the circle through K1 and K5 (L = 6, C = 10),
    # a path of their own
    circle = analysis.circle_trajectory(N_TRAJ, axis=(0.3, 0.5, 0.81)).to(dev)
    harmonics = torch.randn((49, 10), generator=gen)
    for obj, attr in counters:
        setattr(obj, attr, 0)
    toy_in = {impl: analysis.toy_inputs_for_trajectory(circle, harmonics, 6,
                                                       impl=impl)
              for impl in ("fused", "pallas")}
    toy_in_launches = counts()
    want_toy = block_wigner_apply_zjz(group_matrix_to_eazyz(circle),
                                      harmonics.to(dev), 6)
    toy_err = {k: max_rel(v, want_toy)[1] for k, v in toy_in.items()}
    print(f"   toy inputs along the circle vs the plain chain: " + ", ".join(
        f"{k} {v:.2e}" for k, v in toy_err.items())
          + f" (tol {KERNEL_TOL}); launches {toy_in_launches}")
    if not all(v <= KERNEL_TOL for v in toy_err.values()):
        raise AssertionError("toy inputs disagree with the plain chain")
    with torch.no_grad():
        flagship = flagship_model()
        flagship.load_state_dict(weights, strict=True)
        want_state = flagship.state_dict()
    for impl, (_, _, model, _, _) in card_runs.items():
        after = model.state_dict()
        moved = [k for k, v in want_state.items()
                 if not torch.equal(after[k], v)]
        modes = {m.training for m in model.modules()}
        flags = {getattr(m, "deterministic", False) for m in model.modules()}
        if moved or modes != {True} or flags != {False} \
                or model.reparameterize[0].k != 10 or model.density_k != 10:
            raise AssertionError(f"the analysis ({impl}) changed the model: "
                                 f"{moved}, modes {modes}, flags {flags}")
    tc = time.perf_counter()
    c_res, c_arr, _ = analyze_spherecube.main(
        argv + ["--device", "cpu", "--out_dir",
                os.path.join(ANALYSIS_DIR, "cpu")])
    cpu_analysis_s = time.perf_counter() - tc
    analysis_vs_cpu = {}
    for impl, (a_res, a_arr, _, _, _) in card_runs.items():
        d_enc = max(float(np.abs(a_arr[k] - c_arr[k]).max())
                    for k in ("encodings_circle", "encodings_random_walk"))
        d_rec = float(np.abs(a_arr["recon_circle"]
                             - c_arr["recon_circle"]).max())
        scalars = {f"{t}_{s}": (a_res[f"discontinuity_{t}"][s],
                                c_res[f"discontinuity_{t}"][s])
                   for t in ("circle", "random_walk") for s in ("mean", "max")}
        scalars["recon_error_circle"] = (a_res["recon_error_circle"],
                                         c_res["recon_error_circle"])
        d_scalar = max(abs(a - c) / max(abs(c), 1e-12)
                       for a, c in scalars.values())
        outliers = {}
        for t in ("circle", "random_walk"):
            jumps, _ = analysis.discontinuity_score(c_arr[f"encodings_{t}"])
            edge = 10.0 * np.median(jumps)
            outliers[t] = (a_res[f"discontinuity_{t}"]["num_outliers"],
                           c_res[f"discontinuity_{t}"]["num_outliers"],
                           int((np.abs(jumps - edge) <= 1e-3 * edge).sum()))
        print(f"   card ({impl}) vs CPU: encodings max |diff| {d_enc:.3e} "
              f"(tol {POSE_TOL}), recon strip {d_rec:.3e} (tol {IMAGE_TOL}),"
              f" discontinuity means/maxima and recon error worst relative "
              f"{d_scalar:.3e} (tol 1e-3); outliers (card, CPU, jumps within "
              f"1e-3 of the threshold): {outliers}")
        if not (d_enc <= POSE_TOL and d_rec <= IMAGE_TOL and d_scalar <= 1e-3
                and all(abs(a - c) <= e for a, c, e in outliers.values())):
            raise AssertionError(f"the card's analysis ({impl}) disagrees "
                                 "with the CPU's")
        analysis_vs_cpu[impl] = [d_enc, d_rec, d_scalar]
        for name in ("spherecube_results.json", "SPHERECUBE_ANALYSIS.md",
                     "encoded_poses.png", "recon.png"):
            if not os.path.getsize(os.path.join(ANALYSIS_DIR, impl, name)):
                raise AssertionError(f"the analysis ({impl}) wrote no {name}")
    a_res = card_runs["fused"][0]
    print(f"   the CPU's run {cpu_analysis_s:.2f} s; discontinuity (mean / "
          "max / outliers): " + "; ".join(
              f"{t} {a_res[f'discontinuity_{t}']['mean']:.4f} / "
              f"{a_res[f'discontinuity_{t}']['max']:.4f} / "
              f"{a_res[f'discontinuity_{t}']['num_outliers']}"
              for t in ("circle", "random_walk"))
          + f"; recon error (circle) {a_res['recon_error_circle']:.4f}")
    done(t0)

    t0 = phase(f"the checkpoint's evaluation: python -m lie_vae_tpu_torch."
               f"cli.eval_checkpoint on the CLI phase's checkpoint, "
               f"--density_k {' '.join(map(str, EVAL_K))} --ll_n {EVAL_N}, "
               f"{EVAL_ITEMS} items")
    from lie_vae_tpu_torch.cli import eval_checkpoint
    for obj, attr in counters:
        setattr(obj, attr, 0)
    te = time.perf_counter()
    ev = eval_checkpoint.main(
        ["--density_k", *map(str, EVAL_K), "--ll_n", str(EVAL_N),
         "--max_items", str(EVAL_ITEMS), "--dataset", "spherecube",
         "--data_dir", DATA_DIR, "--save_dir", CLI_DIR])
    eval_s = time.perf_counter() - te
    eval_launches = counts()
    print(f"   launches in the path: {eval_launches}; {eval_s:.2f} s; "
          f"checkpoint step {ev['step']}; sigma {ev['sigma']}")
    for k in EVAL_K:
        r = ev["ll"][k]
        gap = np.asarray(r["items"]) - np.asarray(r["mean_log_weights"])
        print(f"   k = {k}: IW-LL {r['ll']:.4f}, items above the mean of "
              f"their own log-weights by {gap.min():.3f} .. {gap.max():.3f}")
        if not (len(r["items"]) == EVAL_ITEMS and np.isfinite(r["ll"])
                and (gap >= 0).all()):
            raise AssertionError(f"IW-LL at k = {k}: {r}")
    iwll = {k: ev["ll"][k]["ll"] for k in EVAL_K}
    print(f"   IW-LL(k = 30) - IW-LL(k = 10): {iwll[30] - iwll[10]:.6f}")
    done(t0)
    toy_sweep = toy_sweep_phase(counters, counts)
    dp_train = dp_train_phase(weights, batch, counters, dp_launches)
    dp_serve = dp_serve_phase(weights, batch, counters, counts)

    t0 = phase("the decoder's transposed convolutions at 512 images against "
               "F.conv_transpose2d, and the float32 step's kernels")
    deconv, k7 = deconv_phase(weights)
    done(t0)
    # the kernels each new path must launch, and no training kernel
    new_paths = {"analysis": (analysis_launches, ("launches",)),
                 "analysis_pallas": (analysis_pallas_launches,
                                     ("block_launches",)),
                 "toy_inputs": (toy_in_launches,
                                ("launches", "block_launches")),
                 "eval_checkpoint": (eval_launches,
                                     ("launches", "density_launches"))}
    for path, (got, want) in new_paths.items():
        if any(got[k] for k in ("launches_residuals", "launches_backward",
                                "density_launches_backward",
                                "block_launches_backward")):
            raise AssertionError(f"the {path} path launched a training "
                                 f"kernel: {got}")
        if not all(got[k] for k in want):
            raise AssertionError(f"the {path} path did not launch "
                                 f"{want}: {got}")

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
                kernels[-1]["device_us_iwll_n500_k30"] = iwll30_us
    kernels.append(dict(
        k7, name="deconv_wgrad", route="cuda",
        source="lie_vae_tpu_torch/csrc/deconv_wgrad.cu", replaces=None,
        launches=train_launches["deconv_launches"]))
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
    paths.update({k: v[0] for k, v in new_paths.items()})
    paths["degree_sweep"] = toy_sweep["sweep_launches"]
    paths.update({f"toy_matrix_{k}": toy_sweep[f"toy_matrix_{k}"]["launches"]
                  for k in ("fused", "pallas")})
    paths.update({f"dp_{k}_rank0": v["launches_per_rank"][0]
                  for k, v in dp_train.items()})
    paths["dp_serve"] = dp_serve["eager"]["launches"]
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
               "wigner_block_bwd": "block_launches_backward",
               "deconv_wgrad": "deconv_launches"}[entry["name"]]
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
              "serve_bench_aot": bench_aot,
              "reg_step": reg_runs, "reg_step_worst_share": reg_worst,
              "scpairs_cli_epoch_s": scp_epoch_s, "scpairs_tags": reg_tags,
              "analysis_s": analysis_s, "analysis_cpu_s": cpu_analysis_s,
              "analysis": {k: v for k, v in a_res.items()
                           if not k.startswith("pca_")},
              "analysis_vs_cpu": analysis_vs_cpu,
              "toy_inputs_err": toy_err, "eval_s": eval_s, "iwll": iwll,
              "eval_sigma": ev["sigma"],
              "toy_sweep": toy_sweep, "dp_train": dp_train,
              "dp_serve": dp_serve, "deconv": deconv,
              "total_s": time.perf_counter() - t_start}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-after"]:
        rank_after(sys.argv[2:])
    else:
        main()
