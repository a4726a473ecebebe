"""Time the wrapped SO(3) density kernels (K3, K4) of this tree against an
earlier design of their source on one card.

    git show <commit>:lie_vae_tpu_torch/csrc/so3_density.cu > chip_stage/old.cu
    python -m lie_vae_tpu_torch.compare_so3_density chip_stage/old.cu

The earlier design is the first port's interface: one thread a sample,
``so3_density_fwd(v, sigma, out, N, B, k, clamp, stream)`` giving log q per
sample and ``so3_density_bwd(v, sigma, g, dv, dsigma, N, B, k, clamp,
stream)`` giving dsigma per sample, with N a 64-bit count. Around it the KL
was torch ops: the prior as ``torch.full``, a subtraction and a mean over
the n samples forward; their backward, a contiguous copy of the cotangent
and a sum of dsigma over the n samples after K4. The script builds that
source with the package's nvcc flags, holds both designs against the plain
density and KL in float64, then times them in turns (old, new, new, old)
by device µs from a CUDA graph of 20 launches (median of 20 replays),
k = 10:

- at N = B in (64, 4096, 65536) (n = 1, the training shape): K3 alone
  (old: its kernel; new: the KL entry), K4 alone (new: the KL's cotangent
  per row), and the whole KL forward, and forward with backward for v and
  sigma, glue included;
- at n = 500, B = 1 (the IW-LL's call of the log-posterior): K3 alone
  (the new per-sample entry);
- one launch's floor in the same harness: a one-element ``fill_``;
- then the new K3 (KL entry) and K4 at every lane-group width G in
  ``LANES`` for N = B from 64 to 1048576, to place the crossovers that
  ``lanes_for`` draws (``FWD_LANE_SAMPLES_PER_SM``,
  ``BWD_LANE_SAMPLES_PER_SM``).

It prints the card's name and power limit, one line per measurement and a
JSON record as its last line.
"""
import argparse
import ctypes
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from lie_vae_tpu_torch.distributions.so3 import (
    LOG_HAAR_UNIFORM, so3_wrapped_kl_plain, so3_wrapped_log_density_plain)
from lie_vae_tpu_torch.ops.kernels import _build, so3_density
from lie_vae_tpu_torch.profile_serve import device_us

TOL = 1e-4          # values against the plain version in float64, as
GRAD_TOL = 1e-3     # chip_smoke.py: relative, a gradient row to its largest
K, CLAMP = 10, 1e-3


def _build_old(path):
    """The earlier source built with the package's flags into
    build/kernels/; returns the loaded library."""
    out = os.path.join(_build.BUILD_DIR, "libso3_density_old.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, path],
                   check=True)
    lib = ctypes.CDLL(out)
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.so3_density_fwd.argtypes = [ptr] * 3 + [i64, i32, i32, f32, ptr]
    lib.so3_density_bwd.argtypes = [ptr] * 5 + [i64, i32, i32, f32, ptr]
    lib.so3_density_fwd.restype = lib.so3_density_bwd.restype = i32
    return lib


class _Old:
    """The earlier design's launches, its autograd Function and its KL."""

    def __init__(self, lib):
        self.lib = lib

    def fwd(self, v, sigma):
        N, B = v.shape[0], sigma.shape[0]
        out = torch.empty((N,), device=v.device)
        rc = self.lib.so3_density_fwd(
            v.data_ptr(), sigma.data_ptr(), out.data_ptr(), N, B, K, CLAMP,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    def bwd(self, v, sigma, g):
        N, B = v.shape[0], sigma.shape[0]
        dv = torch.empty((N, 3), device=v.device)
        ds = torch.empty((N, 3), device=v.device)
        rc = self.lib.so3_density_bwd(
            v.data_ptr(), sigma.data_ptr(), g.data_ptr(), dv.data_ptr(),
            ds.data_ptr(), N, B, K, CLAMP,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return dv, ds

    def log_density(self, v, sigma):
        """v (n, B, 3) -> (n, B), dsigma summed over n after the kernel."""
        old = self

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, vf, sigma):
                ctx.save_for_backward(vf, sigma)
                return old.fwd(vf, sigma)

            @staticmethod
            @once_differentiable
            def backward(ctx, g):
                vf, sigma = ctx.saved_tensors
                dv, ds = old.bwd(vf, sigma, g.contiguous())
                return dv, ds.view(-1, *sigma.shape).sum(0)

        n, B = v.shape[:2]
        return Fn.apply(v.reshape(n * B, 3), sigma).view(n, B)

    def kl(self, v, sigma):
        """The KL as the earlier stats struct formed it around K3."""
        log_q = self.log_density(v, sigma)
        prior = torch.full(v.shape[:2], LOG_HAAR_UNIFORM, dtype=v.dtype,
                           device=v.device)
        return torch.mean(log_q - prior, dim=0)


def _inputs(n, B, gen, dev):
    """sigma log-uniform in [1e-3, 5], v = eps * sigma, float32."""
    sigma = torch.exp(torch.empty((B, 3)).uniform_(
        np.log(1e-3), np.log(5.0), generator=gen))
    v = torch.randn((n, B, 3), generator=gen) * sigma
    return v.to(dev), sigma.to(dev)


def _excess(got, want, tol, rows=False):
    got, want = got.double(), want.double()
    if rows:
        return ((got - want).abs().amax(-1) / (
            tol * (1 + want.abs().amax(-1)))).max().item()
    return ((got - want).abs() / (tol * (1 + want.abs()))).max().item()


def check(old, n, B, gen, dev):
    """Both designs' log q, KL and KL gradients against the plain version
    in float64; returns the worst share of the tolerance."""
    v, sigma = _inputs(n, B, gen, dev)
    g = torch.randn((B,), generator=gen).to(dev)
    v64 = v.double().requires_grad_()
    s64 = sigma.double().requires_grad_()
    want_q = so3_wrapped_log_density_plain(v64, s64, K).detach()
    kl = so3_wrapped_kl_plain(v64, s64, K)
    want = (kl.detach(),) + torch.autograd.grad(kl, (v64, s64), g.double())
    worst = 0.0
    for name, log_density, kl_fn in (
            ("old", old.log_density, old.kl),
            ("new", so3_density.so3_wrapped_log_density_fused,
             so3_density.so3_wrapped_kl_fused)):
        vv = v.clone().requires_grad_()
        ss = sigma.clone().requires_grad_()
        kl = kl_fn(vv, ss)
        got = (kl.detach(),) + torch.autograd.grad(kl, (vv, ss), g)
        errs = (_excess(log_density(v, sigma).detach(), want_q, TOL),
                _excess(got[0], want[0], TOL),
                _excess(got[1], want[1], GRAD_TOL, rows=True),
                _excess(got[2], want[2], GRAD_TOL, rows=True))
        if not max(errs) <= 1.0:
            raise AssertionError(f"{name}: n={n} B={B}: shares of the "
                                 f"tolerance (log q, kl, dv, dsigma) {errs}")
        worst = max(worst, *errs)
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_source", help="the earlier csrc/so3_density.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_so3_density needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, f"torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    old = _Old(_build_old(args.old_source))
    _build.build("so3_density")
    print(f"built both in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator().manual_seed(0)
    worst = max(check(old, n, B, gen, dev) for n, B in (
        (1, 1), (1, 64), (4, 1024), (1, 4103), (3, 500), (500, 1)))
    print(f"old and new vs plain: worst share of the tolerance {worst:.3f}")

    record = {"card": card}

    def turns(name, f_old, f_new):
        t = [device_us(f) for f in (f_old, f_new, f_new, f_old)]
        record[name] = t
        ratio = (t[0] + t[3]) / (t[1] + t[2])
        print(f"{name}: device us old {t[0]:.2f} / new {t[1]:.2f} / new "
              f"{t[2]:.2f} / old {t[3]:.2f} ({ratio:.2f}x)", flush=True)

    for N in (64, 4096, 65536):
        v, sigma = _inputs(1, N, gen, dev)
        vf = v.view(N, 3)
        g = torch.randn((N,), generator=gen).to(dev)
        turns(f"K3_n{N}", lambda: old.fwd(vf, sigma),
              lambda: so3_density._launch_kl(vf, sigma, K, CLAMP))
        turns(f"K4_n{N}", lambda: old.bwd(vf, sigma, g),
              lambda: so3_density._launch_bwd(vf, sigma, g, K, CLAMP, True))
        turns(f"kl_fwd_n{N}", lambda: old.kl(v, sigma),
              lambda: so3_density.so3_wrapped_kl_fused(v, sigma))
        # each op differentiates leaves of its own: a capture fails where
        # the leaves' autograd state was made on the default stream first
        leaves = [(v.clone().requires_grad_(), sigma.clone().requires_grad_())
                  for _ in range(2)]

        def fwd_bwd(kl_fn, vv, ss):
            return torch.autograd.grad(kl_fn(vv, ss), (vv, ss), g)

        turns(f"kl_fwd_bwd_n{N}", lambda: fwd_bwd(old.kl, *leaves[0]),
              lambda: fwd_bwd(so3_density.so3_wrapped_kl_fused, *leaves[1]))
    v, sigma = _inputs(500, 1, gen, dev)
    vf = v.view(500, 3)
    turns("K3_iwll_n500", lambda: old.fwd(vf, sigma),
          lambda: so3_density._launch_fwd(vf, sigma, K, CLAMP))

    one = torch.zeros((1,), device=dev)
    record["floor_us"] = device_us(lambda: one.fill_(1.0))
    print(f"one launch's floor (a one-element fill_): device us "
          f"{record['floor_us']:.2f}", flush=True)
    sweep = {}
    for N in (64, 512, 2048, 4096, 16384, 65536, 262144, 1048576):
        v, sigma = _inputs(1, N, gen, dev)
        vf = v.view(N, 3)
        g = torch.randn((N,), generator=gen).to(dev)
        row = {}
        for G in so3_density.LANES:
            row[G] = (device_us(lambda: so3_density._launch_kl(
                vf, sigma, K, CLAMP, lanes=G)),
                device_us(lambda: so3_density._launch_bwd(
                    vf, sigma, g, K, CLAMP, True, lanes=G)))
        sweep[N] = row
        print(f"N={N}: device us (K3, K4) by lanes: " + ", ".join(
            f"G={G} {a:.2f} {b:.2f}" for G, (a, b) in row.items())
            + "; the wrappers pick " + ", ".join(
                str(so3_density._lanes(N, dev, None, per_sm)) for per_sm in (
                    so3_density.FWD_LANE_SAMPLES_PER_SM,
                    so3_density.BWD_LANE_SAMPLES_PER_SM)), flush=True)
    record["lanes_sweep"] = {str(N): {str(G): t for G, t in row.items()}
                             for N, row in sweep.items()}
    print(json.dumps(record))


if __name__ == "__main__":
    main()
