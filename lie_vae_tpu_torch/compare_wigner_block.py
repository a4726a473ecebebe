"""Time the synthesise-then-apply Wigner kernels (K5, K6) of this tree
against an earlier design of their source on one card.

    git show <commit>:lie_vae_tpu_torch/csrc/wigner_block.cu > chip_stage/old.cu
    python -m lie_vae_tpu_torch.compare_wigner_block chip_stage/old.cu

The earlier design is the first port's interface: it takes the trig features
(t, ca, sa, cg, sg) from torch ops and the packed coefficients of every
degree block, and its backward returns their cotangents, from which
autograd forms the angle gradients. The script builds that source with the
package's nvcc flags, holds both designs against the plain version
(``trig_features`` + ``wigner_block_apply_plain`` and its autograd), then
times them in turns (old, new, new, old) at L = 6, C = 10 with a shared
spectrum, B in (64, 4096), by device µs from a CUDA graph of 20 launches
(median of 20 replays):

- K5 alone (the old one with features precomputed outside the graph) and
  K6 alone (both launches of the new one);
- the whole ``pallas`` op forward (old: the trig features and K5) and
  forward with backward (old: the features, K5, K6 and autograd through the
  features; new: K5 and K6) for the angles and the spectrum. The old op's
  features use frequencies kept on the device (see ``_Old.features``), so
  its times are lower bounds.

It prints the card's name and power limit, one line per measurement and a
JSON record as its last line.
"""
import argparse
import ctypes
import json
import os
import subprocess
import time

import torch

from lie_vae_tpu_torch.ops import group_matrix_to_eazyz, random_group_matrices
from lie_vae_tpu_torch.ops.kernels import _build, wigner_block
from lie_vae_tpu_torch.ops.wigner import _coeffs, _trig_basis
from lie_vae_tpu_torch.profile_serve import device_us

TOL = 1e-5           # outputs against the plain version, as chip_smoke.py
GRAD_TOL = 1e-4      # gradients, of max(1, max |reference|)


def _build_old(path):
    """The earlier source built with the package's flags into
    build/kernels/; returns the loaded library."""
    out = os.path.join(_build.BUILD_DIR, "libwigner_block_old.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, path],
                   check=True)
    lib = ctypes.CDLL(out)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wigner_block_fwd.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    lib.wigner_block_bwd.argtypes = [ptr] * 14 + [i32] * 5 + [ptr]
    lib.wigner_block_fwd.restype = lib.wigner_block_bwd.restype = i32
    return lib


class _Old:
    """The earlier design's launches and its autograd Function over the
    trig features and the spectrum."""

    def __init__(self, lib, device):
        self.lib, self.device, self.coef, self.freqs = lib, device, {}, {}

    def _coef(self, L):
        if L not in self.coef:
            self.coef[L] = torch.as_tensor(
                wigner_block._packed_coeffs_np(L), device=self.device)
        return self.coef[L]

    def features(self, angles, L):
        """``trig_features`` with the row frequencies kept on the device:
        the first port copied them from the host on every call, which a
        CUDA graph cannot capture, so the old op timed here is a little
        faster than it was."""
        if L not in self.freqs:
            self.freqs[L] = torch.as_tensor(_coeffs(L)[0],
                                            dtype=torch.float32,
                                            device=self.device)
        f = self.freqs[L]
        a, b, g = angles.unbind(-1)
        return [_trig_basis(b, L), torch.cos(f * a[:, None]),
                torch.sin(f * a[:, None]), torch.cos(f * g[:, None]),
                torch.sin(f * g[:, None])]

    def fwd(self, feats, spec, L):
        B, C = feats[0].shape[0], spec.shape[-1]
        out = torch.empty((B, (L + 1) ** 2, C), device=spec.device)
        rc = self.lib.wigner_block_fwd(
            *(f.data_ptr() for f in feats), spec.data_ptr(),
            self._coef(L).data_ptr(), out.data_ptr(), B, L, C,
            int(spec.dim() == 3), 0, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    def bwd(self, feats, spec, dout, L):
        B, C = feats[0].shape[0], spec.shape[-1]
        grads = [torch.empty_like(f) for f in feats]
        dspec = torch.empty_like(dout)
        rc = self.lib.wigner_block_bwd(
            *(f.data_ptr() for f in feats), spec.data_ptr(), dout.data_ptr(),
            self._coef(L).data_ptr(), *(g.data_ptr() for g in grads),
            dspec.data_ptr(), B, L, C, int(spec.dim() == 3), 0,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return grads, dspec

    def op(self, angles, spec, L):
        """The old ``pallas`` op: torch trig features, then K5 (K6 in the
        backward, autograd through the features)."""
        old = self

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, spec, *feats):
                ctx.save_for_backward(spec, *feats)
                return old.fwd(feats, spec, L)

            @staticmethod
            def backward(ctx, dout):
                spec, *feats = ctx.saved_tensors
                grads, dspec = old.bwd(feats, spec, dout.contiguous(), L)
                return (dspec.sum(0) if spec.dim() == 2 else dspec, *grads)

        return Fn.apply(spec, *self.features(angles, L))


def _max_rel(got, want):
    return ((got - want).abs().max() / max(1.0, want.abs().max())).item()


def check(old, L, B, C, gen, dev):
    """Both designs' outputs and gradients against the plain version on
    one random case (shared spectrum); returns the worst relative error."""
    angles = group_matrix_to_eazyz(random_group_matrices(
        B, gen, device="cpu").to(dev)).contiguous()
    x = torch.randn(((L + 1) ** 2, C), generator=gen).to(dev)
    dout = torch.randn((B, (L + 1) ** 2, C), generator=gen).to(dev)
    res = []
    for fn in (lambda a, s: old.op(a, s, L), lambda a, s: wigner_block
               .block_wigner_matrix_multiply_pallas(a, s, L),
               lambda a, s: wigner_block.wigner_block_apply_plain(
                   *wigner_block.trig_features(a, L), s, L)):
        a = angles.clone().requires_grad_()
        xx = x.clone().requires_grad_()
        out = fn(a, xx)
        res.append((out.detach(),) + torch.autograd.grad(out, (a, xx), dout))
    worst = 0.0
    for got in res[:2]:
        errs = [_max_rel(g, w) for g, w in zip(got, res[2])]
        if not (errs[0] <= TOL and max(errs[1:]) <= GRAD_TOL):
            raise AssertionError(f"L={L} B={B} C={C}: {errs}")
        worst = max(worst, *errs)
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_source", help="the earlier csrc/wigner_block.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_wigner_block needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, f"torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib_old = _build_old(args.old_source)
    _build.build("wigner_block")
    print(f"built both in {time.perf_counter() - t0:.1f} s", flush=True)
    L, C = 6, 10
    old = _Old(lib_old, dev)
    gen = torch.Generator().manual_seed(0)
    worst = max(check(old, l, B, c, gen, dev)
                for l in (0, 3, 6) for B in (1, 64, 4103) for c in (1, 10))
    print(f"old and new vs plain: worst relative error {worst:.3e}")

    new_op = wigner_block.block_wigner_matrix_multiply_pallas
    x = torch.randn(((L + 1) ** 2, C), generator=gen).to(dev)
    record = {"card": card}
    for B in (64, 4096):
        angles = group_matrix_to_eazyz(random_group_matrices(
            B, gen, device="cpu").to(dev)).contiguous()
        dout = torch.randn((B, (L + 1) ** 2, C), generator=gen).to(dev)
        feats = old.features(angles, L)
        a = angles.clone().requires_grad_()
        xx = x.clone().requires_grad_()

        def both(op):
            out = op(a, xx)
            return torch.autograd.grad(out, (a, xx), dout)

        cases = {
            "K5": (lambda: old.fwd(feats, x, L),
                   lambda: wigner_block._launch(angles, x, L, False)),
            "K6": (lambda: old.bwd(feats, x, dout, L),
                   lambda: wigner_block._launch_backward(
                       angles, x, dout, L, False, True)),
            "op_fwd": (lambda: old.op(angles, x, L),
                       lambda: new_op(angles, x, L)),
            "op_fwd_bwd": (lambda: both(lambda p, q: old.op(p, q, L)),
                           lambda: both(lambda p, q: new_op(p, q, L))),
        }
        for name, (f_old, f_new) in cases.items():
            turns = [device_us(f) for f in (f_old, f_new, f_new, f_old)]
            record[f"{name}_b{B}"] = turns
            print(f"B={B} {name}: device us old {turns[0]:.2f} / new "
                  f"{turns[1]:.2f} / new {turns[2]:.2f} / old {turns[3]:.2f}"
                  f" ({(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x)",
                  flush=True)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
