"""The per-sample synthesise-then-apply Wigner product and its backward as
hand-written CUDA kernels.

``csrc/wigner_block.cu`` computes out[b] = W(angles[b]) @ spec[b] from the
trig features of the angles and the Fourier coefficients of the middle
factor, without writing W to memory, and the backward: the cotangents of
the trig features and of the spectrum. It replaces the TPU kernels
``_wigner_apply_kernel`` and ``_wigner_bwd_kernel`` of the JAX package's
``ops/kernels/wigner_block.py``; the source says how the design differs and
what bounds it on an H100.

:func:`block_wigner_matrix_multiply_pallas` (the JAX name; it is the path of
``impl='pallas'``) computes the trig features with torch ops, so the angle
gradients flow through them by autograd, and then launches the kernels for
CUDA tensors (the backward through a ``torch.autograd.Function``) or runs
:func:`wigner_block_apply_plain` for CPU tensors.
"""
import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from lie_vae_tpu_torch.ops.kernels import _build
from lie_vae_tpu_torch.ops.wigner import _coeffs, _trig_basis

__all__ = ["block_wigner_matrix_multiply_pallas", "wigner_block_apply_plain",
           "packed_coeffs", "trig_features"]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(_build.build("wigner_block"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wigner_block_fwd.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    lib.wigner_block_bwd.argtypes = [ptr] * 14 + [i32] * 5 + [ptr]
    lib.wigner_block_fwd.restype = lib.wigner_block_bwd.restype = i32
    return lib


@functools.lru_cache(maxsize=32)
def _kernel_coeffs(max_degree):
    """The four block-reversed coefficient tensors C, C[rev, :], C[:, rev],
    C[rev, rev], each (2L+1, S, S) float64 numpy."""
    _, rev, C = _coeffs(max_degree)
    return C, C[:, rev, :], C[:, :, rev], C[:, rev, :][:, :, rev]


@functools.lru_cache(maxsize=32)
def _packed_coeffs_np(max_degree):
    """C packed as the kernel reads it: per degree l, its 2l+1 frequencies
    (cos 0..l, then sin 1..l) times the (2l+1, 2l+1) diagonal block,
    sum_l (2l+1)^3 float32 values (the other entries of C are zero)."""
    L = max_degree
    _, _, C = _coeffs(L)
    parts = []
    for l in range(L + 1):
        o, n = l * l, 2 * l + 1
        slots = list(range(l + 1)) + [L + m for m in range(1, l + 1)]
        parts.append(C[slots, o:o + n, o:o + n].reshape(-1))
    return np.concatenate(parts).astype(np.float32)


@functools.lru_cache(maxsize=None)
def packed_coeffs(max_degree, device):
    """:func:`_packed_coeffs_np` as a float32 tensor on ``device``."""
    return torch.as_tensor(_packed_coeffs_np(max_degree), device=device)


def trig_features(angles, max_degree):
    """(t, ca, sa, cg, sg) of ZYZ ``angles`` (B, 3), in their dtype: t =
    ``_trig_basis(beta)`` (B, 2L+1); ca, sa = cos, sin(f alpha) and cg, sg
    = cos, sin(f gamma) at the row frequencies f, (B, S) each."""
    L = max_degree
    freqs = torch.as_tensor(_coeffs(L)[0], dtype=angles.dtype,
                            device=angles.device)
    a, b, g = angles.unbind(-1)
    return (_trig_basis(b, L), torch.cos(freqs * a[:, None]),
            torch.sin(freqs * a[:, None]), torch.cos(freqs * g[:, None]),
            torch.sin(freqs * g[:, None]))


def wigner_block_apply_plain(t, ca, sa, cg, sg, spec, max_degree,
                             transpose=False):
    """The plain version of the kernel, with its arguments: the four
    syntheses d = sum_m t_m C_m (and of C[rev, :], C[:, rev], C[rev, rev]),
    W = cg (ca d + sa d_row) - sg (ca d_col + sa d_both) with ca, sa scaling
    rows and cg, sg columns, then one batched product with the shared (S, C)
    or per-sample (B, S, C) spectrum (W^T with ``transpose``). Computes in
    the spectrum's dtype; autograd of it is the reference of the backward
    kernel."""
    coeffs = [torch.as_tensor(c, dtype=spec.dtype, device=spec.device)
              for c in _kernel_coeffs(max_degree)]
    d, drow, dcol, dboth = (torch.einsum("bm,mse->bse", t, c)
                            for c in coeffs)
    ca, sa = ca[:, :, None], sa[:, :, None]
    W = cg[:, None, :] * (ca * d + sa * drow) \
        - sg[:, None, :] * (ca * dcol + sa * dboth)
    if transpose:
        W = W.transpose(-1, -2)
    if spec.dim() == 2:
        return torch.einsum("bse,ec->bsc", W, spec)
    return torch.einsum("bse,bec->bsc", W, spec)


def _check(rc, name, B, L, C):
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} (B={B}, L={L}, "
                           f"C={C})")


def _launch(t, ca, sa, cg, sg, spec, max_degree, transpose):
    """K5: out = W spec (W^T spec with ``transpose``), (B, S, C)."""
    B, S = t.shape[0], (max_degree + 1) ** 2
    C = spec.shape[-1]
    out = torch.empty((B, S, C), dtype=torch.float32, device=t.device)
    coef = packed_coeffs(max_degree, t.device)
    with torch.cuda.device(t.device):
        rc = _lib().wigner_block_fwd(
            t.data_ptr(), ca.data_ptr(), sa.data_ptr(), cg.data_ptr(),
            sg.data_ptr(), spec.data_ptr(), coef.data_ptr(), out.data_ptr(),
            B, max_degree, C, int(spec.dim() == 3), int(transpose),
            torch.cuda.current_stream().cuda_stream)
    _check(rc, "wigner_block_fwd", B, max_degree, C)
    block_wigner_matrix_multiply_pallas.launches += 1
    return out


def _launch_backward(t, ca, sa, cg, sg, spec, dout, max_degree, transpose,
                     want_dspec):
    """K6: from the cotangent dout (B, S, C) of out, (dt (B, M), dca, dsa,
    dcg, dsg (B, S), dspec per sample (B, S, C) or None)."""
    B, S = t.shape[0], (max_degree + 1) ** 2
    M, C = 2 * max_degree + 1, spec.shape[-1]
    dev = t.device
    dt = torch.empty((B, M), dtype=torch.float32, device=dev)
    dca, dsa, dcg, dsg = (torch.empty((B, S), dtype=torch.float32,
                                      device=dev) for _ in range(4))
    dspec = torch.empty((B, S, C), dtype=torch.float32, device=dev) \
        if want_dspec else None
    coef = packed_coeffs(max_degree, dev)
    with torch.cuda.device(dev):
        rc = _lib().wigner_block_bwd(
            t.data_ptr(), ca.data_ptr(), sa.data_ptr(), cg.data_ptr(),
            sg.data_ptr(), spec.data_ptr(), dout.data_ptr(), coef.data_ptr(),
            dt.data_ptr(), dca.data_ptr(), dsa.data_ptr(), dcg.data_ptr(),
            dsg.data_ptr(), dspec.data_ptr() if want_dspec else None,
            B, max_degree, C, int(spec.dim() == 3), int(transpose),
            torch.cuda.current_stream().cuda_stream)
    _check(rc, "wigner_block_bwd", B, max_degree, C)
    block_wigner_matrix_multiply_pallas.launches_backward += 1
    return dt, dca, dsa, dcg, dsg, dspec


class _WignerBlock(torch.autograd.Function):
    """W(t, ca, sa, cg, sg) @ spec: forward K5, backward K6. For a shared
    (S, C) spectrum d spec is the per-sample dspec summed over the batch
    after the kernel (``torch.sum``: deterministic), the transpose of the
    broadcast."""

    @staticmethod
    def forward(ctx, t, ca, sa, cg, sg, spec, max_degree, transpose):
        ctx.save_for_backward(t, ca, sa, cg, sg, spec)
        ctx.max_degree, ctx.transpose = max_degree, transpose
        return _launch(t, ca, sa, cg, sg, spec, max_degree, transpose)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        t, ca, sa, cg, sg, spec = ctx.saved_tensors
        want_dspec = ctx.needs_input_grad[5]
        *grads, dspec = _launch_backward(t, ca, sa, cg, sg, spec,
                                         dout.contiguous(), ctx.max_degree,
                                         ctx.transpose, want_dspec)
        if want_dspec and spec.dim() == 2:
            dspec = dspec.sum(0)
        return (*grads, dspec, None, None)


def block_wigner_matrix_multiply_pallas(angles, spectrum, max_degree,
                                        transpose=False):
    """W(angles) @ spectrum, (B, 3) x [(S, C) | (B, S, C)] -> (B, S, C),
    through the :func:`trig_features` of the angles, as the JAX package's
    function of the same name.

    CUDA tensors go through the kernels (float32, contiguous; anything else
    raises): each launch of K5 adds one to
    ``block_wigner_matrix_multiply_pallas.launches`` and, when the angles or
    the spectrum need a gradient, the backward is K6 (one to
    ``.launches_backward``). CPU tensors take :func:`wigner_block_apply_plain`
    in the spectrum's dtype. Any batch B >= 1 is taken as it is (the JAX
    function pads it to a multiple of its block).
    """
    cpu = angles.device.type == "cpu" and spectrum.device.type == "cpu"
    if not cpu and (angles.device.type != "cuda"
                    or spectrum.device != angles.device):
        raise ValueError(f"angles on {angles.device} and spectrum on "
                         f"{spectrum.device}: both must be on one CUDA "
                         "device, or both on the CPU")
    L = max_degree
    S = (L + 1) ** 2
    if angles.dim() != 2 or angles.shape[1] != 3:
        raise ValueError(f"angles must be (B, 3), got {tuple(angles.shape)}")
    if spectrum.dim() not in (2, 3) or spectrum.shape[-2] != S or (
            spectrum.dim() == 3 and spectrum.shape[0] != angles.shape[0]):
        raise ValueError(f"spectrum must be ({S}, C) or ({angles.shape[0]}, "
                         f"{S}, C), got {tuple(spectrum.shape)}")
    if not cpu:
        for name, x in (("angles", angles), ("spectrum", spectrum)):
            if x.dtype != torch.float32 or not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous float32, got "
                                 f"{x.dtype}, contiguous={x.is_contiguous()}")
    if angles.shape[0] == 0:
        return spectrum.new_empty((0, S, spectrum.shape[-1]))
    t, ca, sa, cg, sg = trig_features(angles.to(spectrum.dtype), L)
    if cpu:
        return wigner_block_apply_plain(t, ca, sa, cg, sg, spectrum, L,
                                        transpose=transpose)
    if torch.is_grad_enabled() and (angles.requires_grad
                                    or spectrum.requires_grad):
        return _WignerBlock.apply(t, ca, sa, cg, sg, spectrum, L,
                                  bool(transpose))
    return _launch(t, ca, sa, cg, sg, spectrum, L, bool(transpose))


block_wigner_matrix_multiply_pallas.launches = 0
block_wigner_matrix_multiply_pallas.launches_backward = 0
