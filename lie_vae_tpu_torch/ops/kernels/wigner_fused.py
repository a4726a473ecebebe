"""The block-Wigner chain and its backward as hand-written CUDA kernels.

``csrc/wigner_chain.cu`` computes out = Z(a) J Z(b) J Z(g) x per sample,
the group action of the action decoder, with or without the residuals
y = J Z(g) x and z = J Z(b) y, and the backward: dx and the angle
gradients from the cotangent of out. It replaces the TPU kernel
``_chain_kernel`` of the JAX package's ``ops/kernels/wigner_fused.py``
(without residuals for inference, with them for training) and that
kernel's custom-VJP backward ``op_bwd``; the source says how the design
differs and what bounds it on an H100.
:func:`block_wigner_matrix_multiply_fused` launches them for CUDA tensors
(the backward through a ``torch.autograd.Function``) and runs the plain
chain (:func:`~lie_vae_tpu_torch.ops.wigner.block_wigner_apply_zjz`) for
CPU tensors, where autograd differentiates it.
"""
import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from lie_vae_tpu_torch.ops.kernels import _build
from lie_vae_tpu_torch.ops.wigner import block_wigner_apply_zjz, j_matrix

__all__ = ["block_wigner_matrix_multiply_fused", "packed_j"]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(_build.build("wigner_chain"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wigner_chain_fwd.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.wigner_chain_fwd_res.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.wigner_chain_bwd.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
    lib.wigner_chain_bwd_tiles.argtypes = [i32, i32]
    for fn in (lib.wigner_chain_fwd, lib.wigner_chain_fwd_res,
               lib.wigner_chain_bwd, lib.wigner_chain_bwd_tiles):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def packed_j(max_degree, device):
    """J_0 .. J_L, each row-major, concatenated: float32 on ``device``,
    (L+1)(4(L+1)^2 - 1)/3 values (455 for L = 6)."""
    flat = np.concatenate([j_matrix(l).reshape(-1)
                           for l in range(max_degree + 1)])
    return torch.as_tensor(flat, dtype=torch.float32, device=device)


def _check(rc, name, B, L, C):
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} (B={B}, L={L}, "
                           f"C={C})")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _launch(angles, spectrum, max_degree):
    """K1: out = W(angles) spectrum, no residuals."""
    B, S = angles.shape[0], (max_degree + 1) ** 2
    C = spectrum.shape[-1]
    out = torch.empty((B, S, C), dtype=torch.float32, device=angles.device)
    jp = packed_j(max_degree, angles.device)
    with torch.cuda.device(angles.device):
        rc = _lib().wigner_chain_fwd(
            angles.data_ptr(), spectrum.data_ptr(), jp.data_ptr(),
            out.data_ptr(), B, max_degree, C, int(spectrum.dim() == 3),
            _stream())
    _check(rc, "wigner_chain_fwd", B, max_degree, C)
    block_wigner_matrix_multiply_fused.launches += 1
    return out


def _launch_residuals(angles, spectrum, max_degree):
    """K2 forward: out and the residuals y = J Z(g) x, z = J Z(b) y."""
    B, S = angles.shape[0], (max_degree + 1) ** 2
    C = spectrum.shape[-1]
    out, y, z = (torch.empty((B, S, C), dtype=torch.float32,
                             device=angles.device) for _ in range(3))
    jp = packed_j(max_degree, angles.device)
    with torch.cuda.device(angles.device):
        rc = _lib().wigner_chain_fwd_res(
            angles.data_ptr(), spectrum.data_ptr(), jp.data_ptr(),
            out.data_ptr(), y.data_ptr(), z.data_ptr(), B, max_degree, C,
            int(spectrum.dim() == 3), _stream())
    _check(rc, "wigner_chain_fwd_res", B, max_degree, C)
    block_wigner_matrix_multiply_fused.launches_residuals += 1
    return out, y, z


def _launch_backward(angles, spectrum, y, z, dout, max_degree, want_dx):
    """K2 backward: from the cotangent dout of out, (dx per sample
    (B, S, C) or None, dangles (B, 3))."""
    B, S = angles.shape[0], (max_degree + 1) ** 2
    C = spectrum.shape[-1]
    dev = angles.device
    dx = torch.empty((B, S, C), dtype=torch.float32, device=dev) \
        if want_dx else None
    dangles = torch.empty((B, 3), dtype=torch.float32, device=dev)
    lib = _lib()
    tiles = lib.wigner_chain_bwd_tiles(max_degree, C)
    if tiles == 0:
        raise ValueError(f"wigner_chain_bwd takes no degree L={max_degree}")
    partial = torch.empty((B, tiles, 3), dtype=torch.float32, device=dev) \
        if tiles > 1 else None
    jp = packed_j(max_degree, dev)
    with torch.cuda.device(dev):
        rc = lib.wigner_chain_bwd(
            angles.data_ptr(), spectrum.data_ptr(), jp.data_ptr(),
            y.data_ptr(), z.data_ptr(), dout.data_ptr(),
            dx.data_ptr() if want_dx else None, dangles.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            B, max_degree, C, int(spectrum.dim() == 3), _stream())
    _check(rc, "wigner_chain_bwd", B, max_degree, C)
    block_wigner_matrix_multiply_fused.launches_backward += 1
    return dx, dangles


class _WignerChain(torch.autograd.Function):
    """W(angles) @ spectrum over the angles of the chain it runs (the
    transpose's flip happens before, where autograd carries it). Forward K2
    with residuals, backward the K2 backward kernel. For a shared (S, C)
    spectrum d spectrum is the per-sample dx summed over the batch after
    the kernel (``torch.sum``: deterministic), the transpose of the
    broadcast."""

    @staticmethod
    def forward(ctx, angles, spectrum, max_degree):
        out, y, z = _launch_residuals(angles, spectrum, max_degree)
        ctx.save_for_backward(angles, spectrum, y, z)
        ctx.max_degree = max_degree
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        angles, spectrum, y, z = ctx.saved_tensors
        want_dx = ctx.needs_input_grad[1]
        dx, dangles = _launch_backward(angles, spectrum, y, z,
                                       dout.contiguous(), ctx.max_degree,
                                       want_dx)
        if want_dx and spectrum.dim() == 2:
            dx = dx.sum(0)
        return dangles, dx, None


def block_wigner_matrix_multiply_fused(angles, spectrum, max_degree,
                                       transpose=False):
    """W(angles) @ spectrum, (B, 3) x [(S, C) | (B, S, C)] -> (B, S, C).

    CUDA tensors go through the kernels (float32, contiguous; anything
    else raises), CPU tensors through the plain chain. ``transpose`` applies
    W^T, the chain at angles (-g, -b, -a). Without a gradient to take, the
    forward kernel runs without residuals (K1) and adds one to
    ``block_wigner_matrix_multiply_fused.launches``; when the angles or the
    spectrum need a gradient, the forward writes the residuals (adding one
    to ``.launches_residuals``) and the backward is the backward kernel
    (one to ``.launches_backward``).
    """
    if angles.device.type == "cpu" and spectrum.device.type == "cpu":
        return block_wigner_apply_zjz(angles, spectrum, max_degree,
                                      transpose=transpose)
    if angles.device.type != "cuda" or spectrum.device != angles.device:
        raise ValueError(f"angles on {angles.device} and spectrum on "
                         f"{spectrum.device}: both must be on one CUDA "
                         "device, or both on the CPU")
    S = (max_degree + 1) ** 2
    if angles.dim() != 2 or angles.shape[1] != 3:
        raise ValueError(f"angles must be (B, 3), got {tuple(angles.shape)}")
    if spectrum.dim() not in (2, 3) or spectrum.shape[-2] != S or (
            spectrum.dim() == 3 and spectrum.shape[0] != angles.shape[0]):
        raise ValueError(f"spectrum must be ({S}, C) or ({angles.shape[0]}, "
                         f"{S}, C), got {tuple(spectrum.shape)}")
    for name, t in (("angles", angles), ("spectrum", spectrum)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    if angles.shape[0] == 0:
        return spectrum.new_empty((0, S, spectrum.shape[-1]))
    if transpose:
        angles = -angles.flip(-1)
    if torch.is_grad_enabled() and (angles.requires_grad
                                    or spectrum.requires_grad):
        return _WignerChain.apply(angles, spectrum, max_degree)
    return _launch(angles, spectrum, max_degree)


block_wigner_matrix_multiply_fused.launches = 0
block_wigner_matrix_multiply_fused.launches_residuals = 0
block_wigner_matrix_multiply_fused.launches_backward = 0
