"""The forward block-Wigner chain as a hand-written CUDA kernel.

``csrc/wigner_chain.cu`` computes out = Z(a) J Z(b) J Z(g) x per sample:
the group action of the action decoder. It replaces the TPU kernel
``_chain_kernel`` of the JAX package's ``ops/kernels/wigner_fused.py``
(forward, without residuals); the source says how the design differs and
what bounds it on an H100. :func:`block_wigner_matrix_multiply_fused`
launches it for CUDA tensors and runs the plain chain
(:func:`~lie_vae_tpu_torch.ops.wigner.block_wigner_apply_zjz`) for CPU
tensors. It has no backward: training needs one (ROADMAP.md, kernel K2).
"""
import ctypes
import functools

import numpy as np
import torch

from lie_vae_tpu_torch.ops.kernels import _build
from lie_vae_tpu_torch.ops.wigner import block_wigner_apply_zjz, j_matrix

__all__ = ["block_wigner_matrix_multiply_fused", "packed_j"]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(_build.build("wigner_chain"))
    fn = lib.wigner_chain_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def packed_j(max_degree, device):
    """J_0 .. J_L, each row-major, concatenated: float32 on ``device``,
    (L+1)(4(L+1)^2 - 1)/3 values (455 for L = 6)."""
    flat = np.concatenate([j_matrix(l).reshape(-1)
                           for l in range(max_degree + 1)])
    return torch.as_tensor(flat, dtype=torch.float32, device=device)


def _launch(angles, spectrum, max_degree):
    B, S = angles.shape[0], (max_degree + 1) ** 2
    C = spectrum.shape[-1]
    out = torch.empty((B, S, C), dtype=torch.float32, device=angles.device)
    jp = packed_j(max_degree, angles.device)
    with torch.cuda.device(angles.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().wigner_chain_fwd(
            angles.data_ptr(), spectrum.data_ptr(), jp.data_ptr(),
            out.data_ptr(), B, max_degree, C, int(spectrum.dim() == 3),
            stream)
    if rc != 0:
        raise RuntimeError(f"wigner_chain_fwd failed: CUDA error {rc} "
                           f"(B={B}, L={max_degree}, C={C})")
    block_wigner_matrix_multiply_fused.launches += 1
    return out


def block_wigner_matrix_multiply_fused(angles, spectrum, max_degree,
                                       transpose=False):
    """W(angles) @ spectrum, (B, 3) x [(S, C) | (B, S, C)] -> (B, S, C).

    CUDA tensors go through the kernel (float32, contiguous; anything else
    raises), CPU tensors through the plain chain. ``transpose`` applies
    W^T, the chain at angles (-g, -b, -a). Each kernel launch adds one to
    ``block_wigner_matrix_multiply_fused.launches``.
    """
    if angles.device.type == "cpu" and spectrum.device.type == "cpu":
        return block_wigner_apply_zjz(angles, spectrum, max_degree,
                                      transpose=transpose)
    if angles.device.type != "cuda" or spectrum.device != angles.device:
        raise ValueError(f"angles on {angles.device} and spectrum on "
                         f"{spectrum.device}: both must be on one CUDA "
                         "device, or both on the CPU")
    if torch.is_grad_enabled() and (angles.requires_grad
                                    or spectrum.requires_grad):
        raise NotImplementedError(
            "the Wigner chain kernel has no backward yet (ROADMAP.md, "
            "kernel K2, with the training step); call it under "
            "torch.no_grad() or torch.inference_mode()")
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
    return _launch(angles, spectrum, max_degree)


block_wigner_matrix_multiply_fused.launches = 0
