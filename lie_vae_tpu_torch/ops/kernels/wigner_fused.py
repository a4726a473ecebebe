"""The block-Wigner chain and its backward as hand-written CUDA kernels.

``csrc/wigner_chain.cu`` computes out = Z(a) J Z(b) J Z(g) x per sample,
the group action of the action decoder, with or without the residuals
y = J Z(g) x and z = J Z(b) y, and the backward: dx and the angle
gradients from the cotangent of out. It replaces the TPU kernel
``_chain_kernel`` of the JAX package's ``ops/kernels/wigner_fused.py``
(``:127``; without residuals through ``_plain_kernel``, ``:158``, call
``:208``, for inference: K1; with them, call ``:194``, for training: K2's
forward) and that kernel's custom-VJP backward ``op_bwd`` (``:240-261``:
K2's backward).

On an H100 the chain is bound by the bytes it moves: per sample (L = 6,
C = 10) K1 writes 1960 B, K2's forward 5880 B, and K2's backward reads
5880 B and writes 1960 B. K1 does about 12 float32 operations per byte
with dense J products and 5 with J's zeros skipped (K2 fewer), against
the card's 20 per byte outside the tensor cores. So the kernels use no
tensor cores (TF32's 3 digits would also break their 1e-5 tolerance). The chain is
block-diagonal by degree, and the design follows: one thread per column
(sample b, degree l, channel c) keeps its 2l+1 values in registers through
every pass; blocks hold one degree, heaviest first; J_0 .. J_16 sit in
constant memory (``j_table``, loaded once per device) and only the entries
``j_coupled`` allows are multiplied; the backward sums each sample's
column terms in a fixed order in two passes, with no atomics, so a run
repeats bit for bit. The source's head note has the details.

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

__all__ = ["block_wigner_matrix_multiply_fused", "j_coupled", "j_table",
           "packed_j", "MAX_DEGREE"]

MAX_DEGREE = 16      # the degrees the kernels take (ops/jd_tables.npz)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(_build.build("wigner_chain"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wigner_chain_load_j.argtypes = [ptr, i32]
    lib.wigner_chain_fwd.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.wigner_chain_fwd_res.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.wigner_chain_bwd.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.wigner_chain_bwd_slots.argtypes = [i32, i32]
    for fn in (lib.wigner_chain_load_j, lib.wigner_chain_fwd,
               lib.wigner_chain_fwd_res, lib.wigner_chain_bwd,
               lib.wigner_chain_bwd_slots):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _lib_on(device):
    """The library, with ``j_table()`` in ``device``'s constant memory."""
    lib = _lib()
    table = j_table()
    with torch.cuda.device(device):
        rc = lib.wigner_chain_load_j(table.ctypes.data, table.size)
    if rc != 0:
        raise RuntimeError(f"wigner_chain_load_j failed: CUDA error {rc}")
    return lib


@functools.lru_cache(maxsize=None)
def j_table(dtype=np.float32):
    """J_0 .. J_16, each row-major, concatenated: J_l starts at
    l (4 l^2 - 1) / 3, 6545 values in host memory. In float32 it is what
    the kernels hold in constant memory."""
    return np.concatenate([j_matrix(l).reshape(-1)
                           for l in range(MAX_DEGREE + 1)]).astype(dtype)


@functools.lru_cache(maxsize=None)
def packed_j(max_degree, device):
    """J_0 .. J_L of ``j_table``: float32 on ``device``,
    (L+1)(4(L+1)^2 - 1)/3 values (455 for L = 6)."""
    n = (max_degree + 1) * (4 * (max_degree + 1) ** 2 - 1) // 3
    return torch.as_tensor(j_table()[:n], device=device)


def j_coupled(l, i, k):
    """Whether the kernels multiply J_l[i, k]: the twin of the source's
    ``j_coupled``. Row i has frequency f = l - i; with s = (f > 0) and
    p = (f odd), J_l couples i and k only where s ^ p agree, and their
    signs s then agree exactly where s ^ p equals l's parity. Every other
    entry of every table is 0 up to the tables' rounding (tested), so the
    kernels skip it."""
    fi, fk = l - i, l - k
    qi = (fi > 0) != bool(fi & 1)
    qk = (fk > 0) != bool(fk & 1)
    return qi == qk and (((fi > 0) == (fk > 0)) == (qi == bool(l & 1)))


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
    lib = _lib_on(angles.device)
    with torch.cuda.device(angles.device):
        rc = lib.wigner_chain_fwd(
            angles.data_ptr(), spectrum.data_ptr(), out.data_ptr(), B,
            max_degree, C, int(spectrum.dim() == 3), _stream())
    _check(rc, "wigner_chain_fwd", B, max_degree, C)
    block_wigner_matrix_multiply_fused.launches += 1
    return out


def _launch_residuals(angles, spectrum, max_degree):
    """K2 forward: out and the residuals y = J Z(g) x, z = J Z(b) y."""
    B, S = angles.shape[0], (max_degree + 1) ** 2
    C = spectrum.shape[-1]
    out, y, z = (torch.empty((B, S, C), dtype=torch.float32,
                             device=angles.device) for _ in range(3))
    lib = _lib_on(angles.device)
    with torch.cuda.device(angles.device):
        rc = lib.wigner_chain_fwd_res(
            angles.data_ptr(), spectrum.data_ptr(), out.data_ptr(),
            y.data_ptr(), z.data_ptr(), B, max_degree, C,
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
    lib = _lib_on(dev)
    slots = lib.wigner_chain_bwd_slots(max_degree, C)
    if slots == 0:
        raise ValueError(f"wigner_chain_bwd takes no degree L={max_degree} "
                         f"with C={C}")
    # each sample's column sums by degree and channel tile, added in order
    partial = torch.empty((slots, B, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.wigner_chain_bwd(
            angles.data_ptr(), spectrum.data_ptr(), y.data_ptr(),
            z.data_ptr(), dout.data_ptr(),
            dx.data_ptr() if want_dx else None, dangles.data_ptr(),
            partial.data_ptr(), B, max_degree, C, int(spectrum.dim() == 3),
            _stream())
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
    if not 0 <= max_degree <= MAX_DEGREE:
        raise ValueError(f"the chain kernels take degrees 0 to {MAX_DEGREE}, "
                         f"not {max_degree}")
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
