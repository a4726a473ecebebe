"""Real Wigner-D matrices and the block-diagonal group action, in PyTorch.

Counterpart of ``lie_vae_tpu/ops/wigner.py``. Per degree l the real
Wigner-D block is the Pinchon-Hoggan chain ``D^l = Z(a) J_l Z(b) J_l Z(g)``:
``J_l`` a constant symmetric involution (tables in ``jd_tables.npz``, a
copy of the JAX package's asset) and ``Z(t)`` the sparse real z-rotation,
``(Z(t) x)_i = cos(f_i t) x_i + sin(f_i t) x_rev(i)`` with row frequency
``f_i`` and ``rev`` the reversal within the degree block.

- :func:`block_wigner_matrix` builds the dense (B, S, S) matrix, and
  :func:`wigner_d_matrix` one degree's block of it;
- :func:`block_wigner_apply_zjz` applies the chain to a spectrum without
  forming W, and is the plain version the CUDA kernel is held against;
- :func:`block_wigner_matrix_multiply` dispatches between them and the
  kernels (``ops/kernels/wigner_fused.py``, ``ops/kernels/wigner_block.py``).
"""
import functools
import os

import numpy as np
import torch

__all__ = [
    "j_matrix", "z_rot_mat", "block_wigner_matrix", "wigner_d_matrix",
    "block_wigner_apply_zjz", "block_wigner_matrix_multiply",
]

_TABLE_PATH = os.path.join(os.path.dirname(__file__), "jd_tables.npz")


@functools.lru_cache(maxsize=1)
def _tables():
    with np.load(_TABLE_PATH) as data:
        lmax = int(data["lmax"])
        return [np.asarray(data[f"J{l}"], dtype=np.float64)
                for l in range(lmax + 1)]


def j_matrix(l):
    """The constant Pinchon-Hoggan J block of degree l, float64 numpy."""
    tables = _tables()
    if l >= len(tables):
        raise ValueError(f"degree {l} exceeds the tables' lmax="
                         f"{len(tables) - 1}")
    return tables[l]


def z_rot_mat(angle, l):
    """Real z-rotation block (B, 2l+1, 2l+1): row i has frequency l - i,
    cos on the diagonal and sin on the anti-diagonal."""
    freqs = torch.arange(l, -l - 1, -1, dtype=angle.dtype,
                         device=angle.device)
    c = torch.cos(freqs * angle[:, None])
    s = torch.sin(freqs * angle[:, None])
    eye = torch.eye(2 * l + 1, dtype=angle.dtype, device=angle.device)
    return c[:, :, None] * eye + s[:, :, None] * eye.flip(0)


@functools.lru_cache(maxsize=32)
def _coeffs(max_degree):
    """(freqs, rev, C) for the packed block-diagonal representation.

    freqs (S,) row frequencies; rev (S,) block-local reversal; C
    (2L+1, S, S) float64 with the cos(m b) coefficient matrix at index m
    and the sin(m b) one at L + m, so that J Z(b) J = sum_m t_m(b) C_m.
    """
    L = max_degree
    S = (L + 1) ** 2
    freqs = np.concatenate(
        [np.arange(l, -l - 1, -1) for l in range(L + 1)]).astype(np.float64)
    rev = np.concatenate(
        [np.arange(2 * l, -1, -1) + l * l for l in range(L + 1)]
    ).astype(np.int64)
    C = np.zeros((2 * L + 1, S, S), dtype=np.float64)
    for l in range(L + 1):
        J = j_matrix(l)
        o = l * l
        for c in range(2 * l + 1):
            fc = l - c
            m = abs(fc)
            C[m, o:o + 2 * l + 1, o:o + 2 * l + 1] += np.outer(J[:, c], J[c, :])
            if fc != 0:
                C[L + m, o:o + 2 * l + 1, o:o + 2 * l + 1] += \
                    -np.sign(fc) * np.outer(J[:, 2 * l - c], J[c, :])
    return freqs, rev, C


@functools.lru_cache(maxsize=32)
def _block_j(max_degree):
    """Constant block-diagonal J = diag(J_0 .. J_L), (S, S) float64."""
    S = (max_degree + 1) ** 2
    J = np.zeros((S, S), dtype=np.float64)
    for l in range(max_degree + 1):
        o = l * l
        J[o:o + 2 * l + 1, o:o + 2 * l + 1] = j_matrix(l)
    return J


def _trig_basis(beta, L):
    """(B, 2L+1): [cos(0 b) .. cos(L b), sin(1 b) .. sin(L b)]."""
    m = torch.arange(0, L + 1, dtype=beta.dtype, device=beta.device)
    arg = beta[:, None] * m[None, :]
    return torch.cat([torch.cos(arg), torch.sin(arg[:, 1:])], dim=-1)


def block_wigner_matrix(angles, max_degree, dtype=None):
    """Dense block-diagonal real Wigner-D matrix, (..., S, S)."""
    if angles.shape[-1] != 3:
        raise ValueError("angles must be (..., 3) ZYZ Euler angles")
    batch_shape = angles.shape[:-1]
    dtype = dtype or angles.dtype
    angles = angles.reshape(-1, 3).to(dtype)
    dev = angles.device
    L = max_degree
    freqs_np, rev_np, C_np = _coeffs(L)
    freqs = torch.as_tensor(freqs_np, dtype=dtype, device=dev)
    rev = torch.as_tensor(rev_np, device=dev)
    C = torch.as_tensor(C_np, dtype=dtype, device=dev)

    a, b, g = angles.unbind(-1)
    d = torch.einsum("bm,mse->bse", _trig_basis(b, L), C)        # (B, S, S)
    ca, sa = torch.cos(freqs * a[:, None]), torch.sin(freqs * a[:, None])
    tmp = ca[:, :, None] * d + sa[:, :, None] * d[:, rev, :]
    cg, sg = torch.cos(freqs * g[:, None]), torch.sin(freqs * g[:, None])
    W = tmp * cg[:, None, :] - tmp[:, :, rev] * sg[:, None, :]
    S = (L + 1) ** 2
    return W.reshape(batch_shape + (S, S))


def wigner_d_matrix(angles, degree, dtype=None):
    """Single-degree real Wigner-D block, (..., 2l+1, 2l+1): the degree-l
    diagonal block of :func:`block_wigner_matrix`, the chain
    Z(a) J Z(b) J Z(g) (lie_vae/lie_tools.py:211-223), by trig synthesis."""
    if angles.shape[-1] != 3:
        raise ValueError("angles must be (..., 3) ZYZ Euler angles")
    batch_shape = angles.shape[:-1]
    dtype = dtype or angles.dtype
    angles = angles.reshape(-1, 3).to(dtype)
    dev = angles.device
    l, dim, o = degree, 2 * degree + 1, degree * degree
    # the degree-l coefficients are the degree-l diagonal block of the
    # packed tensor (the same m-basis when max_degree == l)
    C = torch.as_tensor(_coeffs(l)[2][:, o:o + dim, o:o + dim], dtype=dtype,
                        device=dev)
    freqs = torch.arange(l, -l - 1, -1, dtype=dtype, device=dev)
    rev = torch.arange(dim - 1, -1, -1, device=dev)

    a, b, g = angles.unbind(-1)
    d = torch.einsum("bm,mse->bse", _trig_basis(b, l), C)
    ca, sa = torch.cos(freqs * a[:, None]), torch.sin(freqs * a[:, None])
    tmp = ca[:, :, None] * d + sa[:, :, None] * d[:, rev, :]
    cg, sg = torch.cos(freqs * g[:, None]), torch.sin(freqs * g[:, None])
    W = tmp * cg[:, None, :] - tmp[:, :, rev] * sg[:, None, :]
    return W.reshape(batch_shape + (dim, dim))


def block_wigner_apply_zjz(angles, spectrum, max_degree, transpose=False):
    """W(angles) @ spectrum without forming W: the chain
    Z(a) J Z(b) J Z(g) applied right to left.

    angles (B, 3) ZYZ; spectrum shared (S, C) or per-sample (B, S, C);
    returns (B, S, C) in the spectrum's dtype. ``transpose=True`` applies
    W^T, which is the same chain at angles (-g, -b, -a).
    """
    angles = angles.reshape(-1, 3)
    dtype, dev = spectrum.dtype, spectrum.device
    L = max_degree
    S = (L + 1) ** 2
    if spectrum.shape[-2] != S:
        raise ValueError(f"spectrum rows {spectrum.shape[-2]} != (L+1)^2 = {S}")
    freqs_np, rev_np, _ = _coeffs(L)
    freqs = torch.as_tensor(freqs_np, dtype=dtype, device=dev)
    rev = torch.as_tensor(rev_np, device=dev)
    J = torch.as_tensor(_block_j(L), dtype=dtype, device=dev)

    a, b, g = angles.to(dtype).unbind(-1)
    if transpose:
        a, b, g = -g, -b, -a

    def zmul(theta, x):
        c = torch.cos(freqs * theta[:, None])[:, :, None]
        s = torch.sin(freqs * theta[:, None])[:, :, None]
        return c * x + s * x[..., rev, :]

    def jmul(x):
        return torch.einsum("se,bec->bsc", J, x)

    # Z(g) of a shared spectrum broadcasts it over the batch here
    return zmul(a, jmul(zmul(b, jmul(zmul(g, spectrum)))))


def block_wigner_matrix_multiply(angles, spectrum, max_degree,
                                 transpose=False, impl="auto"):
    """Rotate a direct-sum spectrum by the group elements given as ZYZ
    angles: (B, 3) x [(S, C) | (B, S, C)] -> (B, S, C).

    impl: 'fused' (the chain kernels K1/K2 on a CUDA tensor, the plain
    chain on a CPU tensor) | 'auto' (the same routing) | 'pallas' (the
    synthesise-then-apply kernels K5/K6 on a CUDA tensor, their plain
    version on a CPU tensor) | 'zjz' or its alias 'xla' (the plain chain) |
    'dense' (form W, then one batched product).
    """
    if impl not in ("fused", "auto", "pallas", "zjz", "xla", "dense"):
        raise ValueError(f"unknown wigner impl {impl!r} (expected 'fused', "
                         "'auto', 'pallas', 'zjz', 'xla' or 'dense')")
    if impl in ("fused", "auto"):
        from lie_vae_tpu_torch.ops.kernels.wigner_fused import (
            block_wigner_matrix_multiply_fused)
        return block_wigner_matrix_multiply_fused(
            angles, spectrum, max_degree, transpose=transpose)
    if impl == "pallas":
        from lie_vae_tpu_torch.ops.kernels.wigner_block import (
            block_wigner_matrix_multiply_pallas)
        return block_wigner_matrix_multiply_pallas(
            angles, spectrum, max_degree, transpose=transpose)
    if impl in ("zjz", "xla"):
        return block_wigner_apply_zjz(angles, spectrum, max_degree,
                                      transpose=transpose)
    W = block_wigner_matrix(angles, max_degree, dtype=spectrum.dtype)
    if transpose:
        W = W.transpose(-1, -2)
    if spectrum.dim() == 2:
        return torch.einsum("bse,ec->bsc", W, spectrum)
    return torch.einsum("bse,bec->bsc", W, spectrum)
