"""The per-sample synthesise-then-apply Wigner product and its backward as
hand-written CUDA kernels.

``csrc/wigner_block.cu`` computes out[b] = W(angles[b]) @ spec[b] from the
angles and the Fourier coefficients of the middle factor, d(beta) =
sum_m t_m(beta) C_m, without writing W to memory, and the backward: the
gradients of the angles and of the spectrum. It replaces the TPU kernels
``_wigner_apply_kernel`` (K5) and ``_wigner_bwd_kernel`` (K6) of the JAX
package's ``ops/kernels/wigner_block.py``; the source says how the design
differs and what bounds it on an H100.

The kernels run one thread per (sample, degree, channel) column: u = Z(g) x,
w = d(b) u, out = Z(a) w, with the trig features formed inside the kernel
and d u summed over the coefficients that can be non-zero only, read from
a table (:func:`c_table`, in constant memory up to degree 14) whose layout
:func:`coupled_blocks` describes.

:func:`block_wigner_matrix_multiply_pallas` (the JAX name; it is the path of
``impl='pallas'``) launches them for CUDA tensors (the backward through a
``torch.autograd.Function``) and runs the plain version,
:func:`trig_features` then :func:`wigner_block_apply_plain`, for CPU
tensors, where autograd differentiates it.
"""
import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from lie_vae_tpu_torch.ops.kernels import _build
from lie_vae_tpu_torch.ops.kernels.wigner_fused import MAX_DEGREE
from lie_vae_tpu_torch.ops.wigner import _coeffs, _trig_basis

__all__ = ["block_wigner_matrix_multiply_pallas", "wigner_block_apply_plain",
           "trig_features", "coupled_blocks", "c_table", "c_offset",
           "MAX_DEGREE", "CONST_DEGREE"]

CONST_DEGREE = 14    # the table's degrees the kernels hold in constant memory


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(_build.build("wigner_block"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wigner_block_load_coeffs.argtypes = [ptr, i32]
    lib.wigner_block_fwd.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
    lib.wigner_block_bwd.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.wigner_block_bwd_slots.argtypes = [i32, i32]
    for fn in (lib.wigner_block_load_coeffs, lib.wigner_block_fwd,
               lib.wigner_block_bwd, lib.wigner_block_bwd_slots):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _lib_on(device):
    """The library, with :func:`c_table` in ``device``'s memory."""
    lib = _lib()
    table = c_table()
    with torch.cuda.device(device):
        rc = lib.wigner_block_load_coeffs(table.ctypes.data, table.size)
    if rc != 0:
        raise RuntimeError(f"wigner_block_load_coeffs failed: CUDA error {rc}")
    return lib


@functools.lru_cache(maxsize=32)
def _kernel_coeffs(max_degree):
    """The four block-reversed coefficient tensors C, C[rev, :], C[:, rev],
    C[rev, rev], each (2L+1, S, S) float64 numpy."""
    _, rev, C = _coeffs(max_degree)
    return C, C[:, rev, :], C[:, :, rev], C[:, rev, :][:, :, rev]


@functools.lru_cache(maxsize=32)
def _packed_coeffs_np(max_degree):
    """C's diagonal blocks packed: per degree l, its 2l+1 frequencies
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


def _group_rows(l, g):
    """Local rows of group g = 2 (f <= 0) + (|f| odd) of degree l, f = l - p
    the frequency of row p, ascending."""
    return [p for p in range(2 * l + 1)
            if 2 * (l - p <= 0) + abs(l - p) % 2 == g]


def _partner(l, g):
    """The group J_l couples group g to (the source's ``partner``)."""
    keep = ((g < 2) == (g % 2 == 1)) != (l % 2 == 1)
    return g if keep else g ^ 3


def coupled_blocks(l, s):
    """The blocks of slot s of degree l (cos(m b), m = s, for s <= l, else
    sin(m b), m = s - l) whose coefficients can be non-zero, as the kernels
    walk them: a list of (rows, cols) of local rows, each block dense, the
    table holding it row-major. Slot 0 has one block, the others two: for
    c with f_c = +m and f_c = -m, rows and columns coupled by J_l to c
    (cosine), or rows coupled to rev c and columns to c (sine)."""
    m = s if s <= l else s - l
    if m == 0:
        g = _partner(l, 2)
        return [(_group_rows(l, g), _group_rows(l, g))]
    plus, minus = m % 2, 2 + m % 2
    rows = (plus, minus) if s <= l else (minus, plus)
    return [(_group_rows(l, _partner(l, r)), _group_rows(l, _partner(l, c)))
            for r, c in zip(rows, (plus, minus))]


@functools.lru_cache(maxsize=None)
def _table_sizes():
    return [sum(len(r) * len(c) for s in range(2 * l + 1)
                for r, c in coupled_blocks(l, s))
            for l in range(MAX_DEGREE + 1)]


def c_offset(l):
    """First entry of degree l in :func:`c_table`; ``c_offset(L + 1)`` is
    the count of coefficients the kernels read for degrees up to L (597
    for L = 6)."""
    return sum(_table_sizes()[:l])


@functools.lru_cache(maxsize=None)
def c_table(dtype=np.float32):
    """The coefficients of degrees 0 .. 16 that can be non-zero, in the
    order the kernels read them: degree by degree, slot by slot, block by
    block of :func:`coupled_blocks`, row-major in each block (20617
    values in host memory). In float32 it is what the kernels hold."""
    L = MAX_DEGREE
    _, _, C = _coeffs(L)
    parts = []
    for l in range(L + 1):
        o = l * l
        for s in range(2 * l + 1):
            slot = s if s <= l else L + s - l
            for rows, cols in coupled_blocks(l, s):
                parts.append(C[slot][np.ix_([o + p for p in rows],
                                            [o + q for q in cols])]
                             .reshape(-1))
    return np.concatenate(parts).astype(dtype)


def trig_features(angles, max_degree):
    """(t, ca, sa, cg, sg) of ZYZ ``angles`` (B, 3), in their dtype: t =
    ``_trig_basis(beta)`` (B, 2L+1); ca, sa = cos, sin(f alpha) and cg, sg
    = cos, sin(f gamma) at the row frequencies f, (B, S) each. With
    :func:`wigner_block_apply_plain` it is the plain version of the
    kernels, which form these features themselves."""
    L = max_degree
    freqs = torch.as_tensor(_coeffs(L)[0], dtype=angles.dtype,
                            device=angles.device)
    a, b, g = angles.unbind(-1)
    return (_trig_basis(b, L), torch.cos(freqs * a[:, None]),
            torch.sin(freqs * a[:, None]), torch.cos(freqs * g[:, None]),
            torch.sin(freqs * g[:, None]))


def wigner_block_apply_plain(t, ca, sa, cg, sg, spec, max_degree,
                             transpose=False):
    """The plain version of the kernels, from the trig features: the four
    syntheses d = sum_m t_m C_m (and of C[rev, :], C[:, rev], C[rev, rev]),
    W = cg (ca d + sa d_row) - sg (ca d_col + sa d_both) with ca, sa scaling
    rows and cg, sg columns, then one batched product with the shared (S, C)
    or per-sample (B, S, C) spectrum (W^T with ``transpose``). Computes in
    the spectrum's dtype; autograd of it (through :func:`trig_features`) is
    the reference of the backward kernel."""
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


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _launch(angles, spec, max_degree, transpose):
    """K5: out = W(angles) spec (W^T spec with ``transpose``), (B, S, C)."""
    B, S = angles.shape[0], (max_degree + 1) ** 2
    C = spec.shape[-1]
    out = torch.empty((B, S, C), dtype=torch.float32, device=angles.device)
    lib = _lib_on(angles.device)
    with torch.cuda.device(angles.device):
        rc = lib.wigner_block_fwd(
            angles.data_ptr(), spec.data_ptr(), out.data_ptr(), B,
            max_degree, C, int(spec.dim() == 3), int(transpose), _stream())
    _check(rc, "wigner_block_fwd", B, max_degree, C)
    block_wigner_matrix_multiply_pallas.launches += 1
    return out


def _launch_backward(angles, spec, dout, max_degree, transpose, want_dspec):
    """K6: from the cotangent dout (B, S, C) of out, (dangles (B, 3), dspec
    per sample (B, S, C) or None)."""
    B, S = angles.shape[0], (max_degree + 1) ** 2
    C = spec.shape[-1]
    dev = angles.device
    dspec = torch.empty((B, S, C), dtype=torch.float32, device=dev) \
        if want_dspec else None
    dangles = torch.empty((B, 3), dtype=torch.float32, device=dev)
    lib = _lib_on(dev)
    slots = lib.wigner_block_bwd_slots(max_degree, C)
    if slots == 0:
        raise ValueError(f"wigner_block_bwd takes no degree L={max_degree} "
                         f"with C={C}")
    # each sample's column sums by degree and channel tile, added in order
    partial = torch.empty((slots, B, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.wigner_block_bwd(
            angles.data_ptr(), spec.data_ptr(), dout.data_ptr(),
            dspec.data_ptr() if want_dspec else None, dangles.data_ptr(),
            partial.data_ptr(), B, max_degree, C, int(spec.dim() == 3),
            int(transpose), _stream())
    _check(rc, "wigner_block_bwd", B, max_degree, C)
    block_wigner_matrix_multiply_pallas.launches_backward += 1
    return dangles, dspec


class _WignerBlock(torch.autograd.Function):
    """W(angles) @ spec (W^T with ``transpose``): forward K5, backward K6.
    For a shared (S, C) spectrum d spec is the per-sample dspec summed over
    the batch after the kernel (``torch.sum``: deterministic), the
    transpose of the broadcast."""

    @staticmethod
    def forward(ctx, angles, spec, max_degree, transpose):
        ctx.save_for_backward(angles, spec)
        ctx.max_degree, ctx.transpose = max_degree, transpose
        return _launch(angles, spec, max_degree, transpose)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        angles, spec = ctx.saved_tensors
        want_dspec = ctx.needs_input_grad[1]
        dangles, dspec = _launch_backward(angles, spec, dout.contiguous(),
                                          ctx.max_degree, ctx.transpose,
                                          want_dspec)
        if want_dspec and spec.dim() == 2:
            dspec = dspec.sum(0)
        return dangles, dspec, None, None


def block_wigner_matrix_multiply_pallas(angles, spectrum, max_degree,
                                        transpose=False):
    """W(angles) @ spectrum, (B, 3) x [(S, C) | (B, S, C)] -> (B, S, C), as
    the JAX package's function of the same name.

    CUDA tensors go through the kernels (float32, contiguous, degrees 0 to
    16; anything else raises), which form the trig features from the
    angles themselves: each launch of K5 adds one to
    ``block_wigner_matrix_multiply_pallas.launches`` and, when the angles or
    the spectrum need a gradient, the backward is K6 (one to
    ``.launches_backward``). CPU tensors take :func:`trig_features` and
    :func:`wigner_block_apply_plain` in the spectrum's dtype. Any batch
    B >= 1 is taken as it is (the JAX function pads it to a multiple of its
    block).
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
        if not 0 <= L <= MAX_DEGREE:
            raise ValueError(f"the kernels take degrees 0 to {MAX_DEGREE}, "
                             f"not {L}")
        for name, x in (("angles", angles), ("spectrum", spectrum)):
            if x.dtype != torch.float32 or not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous float32, got "
                                 f"{x.dtype}, contiguous={x.is_contiguous()}")
    if angles.shape[0] == 0:
        return spectrum.new_empty((0, S, spectrum.shape[-1]))
    if cpu:
        return wigner_block_apply_plain(
            *trig_features(angles.to(spectrum.dtype), L), spectrum, L,
            transpose=transpose)
    if torch.is_grad_enabled() and (angles.requires_grad
                                    or spectrum.requires_grad):
        return _WignerBlock.apply(angles, spectrum, L, bool(transpose))
    return _launch(angles, spectrum, L, bool(transpose))


block_wigner_matrix_multiply_pallas.launches = 0
block_wigner_matrix_multiply_pallas.launches_backward = 0
