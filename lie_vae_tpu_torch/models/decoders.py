"""Decoders: the group-action decoder (learned Fourier modes rotated by the
block Wigner representation of the latent pose) and the MLP baseline.

Counterpart of ``ActionDecoder`` and ``MLPDecoder`` in the JAX package's
``models/decoders.py``. With ``deconv=None`` (the toy experiment) a
decoder returns the spectrum itself, (B, (L+1)^2, C).
"""
import torch
from torch import nn

from lie_vae_tpu_torch import ops
from lie_vae_tpu_torch.models.nets import MLP


class ActionDecoder(nn.Module):
    """item_rep: learned ((degrees+1)^2, rep_copies) coefficients (standard
    normal init), or the constant ``fixed_item_rep`` held as a buffer (the
    toy fixed-spectrum experiment: no gradient is asked of the kernels for
    it). forward takes ZYZ angles (B, 3), rotates item_rep per sample with
    ``ops.block_wigner_matrix_multiply`` at ``impl=wigner_impl`` (on a CUDA
    tensor 'fused' runs the chain kernels, 'pallas' the
    synthesise-then-apply kernels; the (S, C) array goes to them as it is,
    never expanded over the batch), flattens s-major, optionally passes it
    through ``MLP(S C, 50, 3)`` (``with_mlp``), and renders with
    ``deconv``, or returns (B, S, C) when ``deconv`` is None."""

    def __init__(self, degrees, deconv, rep_copies=10, transpose=False,
                 wigner_impl="fused", with_mlp=False, fixed_item_rep=None):
        super().__init__()
        self.degrees = degrees
        self.rep_copies = rep_copies
        self.transpose = transpose
        self.wigner_impl = wigner_impl
        shape = ((degrees + 1) ** 2, rep_copies)
        if fixed_item_rep is None:
            self.item_rep = nn.Parameter(torch.randn(shape))
        else:
            fixed = torch.as_tensor(fixed_item_rep, dtype=torch.float32)
            if tuple(fixed.shape) != shape:
                raise ValueError(f"fixed_item_rep has shape "
                                 f"{tuple(fixed.shape)}, expected {shape}")
            self.register_buffer("item_rep", fixed.clone())
        if with_mlp:
            dims = shape[0] * shape[1]
            self.mlp = MLP(dims, dims, 50, 3)
        self.with_mlp = with_mlp
        self.deconv = deconv

    def forward(self, angles):
        if angles.shape[-1] != 3:
            raise ValueError("input must be (B, 3) ZYZ Euler angles")
        item = ops.block_wigner_matrix_multiply(
            angles, self.item_rep.to(angles.dtype), self.degrees,
            transpose=self.transpose, impl=self.wigner_impl)
        if not self.with_mlp and self.deconv is None:
            return item
        item = item.flatten(1)
        if self.with_mlp:
            item = self.mlp(item)
        if self.deconv is None:
            return item.unflatten(1, (-1, self.rep_copies))
        return self.deconv(item)


class MLPDecoder(nn.Module):
    """Baseline decoder: the flattened latent (``in_dims`` wide: 9 for a
    rotation matrix, ``normal_dims`` for a Gaussian) through
    ``MLP(in_dims, S C, hidden_dims, layers, activation, dtype)``, then
    ``deconv``, or reshaped to (B, S, C) when ``deconv`` is None."""

    def __init__(self, degrees, deconv, in_dims=9, rep_copies=10, layers=3,
                 hidden_dims=50, activation="relu", dtype=None):
        super().__init__()
        self.in_dims = in_dims
        self.rep_copies = rep_copies
        self.mlp = MLP(in_dims, (degrees + 1) ** 2 * rep_copies, hidden_dims,
                       layers, activation, dtype=dtype)
        self.deconv = deconv

    def forward(self, z):
        z = z.reshape(z.shape[0], -1)
        if z.shape[-1] != self.in_dims:
            raise ValueError(f"MLPDecoder configured for in_dims="
                             f"{self.in_dims} but got a flattened latent of "
                             f"width {z.shape[-1]}")
        out = self.mlp(z)
        if self.deconv is None:
            return out.unflatten(1, (-1, self.rep_copies))
        return self.deconv(out)
