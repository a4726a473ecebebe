"""The group-action decoder: learned Fourier modes rotated by the block
Wigner representation of the latent pose, then a deconv head.

Counterpart of ``ActionDecoder`` in the JAX package's ``models/decoders.py``.
"""
import torch
from torch import nn

from lie_vae_tpu_torch import ops


class ActionDecoder(nn.Module):
    """item_rep: learned ((degrees+1)^2, rep_copies) coefficients (standard
    normal init). forward takes ZYZ angles (B, 3), rotates the shared
    item_rep per sample with ``ops.block_wigner_matrix_multiply`` at
    ``impl=wigner_impl`` (on a CUDA tensor 'fused' runs the chain kernels,
    'pallas' the synthesise-then-apply kernels; the (S, C) array goes to
    them as it is, never expanded over the batch), flattens s-major, and
    renders with ``deconv``."""

    def __init__(self, degrees, deconv, rep_copies=10, transpose=False,
                 wigner_impl="fused"):
        super().__init__()
        self.degrees = degrees
        self.transpose = transpose
        self.wigner_impl = wigner_impl
        self.item_rep = nn.Parameter(
            torch.randn((degrees + 1) ** 2, rep_copies))
        self.deconv = deconv

    def forward(self, angles):
        if angles.shape[-1] != 3:
            raise ValueError("input must be (B, 3) ZYZ Euler angles")
        item = ops.block_wigner_matrix_multiply(
            angles, self.item_rep.to(angles.dtype), self.degrees,
            transpose=self.transpose, impl=self.wigner_impl)
        return self.deconv(item.flatten(1))
