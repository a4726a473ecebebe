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
    item_rep per sample (the Wigner chain kernel on a CUDA tensor; the
    (S, C) array goes to it as it is, never expanded over the batch),
    flattens s-major, and renders with ``deconv``."""

    def __init__(self, degrees, deconv, rep_copies=10, transpose=False):
        super().__init__()
        self.degrees = degrees
        self.transpose = transpose
        self.item_rep = nn.Parameter(
            torch.randn((degrees + 1) ** 2, rep_copies))
        self.deconv = deconv

    def forward(self, angles):
        if angles.shape[-1] != 3:
            raise ValueError("input must be (B, 3) ZYZ Euler angles")
        item = ops.block_wigner_matrix_multiply(
            angles, self.item_rep.to(angles.dtype), self.degrees,
            transpose=self.transpose)
        return self.deconv(item.flatten(1))
