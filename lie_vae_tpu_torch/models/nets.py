"""Convolutional encoder and transpose-convolutional decoder head, NCHW.

Counterparts of ``ConvEncoder`` and ``DeconvNet`` in the JAX package's
``models/nets.py``. Both are ``nn.Sequential``s laid out as the original
PyTorch reference's, so their state_dict keys (``encoder.0.weight`` ...
``decoder.deconv.9.weight``) are the reference checkpoint's. The JAX
``fast_head`` (a phase decomposition of the stride-2 transpose conv, an XLA
rewrite and not a Pallas kernel) computes the same function as
``nn.ConvTranspose2d(k=4, s=2, p=1)``.
"""
import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update of the running statistics
    is flax's: ``running_var`` moves toward the biased batch variance (torch
    uses the unbiased one), ``running = (1 - momentum) running + momentum
    batch`` with momentum 0.1 (flax's 0.9 on the old value). Normalisation
    is unchanged (both libraries use the biased batch variance inside the
    step), and so are the state_dict keys."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                         momentum=0.0, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        return y


class ConvEncoder(nn.Sequential):
    """Five strided convs, 64x64 -> out_dims: channels in -> h -> 2h -> 4h
    -> 8h -> out, kernel 4 stride 2 pad 1 (the last 4/1/0), each but the
    last followed by BatchNorm (eps 1e-5, momentum 0.1 with flax's biased
    running variance; optional) and LeakyReLU(0.2).
    Takes NCHW, returns (B, out_dims)."""

    def __init__(self, out_dims, hidden_dims=50, rgb=False, batch_norm=True):
        h = hidden_dims
        widths = [h, 2 * h, 4 * h, 8 * h]
        layers, c_in = [], 3 if rgb else 1
        for w in widths:
            layers.append(nn.Conv2d(c_in, w, 4, 2, 1))
            if batch_norm:
                layers.append(BatchNorm2d(w, eps=1e-5, momentum=0.1))
            layers.append(nn.LeakyReLU(0.2))
            c_in = w
        layers.append(nn.Conv2d(c_in, out_dims, 4, 1, 0))       # 4x4 -> 1x1
        super().__init__(*layers)

    def forward(self, x):
        return super().forward(x).flatten(1)


class DeconvNet(nn.Sequential):
    """(B, in_dims) -> (B, 1|3, 64, 64) NCHW: a 1x1 -> 4x4 transpose conv,
    three k4 s2 ones to 32x32, each with ReLU, and a k4 s2 image head with
    no output nonlinearity."""

    def __init__(self, in_dims, hidden_dims, rgb=False):
        h = hidden_dims
        super().__init__(
            nn.Unflatten(1, (in_dims, 1, 1)),
            nn.ConvTranspose2d(in_dims, h, 4, 1, 0), nn.ReLU(),
            nn.ConvTranspose2d(h, h, 4, 2, 1), nn.ReLU(),
            nn.ConvTranspose2d(h, h, 4, 2, 1), nn.ReLU(),
            nn.ConvTranspose2d(h, h, 4, 2, 1), nn.ReLU(),
            nn.ConvTranspose2d(h, 3 if rgb else 1, 4, 2, 1))
