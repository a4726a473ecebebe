"""SO(3) pushforward latent: z = mu @ exp(v), v ~ N(0, diag(sigma^2)).

Counterpart of the JAX package's ``distributions/so3.py``, for serving: the
stats serving reads and the sampler. The wrapped density, its KL and its
kernel are training's and come with it (ROADMAP.md, kernels K3 and K4).
"""
import dataclasses

import torch

from lie_vae_tpu_torch.distributions.normal import (
    ZeroMeanGaussianStats, sample_zero_mean_gaussian)
from lie_vae_tpu_torch.ops import so3 as so3_ops


@dataclasses.dataclass
class SO3Stats:
    """mu_lie (B, 3, 3) mean rotation; inner: the algebra noise, sigma
    (B, 3) and v = inner.z (n, B, 3); z (n, B, 3, 3) group samples."""
    mu_lie: torch.Tensor
    inner: ZeroMeanGaussianStats
    z: torch.Tensor


def sample_so3(mu_lie, sigma, n=1, eps=None, generator=None):
    """Draw n group samples z = mu_lie @ exp(eps * sigma).

    ``eps`` (n, B, 3) standard normal fixes the noise; otherwise it is
    drawn from ``generator``.
    """
    inner = sample_zero_mean_gaussian(sigma, n=n, eps=eps,
                                      generator=generator)
    z = mu_lie @ so3_ops.expmap(inner.z)                 # (n, B, 3, 3)
    return SO3Stats(mu_lie=mu_lie, inner=inner, z=z)
