"""Gaussian latent distributions in PyTorch.

Counterpart of the JAX package's ``distributions/normal.py``. Each sampler
returns a stats struct carrying the quantities the densities read. Noise is
an argument: pass ``eps`` (standard normal, shaped like the samples) to fix
it, or a ``torch.Generator`` to draw it; ``deterministic`` draws none.
"""
import dataclasses
import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def _normal_log_prob(z, mu, sigma):
    """Elementwise N(mu, sigma) log-density (sigma is a std-dev)."""
    return -0.5 * ((z - mu) / sigma) ** 2 - torch.log(
        torch.as_tensor(sigma, dtype=z.dtype, device=z.device)) \
        - 0.5 * _LOG_2PI


@dataclasses.dataclass
class GaussianStats:
    """Diagonal Gaussian posterior: mu, sigma (B, D); z (n, B, D)."""
    mu: torch.Tensor
    sigma: torch.Tensor
    z: torch.Tensor

    def kl(self):
        """Closed-form KL(q || N(0, I)), (B,)."""
        return -0.5 * torch.sum(
            1.0 + 2.0 * torch.log(self.sigma) - self.mu ** 2
            - self.sigma ** 2, dim=-1)

    def log_posterior(self, z=None):
        """log q(z | x), (n, B)."""
        z = self.z if z is None else z
        return torch.sum(_normal_log_prob(z, self.mu, self.sigma), dim=-1)

    def log_prior(self):
        """log p(z) under N(0, I), (n, B)."""
        return torch.sum(_normal_log_prob(self.z, 0.0, 1.0), dim=-1)


@dataclasses.dataclass
class ZeroMeanGaussianStats:
    """Zero-mean diagonal Gaussian (the SO(3) algebra noise):
    sigma (B, D); z (n, B, D)."""
    sigma: torch.Tensor
    z: torch.Tensor


def _standard_normal(shape, like, eps, generator):
    if eps is not None:
        if tuple(eps.shape) != tuple(shape):
            raise ValueError(f"eps has shape {tuple(eps.shape)}, expected "
                             f"{tuple(shape)}")
        return eps.to(dtype=like.dtype, device=like.device)
    gen_device = generator.device if generator is not None else like.device
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=gen_device).to(like.device)


def sample_gaussian(mu, sigma, n=1, eps=None, generator=None,
                    deterministic=False):
    """z = mu + eps * sigma for n samples; returns :class:`GaussianStats`.

    ``eps`` (n, *mu.shape) fixes the noise; otherwise it is drawn from
    ``generator``. ``deterministic`` (the autoencoder mode) returns the
    mean n times and draws nothing.
    """
    if deterministic:
        z = mu.expand((n,) + tuple(mu.shape))
    else:
        z = mu + _standard_normal((n,) + tuple(mu.shape), mu, eps,
                                  generator) * sigma
    return GaussianStats(mu=mu, sigma=sigma, z=z)


def sample_zero_mean_gaussian(sigma, n=1, eps=None, generator=None,
                              deterministic=False):
    """z = eps * sigma for n samples; returns :class:`ZeroMeanGaussianStats`.

    ``eps`` (n, *sigma.shape) fixes the noise; otherwise it is drawn from
    ``generator`` (on its own device, then moved to sigma's).
    ``deterministic`` gives z = 0 and draws nothing.
    """
    shape = (n,) + tuple(sigma.shape)
    if deterministic:
        return ZeroMeanGaussianStats(sigma=sigma, z=sigma.new_zeros(shape))
    eps = _standard_normal(shape, sigma, eps, generator)
    return ZeroMeanGaussianStats(sigma=sigma, z=eps * sigma)
