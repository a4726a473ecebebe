"""SO(3) pushforward latent: z = mu @ exp(v), v ~ N(0, diag(sigma^2)).

Counterpart of the JAX package's ``distributions/so3.py``: the sampler, the
stats struct with its KL, and the wrapped log-density. For each of 2k+1
shells theta_hat = theta + 2 pi j, j in [-k, k], the density evaluates the
algebra Gaussian at u theta_hat (u = v / |v|) and adds the exp-map volume
term log(theta_hat^2 / (2 - 2 cos theta_hat)), then takes a logsumexp over
the shells. :func:`so3_wrapped_log_density` runs that plain version on CPU
tensors and, unless asked for ``impl='xla'``, the CUDA kernel with its
backward kernel (``ops/kernels/so3_density.py``) on CUDA tensors.
"""
import dataclasses
import math

import torch

from lie_vae_tpu_torch.distributions.normal import (
    ZeroMeanGaussianStats, sample_zero_mean_gaussian)
from lie_vae_tpu_torch.ops import so3 as so3_ops

LOG_HAAR_UNIFORM = -math.log(8.0 * math.pi ** 2)


@dataclasses.dataclass
class SO3Stats:
    """mu_lie (B, 3, 3) mean rotation; inner: the algebra noise, sigma
    (B, 3) and v = inner.z (n, B, 3); z (n, B, 3, 3) group samples;
    k the shell truncation of the density; density_impl its
    implementation (:func:`so3_wrapped_log_density`)."""
    mu_lie: torch.Tensor
    inner: ZeroMeanGaussianStats
    z: torch.Tensor
    k: int = 10
    density_impl: str = "fused"

    def kl(self):
        """MC estimate E_q[log q - log p], mean over the sample axis, (B,)."""
        return torch.mean(self.log_posterior() - self.log_prior(), dim=0)

    def log_posterior(self):
        """Wrapped pushforward log-density at the drawn samples, (n, B)."""
        return so3_wrapped_log_density(self.inner.z, self.inner.sigma, self.k,
                                       impl=self.density_impl)

    def log_prior(self):
        """Haar-uniform prior: the constant -log(8 pi^2), (n, B)."""
        v = self.inner.z
        return torch.full(v.shape[:2], LOG_HAAR_UNIFORM, dtype=v.dtype,
                          device=v.device)


def so3_wrapped_log_density_plain(v, sigma, k=10, clamp=1e-3):
    """The plain version: v (n, B, 3), sigma (B, 3) -> log q (n, B), with
    the (n, B, 2k+1, 3) shell expansion written out, a safe divide for
    v / |v| and the 1e-3 clamps on theta_hat^2 and 2 - 2 cos theta_hat."""
    theta = torch.linalg.vector_norm(v, dim=-1, keepdim=True)      # (n,B,1)
    u = v / torch.clamp(theta, min=1e-12)
    shells = 2.0 * math.pi * torch.arange(-k, k + 1, dtype=v.dtype,
                                          device=v.device)        # (2k+1,)
    theta_hat = theta[..., None, :] + shells[:, None]            # (n,B,2k+1,1)
    x = u[..., None, :] * theta_hat                              # (n,B,2k+1,3)
    s = sigma[..., None, :]
    log_p = torch.sum(-0.5 * (x / s) ** 2 - torch.log(s)
                      - 0.5 * math.log(2.0 * math.pi), dim=-1)   # (n,B,2k+1)
    theta_hat_sq = torch.clamp(theta_hat ** 2, min=clamp)
    denom = torch.clamp(2.0 - 2.0 * torch.cos(theta_hat), min=clamp)
    log_vol = torch.sum(torch.log(theta_hat_sq / denom), dim=-1)
    return torch.logsumexp(log_p + log_vol, dim=-1)


def so3_wrapped_log_density(v, sigma, k=10, clamp=1e-3, impl="fused"):
    """log q(exp(v)) for the pushforward of N(0, diag(sigma^2)) to SO(3):
    v (n, B, 3), sigma (B, 3) -> (n, B).

    impl: 'fused', 'pallas' or 'auto' (the density kernel K3, whose
    backward is the kernel K4, on CUDA tensors; the plain version on CPU
    tensors: ``ops/kernels/so3_density.py`` routes both) | 'xla' (the plain
    version on any device)."""
    if impl not in ("fused", "pallas", "auto", "xla"):
        raise ValueError(f"unknown so3 density impl {impl!r} (expected "
                         "'fused', 'pallas', 'auto' or 'xla')")
    if impl == "xla":
        return so3_wrapped_log_density_plain(v, sigma, k, clamp)
    from lie_vae_tpu_torch.ops.kernels.so3_density import (
        so3_wrapped_log_density_fused)
    return so3_wrapped_log_density_fused(v, sigma, k, clamp)


def sample_so3(mu_lie, sigma, n=1, k=10, eps=None, generator=None,
               density_impl="fused"):
    """Draw n group samples z = mu_lie @ exp(eps * sigma).

    ``eps`` (n, B, 3) standard normal fixes the noise; otherwise it is
    drawn from ``generator``. ``k`` is the density's shell truncation and
    ``density_impl`` its implementation.
    """
    inner = sample_zero_mean_gaussian(sigma, n=n, eps=eps,
                                      generator=generator)
    z = mu_lie @ so3_ops.expmap(inner.z)                 # (n, B, 3, 3)
    return SO3Stats(mu_lie=mu_lie, inner=inner, z=z, k=k,
                   density_impl=density_impl)
