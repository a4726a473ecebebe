"""SO(3) reparameterizer heads: encoder features -> mean rotation, algebra
noise scale, and samples z = mu @ exp(eps * sigma).

Counterpart of the JAX package's ``models/reparameterize.py`` for the SO(3)
latent. Module attribute names follow the original PyTorch reference
(``mean_module.map``, ``reparameterize.sigma_linear``), so its checkpoints
load as they are.
"""
import torch
import torch.nn.functional as F
from torch import nn

from lie_vae_tpu_torch import distributions as dist
from lie_vae_tpu_torch.ops import so3 as so3_ops

# Floor on the softplus sigma head: a bare softplus underflows to 0 in
# float32 for logits below about -90, which makes the log-density -inf.
_SIGMA_FLOOR = 1e-6


class AlgebraMean(nn.Module):
    """R^in -> so(3) -> SO(3) by the exponential map."""

    def __init__(self, in_dims):
        super().__init__()
        self.map = nn.Linear(in_dims, 3)

    def forward(self, h):
        return so3_ops.expmap(self.map(h))


class QuaternionMean(nn.Module):
    """R^in -> R^4 -> SO(3)."""

    def __init__(self, in_dims):
        super().__init__()
        self.map = nn.Linear(in_dims, 4)

    def forward(self, h):
        return so3_ops.quaternions_to_group_matrix(self.map(h))


class S2S2Mean(nn.Module):
    """R^in -> S^2 x S^2 -> SO(3) by Gram-Schmidt, with the reference's
    Uniform(-10, 10) init of weight and bias."""

    def __init__(self, in_dims):
        super().__init__()
        self.map = nn.Linear(in_dims, 6)
        nn.init.uniform_(self.map.weight, -10.0, 10.0)
        nn.init.uniform_(self.map.bias, -10.0, 10.0)

    def forward(self, h):
        v = self.map(h).unflatten(-1, (2, 3))
        return so3_ops.s2s2_gram_schmidt(v[..., 0, :], v[..., 1, :])


MEAN_MODULES = {"alg": AlgebraMean, "q": QuaternionMean, "s2s2": S2S2Mean}


class N0Reparameterize(nn.Module):
    """Holds the algebra-noise scale head, as the reference nests it."""

    def __init__(self, in_dims, z_dim=3):
        super().__init__()
        self.sigma_linear = nn.Linear(in_dims, z_dim)


class SO3Reparameterize(nn.Module):
    """Mean rotation from a mean head, sigma = max(softplus(.), 1e-6)
    (optionally clamped above at ``sigma_clamp``), z = mu @ exp(eps sigma);
    ``k`` wrapping shells for the posterior density, computed by
    ``density_impl`` (``distributions.so3_wrapped_log_density``)."""

    def __init__(self, in_dims, mean_mode="s2s2", sigma_clamp=None, k=10,
                 density_impl="fused"):
        super().__init__()
        if mean_mode not in MEAN_MODULES:
            raise NotImplementedError(
                f"mean_mode {mean_mode!r} is not ported yet (ROADMAP.md, "
                "Queue A, modules left out of the serving slice)")
        self.mean_module = MEAN_MODULES[mean_mode](in_dims)
        self.reparameterize = N0Reparameterize(in_dims)
        self.sigma_clamp = sigma_clamp
        self.k = k
        self.density_impl = density_impl

    def forward(self, h, n=1, eps=None, generator=None):
        mu_lie = self.mean_module(h)
        sigma = torch.clamp(
            F.softplus(self.reparameterize.sigma_linear(h)), min=_SIGMA_FLOOR)
        if self.sigma_clamp is not None:
            sigma = torch.clamp(sigma, max=self.sigma_clamp)
        return dist.sample_so3(mu_lie, sigma, n=n, k=self.k, eps=eps,
                               generator=generator,
                               density_impl=self.density_impl)
