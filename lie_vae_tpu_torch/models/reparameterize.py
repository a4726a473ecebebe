"""Reparameterizer heads: encoder features -> a latent distribution and
samples from it.

Counterpart of the JAX package's ``models/reparameterize.py``: the
diagonal Gaussian (``NormalReparameterize``) and the SO(3) latent
(``SO3Reparameterize``, z = mu @ exp(eps * sigma), with its four mean heads
and the algebra-noise scale of ``N0Reparameterize``, ``fixed_sigma``
included). Module attribute names follow the original PyTorch reference
(``mean_module.map``, ``reparameterize.sigma_linear``, ``mu_linear``,
``mean_module.s2_map``), so its checkpoints load as they are. The vMF
head is not ported yet (ROADMAP.md, Queue A, A5).
"""
import torch
import torch.nn.functional as F
from torch import nn

from lie_vae_tpu_torch import distributions as dist
from lie_vae_tpu_torch.ops import so3 as so3_ops

# Floor on the softplus sigma heads: a bare softplus underflows to 0 in
# float32 for logits below about -90, which makes the log-density -inf.
_SIGMA_FLOOR = 1e-6


def _softplus_sigma(linear, h):
    return torch.clamp(F.softplus(linear(h)), min=_SIGMA_FLOOR)


class NormalReparameterize(nn.Module):
    """Diagonal Gaussian latent: mu and softplus sigma (floor 1e-6) heads,
    z = mu + eps * sigma; ``deterministic`` returns mu."""

    def __init__(self, in_dims, z_dim, deterministic=False):
        super().__init__()
        self.mu_linear = nn.Linear(in_dims, z_dim)
        self.sigma_linear = nn.Linear(in_dims, z_dim)
        self.deterministic = deterministic

    def forward(self, h, n=1, eps=None, generator=None):
        return dist.sample_gaussian(
            self.mu_linear(h), _softplus_sigma(self.sigma_linear, h), n=n,
            eps=eps, generator=generator, deterministic=self.deterministic)


class N0Reparameterize(nn.Module):
    """The algebra-noise scale of the SO(3) latent, as the reference nests
    it: sigma from a softplus head (floor 1e-6), or the constant
    ``fixed_sigma``. The head exists in both cases, as the reference
    instantiates it (its ``fixed_sigma`` is a buffer beside it)."""

    def __init__(self, in_dims, z_dim=3, fixed_sigma=None):
        super().__init__()
        self.sigma_linear = nn.Linear(in_dims, z_dim)
        self.z_dim = z_dim
        self.fixed_sigma_value = fixed_sigma
        if fixed_sigma is not None:
            self.register_buffer("fixed_sigma",
                                 torch.tensor(float(fixed_sigma)))

    def sigma(self, h):
        """(B, z_dim) noise scales for the features h (B, in_dims)."""
        if self.fixed_sigma_value is not None:
            return torch.full((h.shape[0], self.z_dim),
                              self.fixed_sigma_value, dtype=h.dtype,
                              device=h.device)
        return _softplus_sigma(self.sigma_linear, h)


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


class S2S1Mean(nn.Module):
    """R^in -> S^2 x S^1 -> SO(3): a unit axis and a unit (cos, sin) pair,
    rotated by the Rodrigues formula."""

    def __init__(self, in_dims):
        super().__init__()
        self.s2_map = nn.Linear(in_dims, 3)
        self.s1_map = nn.Linear(in_dims, 2)

    def forward(self, h):
        s2 = self.s2_map(h)
        s1 = self.s1_map(h)
        return so3_ops.s2s1rodrigues(
            s2 / torch.linalg.norm(s2, dim=-1, keepdim=True),
            s1 / torch.linalg.norm(s1, dim=-1, keepdim=True))


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


MEAN_MODULES = {"alg": AlgebraMean, "q": QuaternionMean, "s2s1": S2S1Mean,
                "s2s2": S2S2Mean}


class SO3Reparameterize(nn.Module):
    """Mean rotation from a mean head, algebra noise scale sigma from the
    inner :class:`N0Reparameterize` (``fixed_sigma``, or a softplus head
    optionally clamped above at ``sigma_clamp``), z = mu @ exp(eps sigma);
    ``deterministic`` returns mu with zero noise. ``k`` wrapping shells for
    the posterior density, computed by ``density_impl``
    (``distributions.so3_wrapped_log_density``)."""

    def __init__(self, in_dims, mean_mode="s2s2", sigma_clamp=None, k=10,
                 density_impl="fused", fixed_sigma=None, deterministic=False):
        super().__init__()
        if mean_mode not in MEAN_MODULES:
            raise ValueError(f"unknown mean_mode {mean_mode!r} (expected "
                             f"one of {sorted(MEAN_MODULES)})")
        self.mean_module = MEAN_MODULES[mean_mode](in_dims)
        self.reparameterize = N0Reparameterize(in_dims,
                                               fixed_sigma=fixed_sigma)
        self.sigma_clamp = sigma_clamp
        self.k = k
        self.density_impl = density_impl
        self.deterministic = deterministic

    def forward(self, h, n=1, eps=None, generator=None):
        mu_lie = self.mean_module(h)
        sigma = self.reparameterize.sigma(h)
        if self.sigma_clamp is not None \
                and self.reparameterize.fixed_sigma_value is None:
            sigma = torch.clamp(sigma, max=self.sigma_clamp)
        return dist.sample_so3(mu_lie, sigma, n=n, k=self.k, eps=eps,
                               generator=generator,
                               density_impl=self.density_impl,
                               deterministic=self.deterministic)
