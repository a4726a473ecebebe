"""The von Mises-Fisher latent on S^{p-1} and the hyperspherical uniform, in
PyTorch.

Counterpart of the JAX package's ``distributions/vmf.py``, function for
function: the scaled Bessel functions ``ive``/``log_ive`` and the ratio
``bessel_ratio`` (an ascending series below max(1, v), ``i0e``/``i1e`` or
the half-integer closed forms with the upward recurrence above), the vMF
normaliser, the uniform's entropy and log-density,
:class:`VonMisesFisherStats` and the reparameterised sampler (Wood's
rejection scheme with the accept/reject decisions on a detached kappa and
the accepted Beta draw pushed through the differentiable map w(eps, kappa),
then a Householder reflection of e1 onto mu). ``torch.special.i0e`` and
``i1e`` carry autograd; every other order is composed from them.

Noise is an input. :func:`sample_vmf` takes ``eps`` = (accepted Beta draw
(n, B), tangent normal (n, B, p)); without it the proposals are drawn from
a ``torch.Generator`` on its own device and the first accepted one is
picked on mu's device, with no host synchronisation.
"""
import dataclasses
import functools
import itertools
import math

import torch

# proposals of Wood's sampler: the first accepted one is kept, else 0.5
# (acceptance is above about 66% a round, so 32 rounds always suffice for
# a healthy kappa), as the JAX sampler's while_loop caps its rounds
NUM_PROPOSALS = 32


@functools.lru_cache(maxsize=None)
def _series_constants(v, terms, dtype, device):
    """k and log prod_{j<=k} j (v + j) for k = 1 .. terms - 1, on the device
    once."""
    log_d = list(itertools.accumulate(
        math.log(j * (v + j)) for j in range(1, terms)))
    return (torch.arange(1, terms, dtype=dtype, device=device),
            torch.tensor(log_d, dtype=dtype, device=device))


def _series_scaled(v, z, terms=32):
    """S_v(z) = sum_k (z^2/4)^k / (k! Gamma(v+k+1)), so I_v = (z/2)^v S_v.

    Each term Gamma(v+1) t_k = (z^2/4)^k / prod_{j<=k} j (v+j) is formed in
    log space, exp(k log(z^2/4) - log prod), all 31 at once: a handful of
    device kernels instead of a loop of 31 steps, and no cumulative product
    (whose backward waits for the device to test its input for zeros). The
    floor 1e-30 on z^2/4 keeps log and its gradient finite at z = 0, where
    the terms it adds are below float32's resolution of the leading 1."""
    vf = float(v)
    k, log_d = _series_constants(vf, terms, z.dtype, z.device)
    log_zz = torch.log(torch.clamp(0.25 * z * z, min=1e-30))
    t = torch.exp(k * log_zz[..., None] - log_d)
    return (1.0 + t.sum(-1)) / math.gamma(vf + 1.0)


def _small_threshold(v):
    # the upward recurrence is only stable for z >~ v; the ascending series
    # covers z < max(1, v)
    return max(1.0, float(v))


def _recurrence(v, zs):
    """ive from i0e/i1e (or the half-integer closed forms) and the upward
    recurrence I_{v+1} = I_{v-1} - (2v/z) I_v; valid for z >~ v."""
    if float(v) == int(v):
        orders = int(v)
        prev, cur = torch.special.i0e(zs), torch.special.i1e(zs)
        if orders == 0:
            return prev
        for n in range(1, orders):
            prev, cur = cur, prev - (2.0 * n / zs) * cur
        return cur
    if (float(v) * 2) != int(float(v) * 2):
        raise ValueError("ive supports integer and half-integer orders only")
    # I_{1/2} = sqrt(2/(pi z)) sinh z, I_{3/2} = sqrt(2/(pi z)) (cosh z -
    # sinh z / z), scaled by e^-z: sinh z e^-z = (1 - e^-2z) / 2 and
    # cosh z e^-z = (1 + e^-2z) / 2
    pref = torch.sqrt(2.0 / (math.pi * zs))
    sinh_s = 0.5 * (1.0 - torch.exp(-2.0 * zs))
    cosh_s = 0.5 * (1.0 + torch.exp(-2.0 * zs))
    prev = pref * sinh_s
    if float(v) == 0.5:
        return prev
    cur = pref * (cosh_s - sinh_s / zs)
    order = 1.5
    while order < float(v):
        prev, cur = cur, prev - (2.0 * order / zs) * cur
        order += 1.0
    return cur


def _branch_args(v, z):
    """(small, zs, zq): guarded arguments for the two branches. Both must
    stay finite: ``torch.where``'s backward multiplies the untaken branch's
    gradient by zero, which is still NaN on an inf or NaN (NaN gradients
    once kappa passed about 300, in the JAX package's training)."""
    thr = _small_threshold(v)
    small = z < thr
    zs = torch.where(small, torch.full_like(z, thr), z)
    zq = torch.where(small, z, torch.full_like(z, 0.5))
    return small, zs, zq


def ive(v, z):
    """Exponentially scaled modified Bessel I_v(z) exp(-z), z >= 0; v a
    non-negative integer or half-integer (a Python number)."""
    small, zs, zq = _branch_args(v, z)
    series = torch.exp(-zq) * (0.5 * zq) ** float(v) * _series_scaled(v, zq)
    return torch.where(small, series, _recurrence(v, zs))


def log_ive(v, z):
    """log(I_v(z)) - z. The series branch returns v log(z/2) + log S_v - z
    directly, so it neither underflows nor loses the v log z singularity
    that cancels against the vMF normaliser's v log kappa."""
    small, zs, zq = _branch_args(v, z)
    tiny = torch.finfo(z.dtype).tiny
    series = (float(v) * torch.log(0.5 * torch.clamp(zq, min=tiny))
              + torch.log(_series_scaled(v, zq)) - zq)
    rec = torch.log(torch.clamp(_recurrence(v, zs), min=1e-30))
    return torch.where(small, series, rec)


def bessel_ratio(v, z):
    """A(z) = I_{v+1}(z) / I_v(z), stable at both ends: the series branch
    is the ratio of the scaled series, (z/2) S_{v+1}(z) / S_v(z)."""
    small, zs, zq = _branch_args(float(v) + 1.0, z)
    series = 0.5 * zq * (_series_scaled(float(v) + 1.0, zq)
                         / _series_scaled(v, zq))
    rec = (_recurrence(float(v) + 1.0, zs)
           / torch.clamp(_recurrence(v, zs), min=1e-30))
    return torch.where(small, series, rec)


def _log_vmf_normalizer(kappa, p):
    """log C_p(kappa), q(x) = C_p(kappa) exp(kappa mu^T x) on S^{p-1}."""
    v = p / 2.0 - 1.0
    return (v * torch.log(kappa) - (p / 2.0) * math.log(2.0 * math.pi)
            - (log_ive(v, kappa) + kappa))


def _log_area(dim):
    """log of the area of S^dim, log(2 pi^{(dim+1)/2} / Gamma((dim+1)/2))."""
    half = (dim + 1) / 2.0
    return math.log(2.0) + half * math.log(math.pi) - math.lgamma(half)


def hyperspherical_uniform_entropy(dim, dtype=torch.float32):
    """Entropy of the uniform distribution on S^dim (in R^{dim+1}), the log
    of its area; a 0-dim CPU tensor (it combines with a tensor on any
    device as a scalar)."""
    return torch.tensor(_log_area(dim), dtype=dtype)


def hyperspherical_uniform_log_prob(z, dim=None):
    """log density of the uniform on S^dim, broadcast over z's batch
    dimensions."""
    if dim is None:
        dim = z.shape[-1] - 1
    return torch.full(z.shape[:-1], -_log_area(dim), dtype=z.dtype,
                      device=z.device)


@dataclasses.dataclass
class VonMisesFisherStats:
    """vMF posterior on S^{p-1}: mu (B, p) unit mean direction, kappa (B, 1)
    concentration, z (n, B, p) unit samples."""
    mu: torch.Tensor
    kappa: torch.Tensor
    z: torch.Tensor

    @property
    def p(self):
        return self.mu.shape[-1]

    def log_posterior(self, z=None):
        """log q(z | x) = log C_p(kappa) + kappa mu^T z, (n, B)."""
        z = self.z if z is None else z
        k = self.kappa[..., 0]
        return _log_vmf_normalizer(k, self.p) + k * torch.sum(self.mu * z,
                                                              dim=-1)

    def log_prior(self):
        """log density of the uniform prior, (n, B)."""
        return hyperspherical_uniform_log_prob(self.z)

    def entropy(self):
        """H[q] = -log C_p(k) - k A_p(k), A_p = I_{p/2} / I_{p/2-1}, (B,)."""
        k = self.kappa[..., 0]
        return (-_log_vmf_normalizer(k, self.p)
                - k * bessel_ratio(self.p / 2.0 - 1.0, k))

    def kl(self):
        """KL(q || uniform) = H[uniform] - H[q], (B,)."""
        return -self.entropy() + _log_area(self.p - 1)


def _wood_b(k, p):
    # the cancellation-free b = (-2k + sqrt(4k^2 + (p-1)^2)) / (p-1): the
    # textbook form rounds to 0 in float32 for k >~ 1e4, which collapses
    # every draw to w == 1
    return (p - 1.0) / (2.0 * k + torch.sqrt(4.0 * k ** 2 + (p - 1.0) ** 2))


def _draw_device(generator, like):
    # a generator draws on its own device; without one, on the tensor's
    return generator.device if generator is not None else like.device


def _onto(t, like):
    """A drawn tensor onto ``like``'s device. From the CPU to a card the
    copy goes through pinned memory and does not wait: a pageable copy
    would block the host until the work queued before it (the encoder) had
    run, once per draw inside the training step."""
    if t.device == like.device:
        return t
    if t.device.type == "cpu" and like.device.type == "cuda":
        return t.pin_memory().to(like.device, non_blocking=True)
    return t.to(like.device)


def _beta_draws(shape, p, generator, like):
    """Beta((p-1)/2, (p-1)/2) draws: X / (X + Y) with X, Y independent
    chi-squared with p - 1 degrees of freedom, each a sum of p - 1 squared
    standard normals (Gamma((p-1)/2) = chi^2(p-1) / 2, the halves cancel),
    drawn from ``generator`` on its own device."""
    g = torch.randn((2, p - 1) + tuple(shape), generator=generator,
                    dtype=like.dtype, device=_draw_device(generator, like))
    x, y = (g * g).sum(1).unbind(0)
    return x / (x + y)


def accepted_beta_draw(kappa, p, n, generator=None,
                       num_proposals=NUM_PROPOSALS):
    """Wood's (1994) rejection sampler for the mu-axis component, as the
    accepted Beta draw (n, B): ``num_proposals`` proposals and uniforms are
    drawn at once from ``generator`` (on its own device, then moved to
    kappa's), each accepted or rejected against the detached kappa (B, 1),
    and the first accepted one kept, else 0.5. Everything after the draw
    runs on kappa's device without a host synchronisation."""
    kd = kappa.detach()[..., 0]
    shape = (num_proposals, n) + tuple(kd.shape)
    eps = _onto(_beta_draws(shape, p, generator, kd), kd)
    u = _onto(torch.rand(shape, generator=generator, dtype=kappa.dtype,
                         device=_draw_device(generator, kd)), kd)
    root = torch.sqrt(4.0 * kd ** 2 + (p - 1.0) ** 2)
    b = (p - 1.0) / (2.0 * kd + root)
    a = (p - 1.0 + 2.0 * kd + root) / 4.0
    d = 4.0 * a * b / (1.0 + b) - (p - 1.0) * math.log(p - 1.0)
    t = 2.0 * a * b / (1.0 - (1.0 - b) * eps)
    accept = ((p - 1.0) * torch.log(t) - t + d) >= torch.log(u)
    # the first accepted proposal: argmax returns the first maximum
    first = torch.argmax(accept.to(torch.uint8), dim=0, keepdim=True)
    picked = torch.gather(eps, 0, first)[0]
    return torch.where(accept.any(0), picked, torch.full_like(picked, 0.5))


def sample_vmf(mu, kappa, n=1, eps=None, generator=None,
               deterministic=False):
    """n reparameterised vMF samples; returns :class:`VonMisesFisherStats`.

    ``eps`` = (accepted Beta draw (n, B), tangent normal (n, B, p)) fixes
    the noise (the normal's first coordinate is ignored); otherwise both
    are drawn from ``generator`` (:func:`accepted_beta_draw`). The accepted
    draw is detached and pushed through w = (1 - (1+b) e) / (1 - (1-b) e)
    with the attached kappa, so d w / d kappa flows. ``deterministic``
    returns mu n times and draws nothing.
    """
    p = mu.shape[-1]
    if deterministic:
        return VonMisesFisherStats(mu=mu, kappa=kappa,
                                   z=mu.expand((n,) + tuple(mu.shape)))
    shape = (n,) + tuple(mu.shape)
    if eps is None:
        e = accepted_beta_draw(kappa, p, n, generator)
        v = _onto(torch.randn(shape, generator=generator, dtype=mu.dtype,
                              device=_draw_device(generator, mu)), mu)
    else:
        if isinstance(eps, torch.Tensor):
            raise TypeError("vMF noise is the pair (accepted Beta draw, "
                            "tangent normal), not one tensor")
        e, v = eps
        if tuple(e.shape) != shape[:-1] or tuple(v.shape) != shape:
            raise ValueError(
                f"eps shapes {tuple(e.shape)}, {tuple(v.shape)}, expected "
                f"{shape[:-1]}, {shape}")
        e = e.to(dtype=mu.dtype, device=mu.device)
        v = v.to(dtype=mu.dtype, device=mu.device)
    e = e.detach()
    b = _wood_b(kappa[..., 0], p)
    w = (1.0 - (1.0 + b) * e) / (1.0 - (1.0 - b) * e)

    # tangent direction: uniform on the sphere orthogonal to e1
    v = torch.cat([torch.zeros_like(v[..., :1]), v[..., 1:]], -1)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                        min=1e-12)
    # the floor keeps sqrt's gradient finite where w rounds to +/-1
    z_e1 = torch.cat([w[..., None], torch.sqrt(torch.clamp(
        1.0 - w[..., None] ** 2, min=1e-12)) * v[..., 1:]], -1)

    # Householder reflection mapping e1 -> mu
    e1 = torch.zeros_like(mu)
    e1[..., 0] = 1.0
    u = e1 - mu
    u = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True),
                        min=1e-12)
    z = z_e1 - 2.0 * torch.sum(z_e1 * u, dim=-1, keepdim=True) * u
    return VonMisesFisherStats(mu=mu, kappa=kappa, z=z)
