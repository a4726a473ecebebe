"""The PyTorch port's wrapped SO(3) density held against the JAX package's.

The plain density, the KL, log-posterior and log-prior of ``SO3Stats``, and
their gradients, on CPU tensors in float64, against the JAX package's XLA
path (``impl='xla'``, which ``tests/test_kernels.py`` pins to its TPU
kernel) and ``jax.grad`` of it. Inputs are drawn once with numpy and
include v = 0, |v| at and near multiples of 2 pi, sigma from the 1e-6
floor to pi * 10 / 2 (the clamp ``bench.py`` trains with), and k in
{0, 1, 10}. Tolerance 1e-10 (relative, with the same floor absolute): the
same formulas in float64 in two libraries. A gradient in v is held row by
row, against the largest of the sample's three components: the components
of one row are sums that cancel, so a small one carries the rounding of
its large neighbours.

At v = 0 JAX's autodiff of |v| gives NaN; the port's plain version gives 0
there, as the JAX package's analytic backward kernel does (u = 0), and so
does the port's kernel.

The CUDA kernels run only on a card: ``test_kernels_match_plain`` is
marked ``cuda`` and skips elsewhere.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lie_vae_tpu.distributions import normal as jnormal
from lie_vae_tpu.distributions import so3 as jso3
from lie_vae_tpu_torch import distributions as tdist
from lie_vae_tpu_torch.distributions import so3 as tso3
from lie_vae_tpu_torch.ops.kernels import so3_density

TOL = 1e-10
KS = (0, 1, 10)


def _inputs(n=3, B=9, seed=0, dtype=np.float64):
    """v = eps * sigma, sigma log-uniform in [1e-6, 5 pi] with both ends
    present; rows 2-6 of the first sample put |v| at and near multiples of
    2 pi, where their sigma is at least 0.5 (a posterior with sigma near
    the floor draws |v| near 0, and |v| near 2 pi m with sigma that small
    asks float32 for more digits than its |v| carries); one v = 0 and one
    tiny v."""
    rng = np.random.default_rng(seed)
    sigma = np.exp(rng.uniform(np.log(1e-6), np.log(5 * np.pi), (B, 3)))
    sigma[0] = 1e-6
    sigma[1] = 5 * np.pi
    sigma[2:7] = rng.uniform(0.5, 5 * np.pi, (5, 3))
    v = rng.normal(size=(n, B, 3)) * sigma
    axes = rng.normal(size=(5, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    radii = np.array([2 * np.pi, 2 * np.pi + 1e-3, 4 * np.pi - 1e-2,
                      6 * np.pi, 0.3])
    v[0, 2:7] = axes * radii[:, None]
    v[min(1, n - 1), 3] = 0.0
    v[n - 1, 4] = [1e-5, -2e-5, 3e-6]
    return v.astype(dtype), sigma.astype(dtype)


@pytest.fixture(scope="module")
def jax_reference():
    v, sigma = _inputs()
    g = np.random.default_rng(1).normal(size=v.shape[:2])
    out = {}
    for k in KS:
        def density(v, s, k=k):
            return jso3.so3_wrapped_log_density(v, s, k)

        out[k, "value"] = np.asarray(jax.jit(density)(v, sigma))
        dv, ds = jax.jit(jax.grad(
            lambda v, s: jnp.sum(density(v, s) * g), argnums=(0, 1)))(
                v, sigma)
        out[k, "dv"], out[k, "ds"] = np.asarray(dv), np.asarray(ds)
    return v, sigma, g, out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _close_rows(got, want, tol=TOL):
    """Each row (..., 3) within tol * max(1, its largest |component|)."""
    err = np.abs(np.asarray(got) - np.asarray(want)).max(-1)
    scale = np.maximum(1.0, np.abs(np.asarray(want)).max(-1))
    assert (err <= tol * scale).all(), (err / scale).max()


@pytest.mark.parametrize("k", KS)
def test_density_matches_jax(jax_reference, k):
    v, sigma, _, ref = jax_reference
    got = tdist.so3_wrapped_log_density(torch.tensor(v), torch.tensor(sigma),
                                        k)
    assert got.shape == v.shape[:2] and got.dtype == torch.float64
    _close(got, ref[k, "value"])


@pytest.mark.parametrize("k", KS)
def test_density_grads_match_jax(jax_reference, k):
    v, sigma, g, ref = jax_reference
    vt = torch.tensor(v, requires_grad=True)
    st = torch.tensor(sigma, requires_grad=True)
    (tdist.so3_wrapped_log_density(vt, st, k) * torch.tensor(g)).sum() \
        .backward()
    dv, dv_ref = vt.grad.numpy(), ref[k, "dv"]
    at_zero = np.all(v == 0.0, axis=-1)
    assert at_zero.sum() == 1 and np.isnan(dv_ref[at_zero]).all()
    np.testing.assert_array_equal(dv[at_zero], 0.0)
    _close_rows(dv[~at_zero], dv_ref[~at_zero])
    _close_rows(st.grad, ref[k, "ds"])


@pytest.mark.parametrize("k", KS)
def test_stats_kl_posterior_prior_match_jax(k):
    v, sigma = _inputs(n=2, B=9, seed=3)
    rng = np.random.default_rng(4)
    mu = np.linalg.qr(rng.normal(size=(9, 3, 3)))[0]
    jstats = jso3.SO3Stats(
        mu_lie=jnp.asarray(mu),
        inner=jnormal.ZeroMeanGaussianStats(sigma=jnp.asarray(sigma),
                                            z=jnp.asarray(v)),
        z=jnp.zeros((2, 9, 3, 3)), k=k)
    want = jax.jit(lambda s: (s.kl(), s.log_posterior(), s.log_prior()))(
        jstats)
    tstats = tdist.SO3Stats(
        mu_lie=torch.tensor(mu),
        inner=tdist.ZeroMeanGaussianStats(sigma=torch.tensor(sigma),
                                          z=torch.tensor(v)),
        z=torch.zeros((2, 9, 3, 3), dtype=torch.float64), k=k)
    for got, ref in zip((tstats.kl(), tstats.log_posterior(),
                         tstats.log_prior()), want):
        assert tuple(got.shape) == ref.shape
        _close(got, ref)


def test_haar_constant_and_sampler_carry_over():
    assert tdist.LOG_HAAR_UNIFORM == jso3.LOG_HAAR_UNIFORM == pytest.approx(
        -math.log(8 * math.pi ** 2), abs=0)
    mu = torch.eye(3, dtype=torch.float64).expand(4, 3, 3)
    sigma = torch.full((4, 3), 0.5, dtype=torch.float64)
    stats = tdist.sample_so3(mu, sigma, n=2, k=3,
                             eps=torch.zeros((2, 4, 3), dtype=torch.float64))
    assert stats.k == 3
    assert tdist.sample_so3(mu, sigma, eps=torch.zeros(
        (1, 4, 3), dtype=torch.float64)).k == 10


def test_cpu_tensors_never_launch_the_kernels():
    v, sigma = _inputs(dtype=np.float32)
    fused = so3_density.so3_wrapped_log_density_fused
    before = fused.launches, fused.launches_backward
    vt = torch.tensor(v, requires_grad=True)
    out = fused(vt, torch.tensor(sigma))
    out.sum().backward()
    tso3.so3_wrapped_log_density(vt, torch.tensor(sigma)).sum().backward()
    assert (fused.launches, fused.launches_backward) == before
    _close(out.detach(), tso3.so3_wrapped_log_density_plain(
        torch.tensor(v), torch.tensor(sigma)), 0.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n,B", [(1, 1), (1, 64), (1, 4103), (4, 16384)])
def test_kernels_match_plain(cuda_device, k, n, B):
    """K3 and K4 in float32 against the plain density and its autograd in
    float64 on the card (in float32 the plain autograd is the less accurate
    of the two where sigma is small): rtol and atol 1e-4 on values and 1e-3
    on gradients, as the JAX package pins its kernels; a gradient row (one
    sample's three components) is held against its own largest component."""
    fused = so3_density.so3_wrapped_log_density_fused
    v, sigma = _inputs(n=n, B=B, seed=k, dtype=np.float32) if B >= 9 else (
        np.random.default_rng(k).normal(size=(n, B, 3)).astype(np.float32),
        np.full((B, 3), 0.7, np.float32))
    g = np.random.default_rng(5).normal(size=(n, B))
    grads = []
    for fn, dtype in ((fused, torch.float32),
                      (tso3.so3_wrapped_log_density_plain, torch.float64)):
        vt = torch.tensor(v, dtype=dtype, device=cuda_device,
                          requires_grad=True)
        st = torch.tensor(sigma, dtype=dtype, device=cuda_device,
                          requires_grad=True)
        before = fused.launches, fused.launches_backward
        out = fn(vt, st, k)
        (out * torch.tensor(g, dtype=dtype, device=cuda_device)).sum() \
            .backward()
        after = fused.launches, fused.launches_backward
        assert after == ((before[0] + 1, before[1] + 1) if fn is fused
                         else before)
        grads.append([t.double() for t in (out.detach(), vt.grad, st.grad)])
    (o1, dv1, ds1), (o2, dv2, ds2) = grads
    assert float(((o1 - o2).abs() - 1e-4 - 1e-4 * o2.abs()).max()) <= 0
    for a, b in ((dv1, dv2), (ds1, ds2)):
        err = (a - b).abs().amax(-1)
        assert float((err - 1e-3 - 1e-3 * b.abs().amax(-1)).max()) <= 0
