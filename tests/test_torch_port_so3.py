"""The PyTorch port's SO(3) ops held against the JAX package's, in float64.

Inputs are drawn once with numpy and handed to both; they include v = 0
and rotations by theta near pi, where the guarded branches switch.
Tolerance 1e-10: the same formulas in float64, evaluated by two libraries.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lie_vae_tpu import distributions as jdist
from lie_vae_tpu import ops as jops
from lie_vae_tpu_torch import distributions as tdist
from lie_vae_tpu_torch import ops as tops

TOL = 1e-10


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=0, atol=tol)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(32, 3))
    v[0] = 0.0
    v[1] = [1e-6, -2e-6, 3e-7]                   # Taylor branch
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    thetas = np.array([np.pi, np.pi - 1e-5, np.pi - 1e-2, 2.8, 1e-3, 0.5])
    v = np.concatenate([v, axes * thetas[:, None]])
    R = np.asarray(jops.expmap(jnp.asarray(v)))
    q = rng.normal(size=(40, 4))
    return {"v": v, "R": R, "q": q, "v1": rng.normal(size=(16, 3)),
            "v2": rng.normal(size=(16, 3)),
            "angles": rng.uniform(-3, 3, size=(16, 3))}


@pytest.mark.parametrize("name,arg", [
    ("hat", "v"), ("expmap", "v"), ("logmap", "R"),
    ("group_matrix_to_quaternions", "R"), ("group_matrix_to_eazyz", "R"),
    ("quaternions_to_eazyz", "q"), ("quaternions_to_group_matrix", "q"),
    ("eazyz_to_group_matrix", "angles"),
])
def test_op_matches_jax(inputs, name, arg):
    x = inputs[arg]
    _close(getattr(tops, name)(_t(x)), getattr(jops, name)(jnp.asarray(x)))


def test_vee_inverts_hat(inputs):
    X = np.asarray(jops.hat(jnp.asarray(inputs["v"])))
    _close(tops.vee(_t(X)), jops.vee(jnp.asarray(X)))
    _close(tops.vee(tops.hat(_t(inputs["v"]))), inputs["v"])


def test_s2s2_gram_schmidt_matches_jax(inputs):
    v1, v2 = inputs["v1"], inputs["v2"]
    _close(tops.s2s2_gram_schmidt(_t(v1), _t(v2)),
           jops.s2s2_gram_schmidt(jnp.asarray(v1), jnp.asarray(v2)))


def test_expmap_gradient_finite_at_zero():
    v = torch.zeros(4, 3, dtype=torch.float64, requires_grad=True)
    tops.expmap(v).sum().backward()
    assert torch.isfinite(v.grad).all()
    # d/dv of exp(v) at 0 is hat(.): the sum over all entries is zero
    _close(v.grad, np.zeros((4, 3)))


def test_logmap_gradient_finite_near_pi(inputs):
    R = _t(inputs["R"]).requires_grad_(True)
    tops.logmap(R).sum().backward()
    assert torch.isfinite(R.grad).all()


def test_random_group_matrices_are_rotations():
    gen = torch.Generator().manual_seed(0)
    R = tops.random_group_matrices(256, generator=gen, dtype=torch.float64,
                                   device="cpu")
    eye = torch.eye(3, dtype=torch.float64).expand(256, 3, 3)
    _close(R.transpose(-1, -2) @ R, eye, 1e-12)
    assert (torch.linalg.det(R) > 0).all()
    q = tops.random_quaternions(256, generator=gen, dtype=torch.float64,
                                device="cpu")
    _close(torch.linalg.norm(q, dim=-1), np.ones(256), 1e-12)


def test_sample_so3_matches_jax_with_shared_noise(inputs):
    rng = np.random.default_rng(1)
    mu = inputs["R"][:8]
    sigma = rng.uniform(0.1, 2.0, size=(8, 3))
    eps = rng.normal(size=(2, 8, 3))
    got = tdist.sample_so3(_t(mu), _t(sigma), n=2, eps=_t(eps))
    want = jnp.asarray(mu) @ jops.expmap(jnp.asarray(eps * sigma))
    _close(got.z, want)
    _close(got.inner.z, eps * sigma)


def test_gaussian_stats_match_jax():
    rng = np.random.default_rng(2)
    mu, sigma = rng.normal(size=(5, 4)), rng.uniform(0.2, 2, size=(5, 4))
    z = rng.normal(size=(3, 5, 4))
    got = tdist.GaussianStats(_t(mu), _t(sigma), _t(z))
    want = jdist.GaussianStats(jnp.asarray(mu), jnp.asarray(sigma),
                               jnp.asarray(z))
    _close(got.kl(), want.kl())
    _close(got.log_posterior(), want.log_posterior())
    _close(got.log_prior(), want.log_prior())
