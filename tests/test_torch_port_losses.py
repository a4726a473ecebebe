"""The port's regularizer losses held against the JAX package's, in float64.

- ``rotate_images`` ('gather': ``grid_sample``, bilinear, zeros outside,
  align-corners grid) and ``rotate_images_shear`` ('shear': the exact
  90-degree pre-rotation, then Paeth's three banded products) against the
  JAX functions (``map_coordinates``; ``einsum``) at 1e-10, on random
  images whose border pixels are nonzero, so that the taps that fall off
  the edge count: theta at 0, +-pi/2, +-pi, the ties of the wrap and of
  round(theta / (pi/2)) (odd multiples of pi/4, both signs, and beyond
  2 pi), and random angles, at 9x9 and 64x64;
- ``equivariance_loss`` with the JAX function's theta handed over (replayed
  from its key), on an encoder that both packages compute the same way (a
  linear map of the pixels, Gram-Schmidt to a rotation), both rotations and
  ``num_samples``; the loss, the per-example differences and the gradient
  in the encoder's weights;
- ``encoder_continuity_loss``: value, per-pair differences and gradient;
- a non-rotation encoding raises in both.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lie_vae_tpu.losses import continuity as jcont
from lie_vae_tpu.losses import equivariance as jeq
from lie_vae_tpu_torch.losses import (ROTATE_IMPLS, encoder_continuity_loss,
                                      equivariance_loss)
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

TOL = 1e-10
TIES = [math.pi / 4, -math.pi / 4, 3 * math.pi / 4, -3 * math.pi / 4,
        5 * math.pi / 4, -5 * math.pi / 4, 7 * math.pi / 4,
        9 * math.pi / 4]
EXACT = [0.0, math.pi / 2, -math.pi / 2, math.pi, -math.pi, 2 * math.pi]
THETAS = np.asarray(EXACT + TIES + list(
    np.random.default_rng(0).uniform(-7.0, 7.0, 10)))


def _images(n, size, seed):
    # a constant 0.5 frame keeps the border nonzero
    img = np.random.default_rng(seed).random((n, size, size, 3))
    img[:, [0, -1]] = img[:, :, [0, -1]] = 0.5
    return img


@pytest.fixture(scope="module")
def rotated():
    """The JAX rotations of each size, jitted once per function."""
    fns = {k: jax.jit(f) for k, f in jeq.ROTATE_IMPLS.items()}
    out = {}
    for size in (9, 64):
        img = _images(len(THETAS), size, size)
        for impl, fn in fns.items():
            out[impl, size] = (img, np.asarray(fn(jnp.asarray(img),
                                                  jnp.asarray(THETAS))))
    return out


@pytest.mark.parametrize("size", [9, 64])
@pytest.mark.parametrize("impl", ["gather", "shear"])
def test_rotation_matches_jax(rotated, impl, size):
    img, want = rotated[impl, size]
    got = ROTATE_IMPLS[impl](torch.tensor(img), torch.tensor(THETAS))
    assert got.dtype == torch.float64 and got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_taps_fall_off_the_edge(rotated):
    """At a diagonal angle the corners sample outside the image: zeros
    there (the frame is 0.5 inside), in both packages."""
    img, want = rotated["gather", 9]
    i = int(np.flatnonzero(np.isclose(THETAS, math.pi / 4))[0])
    assert want[i, 0, 0].max() == 0.0
    got = ROTATE_IMPLS["gather"](torch.tensor(img[i:i + 1]),
                                 torch.tensor(THETAS[i:i + 1]))
    assert float(got[0, 0, 0].abs().max()) == 0.0


@pytest.mark.parametrize("impl", ["gather", "shear"])
def test_rotation_by_multiples_of_90_is_exact(impl):
    """Exact 90-degree rotations move pixels without interpolating (the
    shear's pre-rotation is rot90)."""
    img = torch.tensor(_images(1, 9, 3))
    for k in range(4):
        got = ROTATE_IMPLS[impl](img, torch.tensor([k * math.pi / 2],
                                                   dtype=torch.float64))
        np.testing.assert_allclose(
            got.numpy(), np.rot90(img.numpy(), k, axes=(1, 2)), rtol=0,
            atol=1e-12)


def test_shear_rejects_non_square_images():
    with pytest.raises(ValueError, match="square"):
        ROTATE_IMPLS["shear"](torch.zeros((1, 8, 9, 3)), torch.zeros(1))


# --------------------------------------------------- equivariance loss

N, SIZE = 6, 16


def _jax_encoder(w):
    def encode(img):
        v = img.reshape(img.shape[0], -1) @ w
        e1 = v[:, :3] / jnp.linalg.norm(v[:, :3], axis=-1, keepdims=True)
        u2 = v[:, 3:] - jnp.sum(e1 * v[:, 3:], -1, keepdims=True) * e1
        e2 = u2 / jnp.linalg.norm(u2, axis=-1, keepdims=True)
        return jnp.stack([e1, e2, jnp.cross(e1, e2)], -2)
    return encode


def _port_encoder(w):
    def encode(img):
        v = img.reshape(img.shape[0], -1) @ w
        e1 = v[:, :3] / torch.linalg.norm(v[:, :3], dim=-1, keepdim=True)
        u2 = v[:, 3:] - torch.sum(e1 * v[:, 3:], -1, keepdim=True) * e1
        e2 = u2 / torch.linalg.norm(u2, dim=-1, keepdim=True)
        return torch.stack([e1, e2, torch.linalg.cross(e1, e2)], -2)
    return encode


@pytest.fixture(scope="module")
def eq_case():
    rng = np.random.default_rng(1)
    img = _images(N, SIZE, 2)
    w = rng.normal(size=(SIZE * SIZE * 3, 6)) / 10.0
    key = jax.random.PRNGKey(7)
    out = {}
    for impl in ("gather", "shear"):
        for num in (None, 4):
            @jax.jit
            def loss(w, img, impl=impl, num=num):
                enc = _jax_encoder(w)
                return jeq.equivariance_loss(enc, img, enc(img), key,
                                             num_samples=num,
                                             rotate_impl=impl)

            (value, diffs), grad = jax.jit(jax.value_and_grad(
                lambda w, img: loss(w, img), has_aux=True))(
                    jnp.asarray(w), jnp.asarray(img))
            out[impl, num] = (float(value), np.asarray(diffs),
                              np.asarray(grad))
    # the JAX function draws theta from its key in the images' dtype
    theta = np.asarray(jax.random.uniform(key, (N,), dtype=jnp.float64)
                       * 2.0 * math.pi)
    return img, w, theta, out


@pytest.mark.parametrize("num", [None, 4])
@pytest.mark.parametrize("impl", ["gather", "shear"])
def test_equivariance_loss_matches_jax(eq_case, impl, num):
    img, w, theta, out = eq_case
    value, diffs, grad = out[impl, num]
    n = num or N
    tw = torch.tensor(w, requires_grad=True)
    enc = _port_encoder(tw)
    x = torch.tensor(img)
    got, got_diffs = equivariance_loss(enc, x, enc(x), torch.tensor(
        theta[:n]), num_samples=num, rotate_impl=impl)
    assert got_diffs.shape == (n,)
    np.testing.assert_allclose(float(got.detach()), value, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_diffs.detach().numpy(), diffs, rtol=0,
                               atol=TOL * max(1.0, np.abs(diffs).max()))
    got.backward()
    np.testing.assert_allclose(tw.grad.numpy(), grad, rtol=0,
                               atol=TOL * max(1.0, np.abs(grad).max()))


def test_equivariance_loss_asserts_rotations():
    enc = torch.zeros((2, 4))
    with pytest.raises(AssertionError, match="Rotation matrix"):
        equivariance_loss(lambda x: enc, torch.zeros((2, 9, 9, 3)), enc,
                          torch.zeros(2))
    with pytest.raises(AssertionError, match="Rotation matrix"):
        jeq.equivariance_loss(lambda x: jnp.asarray(enc.numpy()),
                              jnp.zeros((2, 9, 9, 3)),
                              jnp.asarray(enc.numpy()), jax.random.PRNGKey(0))


# ------------------------------------------------------ continuity loss

@pytest.mark.parametrize("shape", [(8, 3, 3), (6, 4)])
def test_continuity_loss_matches_jax(shape):
    enc = np.random.default_rng(3).normal(size=shape)
    (value, diffs), grad = jax.value_and_grad(
        jcont.encoder_continuity_loss, has_aux=True)(jnp.asarray(enc))
    t = torch.tensor(enc, requires_grad=True)
    got, got_diffs = encoder_continuity_loss(t)
    assert got_diffs.shape == (shape[0] // 2,)
    np.testing.assert_allclose(float(got.detach()), float(value), rtol=TOL)
    np.testing.assert_allclose(got_diffs.detach().numpy(), np.asarray(diffs),
                               rtol=TOL)
    got.backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(grad), rtol=TOL,
                               atol=1e-14)
