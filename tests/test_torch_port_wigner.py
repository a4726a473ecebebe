"""The PyTorch port's Wigner-D ops held against the JAX package's.

The port's plain chain, its dense matrix and its dispatcher (every impl,
``'pallas'`` being the plain version of the kernels K5/K6 on CPU tensors),
on CPU tensors, against the JAX package's plain chain and dense matrix (which
``tests/test_kernels.py`` pins to the TPU kernel), over L in {0, 1, 3, 6},
shared and per-sample spectra, transpose on and off. Tolerances: 1e-10 in
float64 (the same sums, two libraries), 2e-5 in float32 (sums of up to 13
terms of order 1, taken in another order).

Gradients: the plain chain's d angles and d spectrum under autograd
against ``jax.vjp`` of the JAX plain chain with the same cotangent, in
float64 at 1e-10, over L in {0, 1, 3}, shared and per-sample, transpose on
and off.

The CUDA kernels themselves run only on a card: ``test_kernel_matches_plain``,
``test_backward_kernel_matches_autograd`` and
``test_chain_kernels_repeat_bit_for_bit`` are marked ``cuda`` and skip
elsewhere.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lie_vae_tpu import ops as jops
from lie_vae_tpu_torch import ops as tops
from lie_vae_tpu_torch.ops.kernels import wigner_block, wigner_fused
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

TOLS = {np.float64: 1e-10, np.float32: 2e-5}
DEGREES = (0, 1, 3, 6)


def _inputs(L, shared, dtype, B=5, C=3, seed=0):
    rng = np.random.default_rng(seed + 10 * L + shared)
    S = (L + 1) ** 2
    angles = rng.uniform(-np.pi, np.pi, size=(B, 3)).astype(dtype)
    spec = rng.normal(size=(S, C) if shared else (B, S, C)).astype(dtype)
    return angles, spec


@pytest.fixture(scope="module")
def jax_reference():
    """JAX values for every case, computed once (jitted: one compile per
    case beats the op-by-op compiles of eager dispatch)."""
    apply = jax.jit(jops.block_wigner_apply_zjz, static_argnums=(2, 3))
    dense = jax.jit(jops.block_wigner_matrix, static_argnums=(1,))
    out = {}
    for dtype in TOLS:
        for L in DEGREES:
            for shared in (True, False):
                angles, spec = _inputs(L, shared, dtype)
                for tr in (False, True):
                    out[dtype, L, shared, tr] = np.asarray(apply(
                        jnp.asarray(angles), jnp.asarray(spec), L, tr))
            angles, _ = _inputs(L, True, dtype)
            out[dtype, L, "W"] = np.asarray(dense(jnp.asarray(angles), L))
    return out


@pytest.mark.parametrize("dtype", list(TOLS), ids=["f64", "f32"])
@pytest.mark.parametrize("L", DEGREES)
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "T"])
@pytest.mark.parametrize("impl", ["zjz", "dense", "fused", "auto", "pallas",
                                  "xla"])
def test_apply_matches_jax(jax_reference, dtype, L, shared, transpose, impl):
    angles, spec = _inputs(L, shared, dtype)
    got = tops.block_wigner_matrix_multiply(
        torch.tensor(angles), torch.tensor(spec), L, transpose=transpose,
        impl=impl)
    assert got.dtype == torch.tensor(spec).dtype
    np.testing.assert_allclose(got.numpy(),
                               jax_reference[dtype, L, shared, transpose],
                               rtol=0, atol=TOLS[dtype])


@pytest.mark.parametrize("dtype", list(TOLS), ids=["f64", "f32"])
@pytest.mark.parametrize("L", DEGREES)
def test_dense_matrix_matches_jax(jax_reference, dtype, L):
    angles, _ = _inputs(L, True, dtype)
    W = tops.block_wigner_matrix(torch.tensor(angles), L)
    np.testing.assert_allclose(W.numpy(), jax_reference[dtype, L, "W"],
                               rtol=0, atol=TOLS[dtype])


@pytest.mark.parametrize("l", (0, 1, 3))
def test_z_rot_mat_matches_jax(l):
    angle = np.random.default_rng(l).uniform(-np.pi, np.pi, 6)
    want = jax.jit(jops.z_rot_mat, static_argnums=1)(
        jnp.asarray(angle), l)
    np.testing.assert_allclose(tops.z_rot_mat(torch.tensor(angle), l).numpy(),
                               np.asarray(want), rtol=0, atol=1e-12)


def test_l1_intertwines_with_rotation():
    """The l = 1 block is P r^T P^T with P the (y, z, x) permutation: the
    representation convention, fixed absolutely."""
    gen = torch.Generator().manual_seed(0)
    r = tops.random_group_matrices(200, generator=gen, dtype=torch.float64,
                                   device="cpu")
    W = tops.block_wigner_matrix(tops.group_matrix_to_eazyz(r), 1)
    P = torch.tensor([[0.0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=torch.float64)
    expected = P @ r.transpose(-1, -2) @ P.T
    np.testing.assert_allclose(W[:, 1:, 1:].numpy(), expected.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_cpu_tensors_never_launch_the_kernel():
    angles, spec = _inputs(6, True, np.float32, B=4, C=10)
    fused = wigner_fused.block_wigner_matrix_multiply_fused
    before = fused.launches
    fused(torch.tensor(angles), torch.tensor(spec), 6)
    tops.block_wigner_matrix_multiply(torch.tensor(angles),
                                      torch.tensor(spec), 6)
    assert fused.launches == before


def test_pallas_impl_runs_the_plain_version_on_cpu():
    """impl='pallas' on CPU tensors is the plain version of K5/K6: the
    plain synthesise-then-apply product, with no launch counted."""
    angles, spec = _inputs(3, True, np.float32)
    fn = wigner_block.block_wigner_matrix_multiply_pallas
    before = (fn.launches, fn.launches_backward)
    a, x = torch.tensor(angles), torch.tensor(spec)
    got = tops.block_wigner_matrix_multiply(a, x, 3, impl="pallas")
    want = wigner_block.wigner_block_apply_plain(
        *wigner_block.trig_features(a, 3), x, 3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (fn.launches, fn.launches_backward) == before


def test_packed_j_holds_every_block():
    jp = wigner_fused.packed_j(6, "cpu")
    assert jp.shape == (455,)
    np.testing.assert_array_equal(
        jp[-169:].numpy(), tops.j_matrix(6).reshape(-1).astype(np.float32))


GRAD_DEGREES = (0, 1, 3)


@pytest.fixture(scope="module")
def jax_grads():
    """d angles and d spectrum of sum(out * G) for every case (jitted)."""
    def vjp(angles, spec, G, L, tr):
        _, pull = jax.vjp(
            lambda a, x: jops.block_wigner_apply_zjz(a, x, L, tr),
            angles, spec)
        return pull(G)

    vjp = jax.jit(vjp, static_argnums=(3, 4))
    out = {}
    for L in GRAD_DEGREES:
        for shared in (True, False):
            angles, spec = _inputs(L, shared, np.float64)
            G = np.random.default_rng(L).normal(
                size=(angles.shape[0],) + spec.shape[-2:])
            for tr in (False, True):
                out[L, shared, tr] = [np.asarray(a) for a in vjp(
                    jnp.asarray(angles), jnp.asarray(spec), jnp.asarray(G),
                    L, tr)]
    return out


@pytest.mark.parametrize("L", GRAD_DEGREES)
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "T"])
def test_plain_chain_grads_match_jax(jax_grads, L, shared, transpose):
    angles, spec = _inputs(L, shared, np.float64)
    G = np.random.default_rng(L).normal(size=(angles.shape[0],)
                                        + spec.shape[-2:])
    a = torch.tensor(angles, requires_grad=True)
    x = torch.tensor(spec, requires_grad=True)
    out = tops.block_wigner_matrix_multiply(a, x, L, transpose=transpose)
    (out * torch.tensor(G)).sum().backward()
    da, dx = jax_grads[L, shared, transpose]
    np.testing.assert_allclose(a.grad.numpy(), da, rtol=0, atol=1e-10)
    np.testing.assert_allclose(x.grad.numpy(), dx, rtol=0, atol=1e-10)


def test_cpu_training_never_launches_the_kernels():
    fused = wigner_fused.block_wigner_matrix_multiply_fused
    before = (fused.launches, fused.launches_residuals,
              fused.launches_backward)
    angles, spec = _inputs(3, True, np.float32)
    a = torch.tensor(angles, requires_grad=True)
    fused(a, torch.tensor(spec, requires_grad=True), 3).sum().backward()
    assert a.grad is not None
    assert (fused.launches, fused.launches_residuals,
            fused.launches_backward) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L", (0, 1, 3, 6, 10))
def test_kernel_matches_plain(cuda_device, L):
    """The CUDA kernel against the plain chain on the card, float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fused = wigner_fused.block_wigner_matrix_multiply_fused
    for shared in (True, False):
        for B, C in ((1, 1), (64, 10), (4103, 16)):
            angles, spec = _inputs(L, shared, np.float32, B=B, C=C)
            a = torch.tensor(angles, device=cuda_device)
            x = torch.tensor(spec, device=cuda_device)
            for tr in (False, True):
                before = fused.launches
                got = fused(a, x, L, transpose=tr)
                assert fused.launches == before + 1
                want = tops.block_wigner_apply_zjz(a, x, L, transpose=tr)
                tol = 1e-5 * max(1.0, float(x.abs().max()))
                assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("L", (0, 1, 3, 6, 10))
def test_backward_kernel_matches_autograd(cuda_device, L):
    """K2 (forward with residuals, then the backward kernel) against
    autograd of the plain chain on the card, float32: d angles and
    d spectrum within 1e-4 * max(1, max |reference|), sums of up to
    S * C * B float32 terms taken in another order."""
    fused = wigner_fused.block_wigner_matrix_multiply_fused
    for shared in (True, False):
        for B, C in ((1, 1), (64, 10), (4103, 16), (5, 40)):
            angles, spec = _inputs(L, shared, np.float32, B=B, C=C)
            G = torch.tensor(np.random.default_rng(L).normal(
                size=(B,) + spec.shape[-2:]), dtype=torch.float32,
                device=cuda_device)
            for tr in (False, True):
                grads = []
                for fn in (fused, tops.block_wigner_apply_zjz):
                    a = torch.tensor(angles, device=cuda_device,
                                     requires_grad=True)
                    x = torch.tensor(spec, device=cuda_device,
                                     requires_grad=True)
                    before = (fused.launches_residuals,
                              fused.launches_backward)
                    (fn(a, x, L, transpose=tr) * G).sum().backward()
                    after = (fused.launches_residuals,
                             fused.launches_backward)
                    assert after == ((before[0] + 1, before[1] + 1)
                                     if fn is fused else before)
                    grads.append((a.grad, x.grad))
                for got, want in zip(*grads):
                    tol = 1e-4 * max(1.0, float(want.abs().max()))
                    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
@pytest.mark.parametrize("B, C", [(64, 10), (64, 100), (4103, 10),
                                  (4103, 100), (5, 130)])
def test_chain_kernels_repeat_bit_for_bit(cuda_device, shared, B, C):
    """K1, K2's forward and K2's backward give the same bits twice on the
    same inputs: fixed-order sums, no atomics. C = 130 spans two channel
    tiles."""
    angles, spec = _inputs(6, shared, np.float32, B=B, C=C)
    a = torch.tensor(angles, device=cuda_device)
    x = torch.tensor(spec, device=cuda_device)
    G = torch.tensor(np.random.default_rng(B + C).normal(size=(B, 49, C)),
                     dtype=torch.float32, device=cuda_device)
    runs = []
    for _ in range(2):
        out = wigner_fused._launch(a, x, 6)
        res = wigner_fused._launch_residuals(a, x, 6)
        runs.append((out,) + res + wigner_fused._launch_backward(
            a, x, res[1], res[2], G, 6, True))
    for first, second in zip(*runs):
        assert torch.equal(first, second)
