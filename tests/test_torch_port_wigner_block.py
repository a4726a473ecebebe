"""The port's synthesise-then-apply Wigner product (the plain version of the
kernels K5/K6) held against the JAX package's.

- ``block_wigner_matrix_multiply_pallas`` on CPU tensors (the trig
  features, then ``wigner_block_apply_plain``) against the JAX package's
  ``block_wigner_matrix_multiply(impl='dense')`` in float64 at 1e-10, over
  L in {0, 2, 3}, B in {1, 5, 17}, shared and per-sample spectra, transpose
  on and off: the same sums in two libraries;
- its autograd (angles and spectrum) against ``jax.vjp`` of the same with
  the same cotangent, in float64 at 1e-9;
- one float32 case against the JAX package's own Pallas kernel run in
  interpret mode, at the JAX tests' 2e-5 (``tests/test_kernels.py``);
- ``impl='pallas'`` and ``'xla'`` of the port's dispatcher on CPU tensors,
  which launch no kernel.

The CUDA kernels run only on a card: the tests marked ``cuda`` hold K5
and K6 against the plain version there, and to their own bits on a second
run, and skip elsewhere. Their column arithmetic is emulated on the CPU in
``test_torch_port_wigner_block_column.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lie_vae_tpu import ops as jops
from lie_vae_tpu.ops.kernels.wigner_block import (
    block_wigner_matrix_multiply_pallas as jax_pallas)
from lie_vae_tpu_torch import ops as tops
from lie_vae_tpu_torch.ops.kernels import wigner_block
from lie_vae_tpu_torch.ops.kernels import wigner_fused
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

DEGREES = (0, 2, 3)
BATCHES = (1, 5, 17)
CASES = [(L, B, shared, tr) for L in DEGREES for B in BATCHES
         for shared in (True, False) for tr in (False, True)]


def _inputs(L, B, shared, dtype=np.float64, C=3):
    rng = np.random.default_rng(100 * L + 10 * B + shared)
    S = (L + 1) ** 2
    angles = rng.uniform(-np.pi, np.pi, size=(B, 3)).astype(dtype)
    spec = rng.normal(size=(S, C) if shared else (B, S, C)).astype(dtype)
    G = rng.normal(size=(B, S, C)).astype(dtype)
    return angles, spec, G


@pytest.fixture(scope="module")
def jax_reference():
    """(out, d angles, d spectrum) of the JAX dense product for every case,
    computed once (jitted)."""
    def value_and_vjp(angles, spec, G, L, tr):
        out, pull = jax.vjp(
            lambda a, x: jops.block_wigner_matrix_multiply(
                a, x, L, transpose=tr, impl="dense"), angles, spec)
        return (out,) + pull(G)

    fn = jax.jit(value_and_vjp, static_argnums=(3, 4))
    return {(L, B, shared, tr): [np.asarray(a) for a in fn(
                *map(jnp.asarray, _inputs(L, B, shared)), L, tr)]
            for L, B, shared, tr in CASES}


@pytest.mark.parametrize("L,B,shared,transpose", CASES,
                         ids=[f"L{L}-B{B}-{'shared' if s else 'batched'}-"
                              f"{'T' if t else 'fwd'}"
                              for L, B, s, t in CASES])
def test_plain_matches_jax_dense(jax_reference, L, B, shared, transpose):
    angles, spec, G = _inputs(L, B, shared)
    a = torch.tensor(angles, requires_grad=True)
    x = torch.tensor(spec, requires_grad=True)
    out = wigner_block.block_wigner_matrix_multiply_pallas(
        a, x, L, transpose=transpose)
    assert out.dtype == torch.float64
    want, da, dx = jax_reference[L, B, shared, transpose]
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-10)
    (out * torch.tensor(G)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), da, rtol=0, atol=1e-9)
    np.testing.assert_allclose(x.grad.numpy(), dx, rtol=0, atol=1e-9)


def test_plain_matches_jax_pallas_interpret():
    """One float32 case against the JAX Pallas kernel in interpret mode
    (its batch of 5 padded to its block of 8), and the gradients of both."""
    L, B = 2, 5
    angles, spec, G = _inputs(L, B, False, np.float32)

    def value_and_vjp(angles, spec, G):
        out, pull = jax.vjp(lambda a, x: jax_pallas(a, x, L, interpret=True),
                            angles, spec)
        return (out,) + pull(G)

    want = [np.asarray(v) for v in jax.jit(value_and_vjp)(
        jnp.asarray(angles), jnp.asarray(spec), jnp.asarray(G))]
    a = torch.tensor(angles, requires_grad=True)
    x = torch.tensor(spec, requires_grad=True)
    out = wigner_block.block_wigner_matrix_multiply_pallas(a, x, L)
    (out * torch.tensor(G)).sum().backward()
    for got, ref in zip((out.detach(), a.grad, x.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(ref).max()))


def test_packed_coeffs_hold_every_nonzero():
    """The packed tensor the kernels read carries every non-zero of C:
    sum_l (2l+1)^3 values, and C rebuilt from it is C."""
    for L in (0, 3, 6):
        packed = wigner_block._packed_coeffs_np(L)
        assert packed.shape == (sum((2 * l + 1) ** 3 for l in range(L + 1)),)
        _, _, C = tops.wigner._coeffs(L)
        rebuilt = np.zeros_like(C)
        k = 0
        for l in range(L + 1):
            o, n = l * l, 2 * l + 1
            slots = list(range(l + 1)) + [L + m for m in range(1, l + 1)]
            block = packed[k:k + n ** 3].reshape(n, n, n)
            rebuilt[slots, o:o + n, o:o + n] = block
            k += n ** 3
        np.testing.assert_allclose(rebuilt, C, rtol=0, atol=1e-7)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_dispatcher_routes_on_cpu(impl):
    """impl='pallas' runs the plain version of K5 on CPU tensors and 'xla'
    the plain chain; neither launches a kernel."""
    angles, spec, _ = _inputs(3, 5, True)
    fn = wigner_block.block_wigner_matrix_multiply_pallas
    fused = wigner_fused.block_wigner_matrix_multiply_fused
    before = (fn.launches, fn.launches_backward, fused.launches,
              fused.launches_residuals, fused.launches_backward)
    a = torch.tensor(angles, requires_grad=True)
    got = tops.block_wigner_matrix_multiply(a, torch.tensor(spec), 3,
                                            impl=impl)
    got.sum().backward()
    want = tops.block_wigner_apply_zjz(torch.tensor(angles),
                                       torch.tensor(spec), 3)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=0,
                               atol=1e-12)
    assert (fn.launches, fn.launches_backward, fused.launches,
            fused.launches_residuals, fused.launches_backward) == before


def test_bad_inputs_raise():
    fn = wigner_block.block_wigner_matrix_multiply_pallas
    with pytest.raises(ValueError, match="spectrum must be"):
        fn(torch.zeros(2, 3), torch.zeros(5, 2), 1)
    with pytest.raises(ValueError, match="angles must be"):
        fn(torch.zeros(2, 2), torch.zeros(4, 2), 1)
    assert fn(torch.zeros(0, 3), torch.zeros(4, 2), 1).shape == (0, 4, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L", (0, 1, 3, 6, 10))
def test_kernels_match_plain(cuda_device, L):
    """K5 and K6 against the plain version and its autograd on the card,
    float32: the output within 1e-5 * max(1, max|x|); K6's d angles and d
    spectrum (``_launch_backward``, from the angles) and the gradients
    through the autograd Function within 1e-4 * max(1, max|reference|)
    (sums of up to S * C and, for a shared spectrum, B * S * C terms taken
    in another order)."""
    fn = wigner_block.block_wigner_matrix_multiply_pallas
    for shared in (True, False):
        for B, C in ((1, 1), (17, 10), (4103, 16)):
            angles, spec, G = _inputs(L, B, shared, np.float32, C=C)
            G = torch.tensor(G, device=cuda_device)
            for tr in (False, True):
                res = []
                for use_kernel in (True, False):
                    a = torch.tensor(angles, device=cuda_device,
                                     requires_grad=True)
                    x = torch.tensor(spec, device=cuda_device,
                                     requires_grad=True)
                    before = (fn.launches, fn.launches_backward)
                    if use_kernel:
                        out = fn(a, x, L, transpose=tr)
                    else:
                        out = wigner_block.wigner_block_apply_plain(
                            *wigner_block.trig_features(a, L), x, L,
                            transpose=tr)
                    (out * G).sum().backward()
                    after = (fn.launches, fn.launches_backward)
                    assert after == ((before[0] + 1, before[1] + 1)
                                     if use_kernel else before)
                    res.append((out.detach(), a.grad, x.grad))
                (o1, da1, dx1), (o2, da2, dx2) = res
                assert float((o1 - o2).abs().max()) <= 1e-5 * max(
                    1.0, float(abs(spec).max()))
                dang, dspec = wigner_block._launch_backward(
                    a.detach(), x.detach(), G, L, tr, True)
                if shared:
                    dspec = dspec.sum(0)
                for got, want in ((da1, da2), (dx1, dx2), (dang, da2),
                                  (dspec, dx2)):
                    tol = 1e-4 * max(1.0, float(want.abs().max()))
                    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit(cuda_device):
    """K5 and K6 twice on the same inputs give the same bits: every sum runs
    in a fixed order, with no atomics."""
    for shared in (True, False):
        for B, C in ((64, 10), (4103, 100)):
            angles, spec, G = (torch.tensor(v, device=cuda_device) for v in
                               _inputs(6, B, shared, np.float32, C=C))
            runs = [(wigner_block._launch(angles, spec, 6, False),)
                    + wigner_block._launch_backward(angles, spec, G, 6,
                                                    False, True)
                    for _ in range(2)]
            assert all(torch.equal(p, q) for p, q in zip(*runs))
