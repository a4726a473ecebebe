"""The tables the chain kernels (``csrc/wigner_chain.cu``) read, held to the
plain chain on the CPU.

The kernels hold J_0 .. J_16 in constant memory (``wigner_fused.j_table``,
built in Python) and multiply only the entries ``wigner_fused.j_coupled``
allows. Here:

- every entry of every table that ``j_coupled`` skips is rounding noise of
  the float64 tables (below 1e-14), and ``j_table`` puts J_l where the
  kernels look for it;
- a plain torch chain that does what one kernel thread does per column
  (gather the 2l+1 rows of degree l, rotate pairs (k, 2l-k), multiply by
  J_l read from ``j_table`` over the coupled entries only; the table in
  the chain's dtype, float32 being what the kernels hold) matches the
  port's ``block_wigner_apply_zjz`` (1e-12 in float64, 2e-5 in float32)
  and the JAX package's (1e-10 in float64), and its per-column backward
  (A = J Z(-a) G, V = J Z(-b) A, dx = Z(-g) V and the three angle terms)
  matches autograd of ``block_wigner_apply_zjz`` (1e-10 in float64), over
  L in {0, 1, 3, 6, 10}, shared and per-sample spectra, transpose on and
  off.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lie_vae_tpu import ops as jops
from lie_vae_tpu_torch import ops as tops
from lie_vae_tpu_torch.ops.kernels import wigner_fused
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

DEGREES = (0, 1, 3, 6, 10)
NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def _inputs(L, shared, dtype, B=4, C=3, seed=1):
    rng = np.random.default_rng(seed + 10 * L + shared)
    S = (L + 1) ** 2
    angles = rng.uniform(-np.pi, np.pi, size=(B, 3)).astype(dtype)
    spec = rng.normal(size=(S, C) if shared else (B, S, C)).astype(dtype)
    G = rng.normal(size=(B, S, C)).astype(dtype)
    return angles, spec, G


def _j_block(l, dtype):
    """J_l as the kernels read it: from ``j_table`` at l (4 l^2 - 1) / 3,
    the entries ``j_coupled`` skips left out."""
    d, o = 2 * l + 1, l * (4 * l * l - 1) // 3
    table = torch.as_tensor(wigner_fused.j_table(NP_DTYPE[dtype])
                            [o:o + d * d]).reshape(d, d)
    mask = torch.tensor([[wigner_fused.j_coupled(l, i, k) for k in range(d)]
                         for i in range(d)])
    return torch.where(mask, table, torch.zeros((), dtype=dtype))


def _z(l, t, v, sgn=1.0):
    """Z(sgn t) on columns v (B, C, d): pair (k, 2l - k) rotated by m = l - k."""
    f = torch.arange(l, -l - 1, -1, dtype=v.dtype)
    c = torch.cos(f.abs() * t[:, None])[:, None, :]
    s = sgn * torch.sign(f) * torch.sin(f.abs() * t[:, None])
    return c * v + s[:, None, :] * v.flip(-1)


def _dz_dot(l, t, p, h):
    """sum over a column of p * (d/dt Z(t) h), per sample and channel."""
    f = torch.arange(l, -l - 1, -1, dtype=h.dtype)
    m = f.abs()
    c = torch.cos(m * t[:, None])[:, None, :]
    s = torch.sin(m * t[:, None])[:, None, :]
    return (p * (-m * s * h + f * c * h.flip(-1))).sum(-1)


def _columns(x, l, B):
    """The columns (B, C, d) of degree l: rows l^2 .. l^2 + 2l gathered."""
    rows = torch.arange(l * l, l * l + 2 * l + 1)
    x = x.expand(B, *x.shape[-2:]) if x.dim() == 2 else x
    return x[:, rows, :].transpose(1, 2)


def column_chain(angles, x, L, transpose=False):
    """out = W(angles) x one degree's columns at a time, as the kernels."""
    a, b, g = angles.unbind(-1)
    if transpose:
        a, b, g = -g, -b, -a
    B, C = angles.shape[0], x.shape[-1]
    out = torch.empty((B, (L + 1) ** 2, C), dtype=x.dtype)
    for l in range(L + 1):
        J = _j_block(l, x.dtype)
        v = _z(l, g, _columns(x, l, B)) @ J.T        # y = J Z(g) x
        v = _z(l, b, v) @ J.T                        # z = J Z(b) y
        out[:, l * l:(l + 1) ** 2, :] = _z(l, a, v).transpose(1, 2)
    return out


def column_chain_backward(angles, x, G, L):
    """(dangles, dx per sample) of sum(out * G), the kernels' backward."""
    a, b, g = angles.unbind(-1)
    B, C = angles.shape[0], x.shape[-1]
    dangles = torch.zeros((B, 3), dtype=x.dtype)
    dx = torch.empty((B, (L + 1) ** 2, C), dtype=x.dtype)
    for l in range(L + 1):
        J = _j_block(l, x.dtype)
        hx = _columns(x, l, B)
        hy = _z(l, g, hx) @ J.T
        hz = _z(l, b, hy) @ J.T
        Gl = _columns(G, l, B)
        dangles[:, 0] += _dz_dot(l, a, Gl, hz).sum(-1)
        A = _z(l, a, Gl, -1.0) @ J.T
        dangles[:, 1] += _dz_dot(l, b, A, hy).sum(-1)
        V = _z(l, b, A, -1.0) @ J.T
        dangles[:, 2] += _dz_dot(l, g, V, hx).sum(-1)
        dx[:, l * l:(l + 1) ** 2, :] = _z(l, g, V, -1.0).transpose(1, 2)
    return dangles, dx


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX plain chain in float64 for every degree and spectrum kind
    (jitted: one compile per case)."""
    apply = jax.jit(jops.block_wigner_apply_zjz, static_argnums=(2, 3))
    out = {}
    for L in DEGREES:
        for shared in (True, False):
            angles, spec, _ = _inputs(L, shared, np.float64)
            out[L, shared] = np.asarray(apply(jnp.asarray(angles),
                                              jnp.asarray(spec), L, False))
    return out


def test_j_coupled_skips_only_zeros():
    """Every table entry the kernels skip is 0 up to the float64 tables'
    rounding, for every degree the tables hold."""
    assert wigner_fused.MAX_DEGREE == 16
    worst, kept = 0.0, 0
    for l in range(wigner_fused.MAX_DEGREE + 1):
        J, d = tops.j_matrix(l), 2 * l + 1
        mask = np.array([[wigner_fused.j_coupled(l, i, k) for k in range(d)]
                         for i in range(d)])
        assert (mask == mask.T).all()
        if (~mask).any():
            worst = max(worst, float(np.abs(J[~mask]).max()))
        kept += int(mask.sum())
    assert worst < 1e-14
    # about a quarter of the 6545 entries are multiplied (43 of 169 at l = 6)
    assert kept == 1649


def test_j_table_places_every_block():
    table = wigner_fused.j_table()
    assert table.dtype == np.float32 and table.shape == (6545,)
    assert table.flags["C_CONTIGUOUS"]
    for l in range(wigner_fused.MAX_DEGREE + 1):
        o, d = l * (4 * l * l - 1) // 3, 2 * l + 1
        np.testing.assert_array_equal(
            table[o:o + d * d].reshape(d, d),
            tops.j_matrix(l).astype(np.float32))


@pytest.mark.parametrize("L", DEGREES)
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
def test_column_chain_matches_plain_and_jax(jax_chain, L, shared):
    angles, spec, _ = _inputs(L, shared, np.float64)
    a, x = torch.tensor(angles), torch.tensor(spec)
    got = column_chain(a, x, L)
    np.testing.assert_allclose(got.numpy(), jax_chain[L, shared], rtol=0,
                               atol=1e-10)
    for tr in (False, True):
        np.testing.assert_allclose(
            column_chain(a, x, L, transpose=tr).numpy(),
            tops.block_wigner_apply_zjz(a, x, L, transpose=tr).numpy(),
            rtol=0, atol=1e-12)
    # float32, the kernels' type: the table's float32 J against the plain
    a32, x32 = a.float(), x.float()
    np.testing.assert_allclose(
        column_chain(a32, x32, L).numpy(),
        tops.block_wigner_apply_zjz(a32, x32, L).numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("L", DEGREES)
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "T"])
def test_column_backward_matches_autograd(L, shared, transpose):
    angles, spec, G = _inputs(L, shared, np.float64)
    a = torch.tensor(angles, requires_grad=True)
    x = torch.tensor(spec, requires_grad=True)
    Gt = torch.tensor(G)
    out = tops.block_wigner_apply_zjz(a, x, L, transpose=transpose)
    da_ref, dx_ref = torch.autograd.grad(out, (a, x), Gt)
    # the kernels take the angles of the chain they run: flipped for W^T,
    # and the flip's own backward applied to their d angles
    run = -a.detach().flip(-1) if transpose else a.detach()
    dang, dx = column_chain_backward(run, x.detach(), Gt, L)
    if transpose:
        dang = -dang.flip(-1)
    if shared:
        dx = dx.sum(0)
    np.testing.assert_allclose(dang.numpy(), da_ref.numpy(), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(dx.numpy(), dx_ref.numpy(), rtol=0,
                               atol=1e-10)
