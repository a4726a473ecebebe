"""The coefficient table the synthesise-then-apply kernels
(``csrc/wigner_block.cu``, K5/K6) read, and a torch emulation of their
per-column work, held to the plain version on the CPU.

The kernels run one thread per (sample, degree, channel) column:
u = Z(g) x, w = d(b) u with d u = sum_m t_m(b) C_m u over the coefficients
that can be non-zero only, out = Z(a) w; W^T is the same at (-g, -b, -a).
Here:

- every coefficient the kernels skip is rounding noise of the float64
  coefficients (below 1e-14) for every degree 0 .. 16, the blocks of
  ``wigner_block.coupled_blocks`` are what J's coupling rule
  (``wigner_fused.j_coupled``) implies, and the source's closed forms of
  the row groups give those blocks;
- ``wigner_block.c_table`` puts each kept coefficient where the kernels
  look for it, and the cosine slots are symmetric and the sine slots
  antisymmetric, which is why W^T is the product at the flipped angles;
- a torch emulation of one thread's column work (the table in the
  emulation's dtype, float32 being what the kernels hold) matches the
  port's plain version (1e-12 in float64, 2e-5 in float32) and the JAX
  package's dense ``block_wigner_matrix_multiply`` (1e-10 in float64), and
  its backward, with the chain rule through the trig features folded in
  as the kernels do it, matches autograd of ``trig_features`` +
  ``wigner_block_apply_plain`` (1e-10 in float64), over L in
  {0, 1, 3, 6, 10}, shared and per-sample spectra, transpose on and off.
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

DEGREES = (0, 1, 3, 6, 10)
ALL_DEGREES = range(wigner_block.MAX_DEGREE + 1)
NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def _inputs(L, shared, dtype, B=4, C=3, seed=3):
    """angles (B, 3), the same for both spectrum kinds; the spectrum and a
    cotangent."""
    angles = np.random.default_rng(seed + 10 * L).uniform(
        -np.pi, np.pi, size=(B, 3)).astype(dtype)
    rng = np.random.default_rng(seed + 10 * L + 1 + shared)
    S = (L + 1) ** 2
    spec = rng.normal(size=(S, C) if shared else (B, S, C)).astype(dtype)
    G = rng.normal(size=(B, S, C)).astype(dtype)
    return angles, spec, G


def _slot_index(L, l, s):
    """The slot of ``_coeffs(L)`` that slot s of degree l is."""
    return s if s <= l else L + s - l


def _coupling(l):
    """J_l's coupling mask as the chain kernels' rule gives it."""
    d = 2 * l + 1
    return np.array([[wigner_fused.j_coupled(l, i, k) for k in range(d)]
                     for i in range(d)])


def _mask_from_blocks(l, s):
    n = 2 * l + 1
    mask = np.zeros((n, n), bool)
    for rows, cols in wigner_block.coupled_blocks(l, s):
        assert not mask[np.ix_(rows, cols)].any()     # blocks are disjoint
        mask[np.ix_(rows, cols)] = True
    return mask


@pytest.mark.parametrize("l", ALL_DEGREES)
def test_skipped_coefficients_are_zero(l):
    """The blocks are what J's coupling implies: C_m[p, q] can be non-zero
    only where J couples p to c and c to q for some c with |f_c| = m (c
    mirrored to 2l - c for p in the sine slots); every coefficient outside
    them is below 1e-14."""
    L = wigner_block.MAX_DEGREE
    _, _, C = tops.wigner._coeffs(L)
    J, n, o = _coupling(l), 2 * l + 1, l * l
    for s in range(2 * l + 1):
        m = s if s <= l else s - l
        rule = np.zeros((n, n), bool)
        for c in range(n):
            if abs(l - c) == m and (s <= l or l != c):
                p_of = c if s <= l else 2 * l - c
                rule |= np.outer(J[:, p_of], J[c, :])
        mask = _mask_from_blocks(l, s)
        assert (mask == rule).all(), (l, s)
        block = C[_slot_index(L, l, s), o:o + n, o:o + n]
        if (~mask).any():
            assert np.abs(block[~mask]).max() < 1e-14, (l, s)


def test_kept_counts():
    """597 coefficients for L = 6 against the 4753 of the degree blocks;
    degrees 0 .. 14 fit the 64 KB of constant memory, 15 and 16 do not."""
    assert wigner_block.c_offset(7) == 597
    assert sum((2 * l + 1) ** 3 for l in range(7)) == 4753
    n_const = wigner_block.c_offset(wigner_block.CONST_DEGREE + 1)
    assert n_const == 12489 and 4 * n_const <= 60 * 1024
    assert wigner_block.c_offset(17) == 20617
    assert 4 * wigner_block.c_offset(17) > 64 * 1024


# The source's closed forms: group g = 2 (f <= 0) + (|f| odd) of degree l
# has grp_size rows spaced by 2 from grp_first; J_l couples g to partner.
def _grp_size(l, g):
    return ((l + 1) // 2 if g & 1 else l // 2 + 1) if g >= 2 else \
        ((l + 1) // 2 if g & 1 else l // 2)


def _grp_first(l, g):
    return l + (g & 1) if g >= 2 else (l + (g & 1)) % 2


def _blk(l, s, b):
    """The source's blk_rows, blk_cols."""
    m = s if s <= l else s - l
    if m == 0:
        return wigner_block._partner(l, 2), wigner_block._partner(l, 2)
    plus, minus = m & 1, 2 + (m & 1)
    rows = plus if (b == 0) == (s <= l) else minus
    return (wigner_block._partner(l, rows),
            wigner_block._partner(l, plus if b == 0 else minus))


@pytest.mark.parametrize("l", ALL_DEGREES)
def test_source_closed_forms_give_the_blocks(l):
    for g in range(4):
        rows = wigner_block._group_rows(l, g)
        assert rows == list(range(_grp_first(l, g), 2 * l + 1, 2))[
            :_grp_size(l, g)]
        assert len(rows) == _grp_size(l, g)
    for s in range(2 * l + 1):
        blocks = wigner_block.coupled_blocks(l, s)
        for b, (rows, cols) in enumerate(blocks):
            R, Q = _blk(l, s, b)
            assert (rows, cols) == (wigner_block._group_rows(l, R),
                                    wigner_block._group_rows(l, Q))


def test_table_places_every_coefficient():
    """Entry k of the table is the coefficient the kernels read there:
    degree by degree, slot by slot, block by block, row-major."""
    L = wigner_block.MAX_DEGREE
    _, _, C = tops.wigner._coeffs(L)
    table = wigner_block.c_table()
    assert table.dtype == np.float32 and table.flags["C_CONTIGUOUS"]
    assert table.shape == (wigner_block.c_offset(L + 1),)
    k = 0
    for l in ALL_DEGREES:
        assert k == wigner_block.c_offset(l)
        o = l * l
        for s in range(2 * l + 1):
            for rows, cols in wigner_block.coupled_blocks(l, s):
                want = C[_slot_index(L, l, s)][
                    np.ix_([o + p for p in rows], [o + q for q in cols])]
                got = table[k:k + want.size].reshape(want.shape)
                np.testing.assert_array_equal(got, want.astype(np.float32))
                k += want.size
    assert k == table.size


@pytest.mark.parametrize("l", ALL_DEGREES)
def test_transpose_is_the_product_at_flipped_angles(l):
    """Cosine slots symmetric, sine slots antisymmetric: d(b)^T = d(-b),
    so W(a, b, g)^T = W(-g, -b, -a), which the kernels run for W^T."""
    L = wigner_block.MAX_DEGREE
    _, _, C = tops.wigner._coeffs(L)
    o, n = l * l, 2 * l + 1
    for s in range(2 * l + 1):
        block = C[_slot_index(L, l, s), o:o + n, o:o + n]
        sign = 1.0 if s <= l else -1.0
        np.testing.assert_allclose(block.T, sign * block, rtol=0, atol=1e-14)


def _trig(theta, l):
    """(cos m t, sin m t) for m = 0 .. l, (B, l+1) each, as the kernels form
    them: the product m t in the working dtype, then cos and sin."""
    m = torch.arange(l + 1, dtype=theta.dtype)
    arg = m * theta[:, None]
    return torch.cos(arg), torch.sin(arg)


def _zrot(v, trig, l, sgn=1.0):
    """Z(sgn t) on columns v (B, 2l+1, C): pair (k, 2l - k) at m = l - k."""
    c, s = trig
    k = torch.arange(2 * l + 1)
    m = (l - k).abs()
    sign = torch.sign(torch.as_tensor(l - k, dtype=v.dtype))
    cv = c[:, m][:, :, None]
    sv = (sgn * sign * s[:, m])[:, :, None]
    return cv * v + sv * v.flip(1)


def _omega_dot(p, h, l):
    """sum_i f_i p_i h_rev(i) over a column, per sample and channel."""
    f = torch.arange(l, -l - 1, -1, dtype=p.dtype)
    return (f[None, :, None] * p * h.flip(1)).sum(1)


def _blocks(l, dtype):
    """(slot, rows, cols, coefficient block) of degree l as the kernels read
    them from the table in ``dtype``."""
    table = torch.as_tensor(wigner_block.c_table(NP_DTYPE[dtype]))
    k = wigner_block.c_offset(l)
    out = []
    for s in range(2 * l + 1):
        for rows, cols in wigner_block.coupled_blocks(l, s):
            size = len(rows) * len(cols)
            out.append((s, rows, cols,
                        table[k:k + size].reshape(len(rows), len(cols))))
            k += size
    return out


def _slot_trig(tb, l, s):
    """t_s(b) and its derivative in b, per sample."""
    c, sn = tb
    m = s if s <= l else s - l
    if s <= l:
        return c[:, m], -m * sn[:, m]
    return sn[:, m], m * c[:, m]


def _run_angles(angles, transpose):
    a, b, g = angles.unbind(-1)
    return (-g, -b, -a) if transpose else (a, b, g)


def _columns(x, l, B):
    x = x.expand(B, *x.shape[-2:]) if x.dim() == 2 else x
    return x[:, l * l:(l + 1) ** 2, :]


def column_apply(angles, x, L, transpose=False):
    """out = W(angles) x one degree's columns at a time, as the kernels."""
    a, b, g = _run_angles(angles, transpose)
    B, C = angles.shape[0], x.shape[-1]
    out = torch.empty((B, (L + 1) ** 2, C), dtype=x.dtype)
    for l in range(L + 1):
        ta, tb, tg = (_trig(t, l) for t in (a, b, g))
        u = _zrot(_columns(x, l, B), tg, l)                   # u = Z(g) x
        w = torch.zeros_like(u)
        for s, rows, cols, T in _blocks(l, x.dtype):         # w = d(b) u
            t, _ = _slot_trig(tb, l, s)
            acc = torch.einsum("pq,bqc->bpc", T, u[:, cols, :])
            w[:, rows, :] += t[:, None, None] * acc
        out[:, l * l:(l + 1) ** 2, :] = _zrot(w, ta, l)       # Z(a) w
    return out


def column_backward(angles, x, G, L, transpose=False):
    """(dangles, dx per sample) of sum(out * G), as the kernels: per column
    gw = Z(-a) G, u = Z(g) x, one pass over the table for w = d u,
    du = d^T gw and dt_s = <gw, C_s u>; then da = <gw, Omega w>,
    db = sum_s dt_s t_s'(b), dg = <du, Omega u>, dx = Z(-g) du."""
    a, b, g = _run_angles(angles, transpose)
    B, C = angles.shape[0], x.shape[-1]
    dang = torch.zeros((B, 3), dtype=x.dtype)
    dx = torch.empty((B, (L + 1) ** 2, C), dtype=x.dtype)
    for l in range(L + 1):
        ta, tb, tg = (_trig(t, l) for t in (a, b, g))
        gw = _zrot(_columns(G, l, B), ta, l, -1.0)
        u = _zrot(_columns(x, l, B), tg, l)
        w, du = torch.zeros_like(u), torch.zeros_like(u)
        for s, rows, cols, T in _blocks(l, x.dtype):
            t, dt_db = _slot_trig(tb, l, s)
            acc = torch.einsum("pq,bqc->bpc", T, u[:, cols, :])
            w[:, rows, :] += t[:, None, None] * acc
            du[:, cols, :] += t[:, None, None] * torch.einsum(
                "pq,bpc->bqc", T, gw[:, rows, :])
            dang[:, 1] += (gw[:, rows, :] * acc).sum((1, 2)) * dt_db
        dang[:, 0] += _omega_dot(gw, w, l).sum(-1)
        dang[:, 2] += _omega_dot(du, u, l).sum(-1)
        dx[:, l * l:(l + 1) ** 2, :] = _zrot(du, tg, l, -1.0)
    if transpose:     # the kernels ran at (-g, -b, -a)
        dang = -dang.flip(-1)
    return dang, dx


@pytest.fixture(scope="module")
def jax_dense():
    """The JAX dense product in float64 for every degree, spectrum kind and
    transpose: one jitted function per degree."""
    def cases(angles, shared, batched, L):
        return [jops.block_wigner_matrix_multiply(angles, x, L,
                                                  transpose=tr, impl="dense")
                for x in (shared, batched) for tr in (False, True)]

    fn = jax.jit(cases, static_argnums=3)
    out = {}
    for L in DEGREES:
        angles, shared, _ = _inputs(L, True, np.float64)
        _, batched, _ = _inputs(L, False, np.float64)
        res = fn(jnp.asarray(angles), jnp.asarray(shared),
                 jnp.asarray(batched), L)
        for i, key in enumerate((True, False)):
            for j, tr in enumerate((False, True)):
                out[L, key, tr] = np.asarray(res[2 * i + j])
    return out


@pytest.mark.parametrize("L", DEGREES)
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "T"])
def test_column_apply_matches_plain_and_jax(jax_dense, L, shared, transpose):
    angles, spec, _ = _inputs(L, shared, np.float64)
    a, x = torch.tensor(angles), torch.tensor(spec)
    got = column_apply(a, x, L, transpose)
    np.testing.assert_allclose(got.numpy(), jax_dense[L, shared, transpose],
                               rtol=0, atol=1e-10)
    plain = wigner_block.block_wigner_matrix_multiply_pallas(
        a, x, L, transpose=transpose)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-12)
    # float32, the kernels' type: the float32 table against the plain
    a32, x32 = a.float(), x.float()
    np.testing.assert_allclose(
        column_apply(a32, x32, L, transpose).numpy(),
        wigner_block.block_wigner_matrix_multiply_pallas(
            a32, x32, L, transpose=transpose).numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("L", DEGREES)
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "T"])
def test_column_backward_matches_autograd(L, shared, transpose):
    angles, spec, G = _inputs(L, shared, np.float64)
    a = torch.tensor(angles, requires_grad=True)
    x = torch.tensor(spec, requires_grad=True)
    Gt = torch.tensor(G)
    out = wigner_block.wigner_block_apply_plain(
        *wigner_block.trig_features(a, L), x, L, transpose=transpose)
    da_ref, dx_ref = torch.autograd.grad(out, (a, x), Gt)
    dang, dx = column_backward(a.detach(), x.detach(), Gt, L, transpose)
    if shared:
        dx = dx.sum(0)
    np.testing.assert_allclose(dang.numpy(), da_ref.numpy(), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(dx.numpy(), dx_ref.numpy(), rtol=0,
                               atol=1e-10)
