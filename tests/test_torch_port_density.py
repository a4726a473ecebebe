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

The kernels' design is held on the CPU through a torch emulation of one
sample's lane-split computation (``_emulate``): the 2k+1 shells dealt to G
lanes as ``csrc/so3_density.cu`` deals them, the lanes' partial sums met in
its fixed xor tree, m2 in its closed form, and its reciprocals; and the KL
(the mean over the samples of log q less the Haar constant, which the
kernels fold in) against the JAX package's ``SO3Stats.kl``.

The CUDA kernels run only on a card: the tests marked ``cuda`` skip
elsewhere.
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
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

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


def _shell(j, theta):
    """th_j = 2 pi j + theta, the one expression the kernels form shells
    with (for m2 and in the shell loop alike)."""
    return 2.0 * math.pi * j + theta


def _m2_closed(theta, k):
    """The kernels' m2: the smaller square of the two shells around
    -theta / 2 pi, floor(-theta / 2 pi) clamped to [-k, k] and the one
    above it."""
    lo = torch.clamp(torch.floor(-theta * (1.0 / (2.0 * math.pi))), -k, k)
    a, c = _shell(lo, theta), _shell(torch.clamp(lo + 1, max=k), theta)
    return torch.minimum(a * a, c * c)


def _m2_loop(theta, k):
    th = _shell(torch.arange(-k, k + 1, dtype=theta.dtype), theta[..., None])
    return (th * th).amin(-1)


def _lane_sum(terms, G):
    """terms (..., 2k+1), shell t = j + k last, summed as the kernels do:
    lane r adds t = r, r + G, ... in turn, then for off = G/2, ..., 1 every
    lane adds its xor partner's partial sum. Every lane must end with the
    same total (float addition commutes), which is what lane 0 stores."""
    lanes = []
    for r in range(G):
        acc = torch.zeros_like(terms[..., 0])
        for t in range(r, terms.shape[-1], G):
            acc = acc + terms[..., t]
        lanes.append(acc)
    off = G // 2
    while off:
        lanes = [lanes[r] + lanes[r ^ off] for r in range(G)]
        off //= 2
    assert all(torch.equal(x, lanes[0]) for x in lanes[1:])
    return lanes[0]


def _emulate(v, sigma, k, G, clamp=1e-3):
    """One sample's computation in K3 and K4, for every sample: log q
    (n, B), and its gradients for a unit cotangent, dv (n, B, 3) and the
    per-sample dsigma (n, B, 3) (K4 sums it over n)."""
    theta = torch.sqrt(torch.sum(v * v, -1))
    it = 1.0 / torch.clamp(theta, min=1e-12)
    isg = 1.0 / sigma
    u = v * it[..., None]
    q = torch.sum((u * isg) ** 2, -1)
    m2 = _m2_closed(theta, k)
    th = _shell(torch.arange(-k, k + 1, dtype=v.dtype), theta[..., None])
    th2 = th * th
    e = torch.clamp(th2, min=clamp) * torch.exp(
        -0.5 * q[..., None] * (th2 - m2[..., None]))
    rest = (-0.5 * q * m2
            - torch.log(torch.clamp(2.0 - 2.0 * torch.cos(theta), min=clamp))
            - torch.log(sigma).sum(-1) - 1.5 * math.log(2.0 * math.pi))
    E = _lane_sum(e, G)
    log_q = torch.log(E) + rest
    a = torch.where(th2 > clamp, -q[..., None] * th + 2.0 * (1.0 / th),
                    -q[..., None] * th)
    den = 2.0 - 2.0 * torch.cos(theta)
    dvol = torch.where(den > clamp, 2.0 * torch.sin(theta) * (1.0 / den), 0.0)
    ise = 1.0 / E
    A = _lane_sum(e * a, G) * ise - dvol
    Bw = _lane_sum(e * th2, G) * ise
    dv = A[..., None] * u - (Bw * it)[..., None] * (
        u * isg * isg - q[..., None] * u)
    ds = Bw[..., None] * (u * u) * isg ** 3 - isg
    return log_q, dv, ds


def _tie_inputs(k, n=3, B=9, seed=11):
    """_inputs with the first sample's rows 2-8 put at |v| on and near odd
    multiples of pi (where two shells tie for the smallest |th_j|), beyond
    (2k+1) pi (where the clamp of the nearest shell bites) and at 0."""
    v, sigma = _inputs(n=n, B=B, seed=seed)
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(7, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    radii = np.array([np.pi, np.pi * (1 + 1e-12), 3 * np.pi * (1 - 1e-12),
                      5 * np.pi, (2 * k + 1) * np.pi + 0.5,
                      (2 * k + 3) * np.pi + 0.1, 0.0])
    sigma[2:9] = rng.uniform(0.5, 5 * np.pi, (7, 3))
    v[0, 2:9] = axes * radii[:, None]
    return v, sigma


@pytest.fixture(scope="module")
def jax_tie_reference():
    """For each k, from one jitted JAX function: the JAX package's density
    and its gradients on ``_tie_inputs(k)`` (n = 3), and its
    ``SO3Stats.kl`` and gradients there and on the first sample alone
    (n = 1)."""
    def kl(v, s, k):
        return jso3.SO3Stats(
            mu_lie=jnp.zeros(s.shape[:1] + (3, 3)),
            inner=jnormal.ZeroMeanGaussianStats(sigma=s, z=v),
            z=jnp.zeros(v.shape[:2] + (3, 3)), k=k).kl()

    def with_grads(f, v, s, g):
        return (f(v, s),) + jax.grad(lambda v, s: jnp.sum(f(v, s) * g),
                                     argnums=(0, 1))(v, s)

    out = {}
    for k in KS:
        v, sigma = _tie_inputs(k)
        g = np.random.default_rng(2).normal(size=v.shape[:2])
        gr = np.random.default_rng(3).normal(size=v.shape[1])

        def density(v, s, k=k):
            return jso3.so3_wrapped_log_density(v, s, k)

        def kl_k(v, s, k=k):
            return kl(v, s, k)

        res = jax.jit(lambda v, s: (
            with_grads(density, v, s, g), with_grads(kl_k, v[:1], s, gr),
            with_grads(kl_k, v, s, gr)))(v, sigma)
        out[k, "density"], out[k, "kl", 1], out[k, "kl", 3] = (
            [np.asarray(t) for t in r] for r in res)
        out[k] = v, sigma, g, gr
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", KS)
def test_closed_form_m2_is_the_loop_minimum(k, dtype):
    """m2 from two shells is the 2k+1-shell loop's minimum to the bit, at
    and a few ulps around odd multiples of pi (ties), multiples of 2 pi,
    beyond (2k+1) pi (the clamp), 0, and 20000 random |v|."""
    centres = torch.tensor([m * math.pi for m in range(0, 2 * k + 8)],
                           dtype=dtype)
    near = [centres]
    for steps in (1, 2, 5):
        up, down = centres.clone(), centres.clone()
        for _ in range(steps):
            up = torch.nextafter(up, torch.tensor(math.inf, dtype=dtype))
            down = torch.nextafter(down, torch.tensor(-1.0, dtype=dtype))
        near += [up, down]
    rng = np.random.default_rng(k)
    theta = torch.cat(near + [torch.tensor(rng.uniform(
        0, (2 * k + 5) * math.pi, 20000), dtype=dtype)]).clamp(min=0)
    assert torch.equal(_m2_closed(theta, k), _m2_loop(theta, k))


@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("k", KS)
def test_lane_split_emulation_matches_plain_and_jax(jax_tie_reference, k, G):
    """The kernels' per-sample arithmetic in float64: log q against the
    plain density and the JAX package (1e-10), dv and dsigma (summed over
    the n = 3 samples) against the plain autograd and JAX's autodiff (row
    by row, 1e-10; dv = 0 at v = 0, where JAX gives NaN)."""
    v, sigma, g, _ = jax_tie_reference[k]
    val_ref, dv_ref, ds_ref = jax_tie_reference[k, "density"]
    vt = torch.tensor(v, requires_grad=True)
    st = torch.tensor(sigma, requires_grad=True)
    plain = tso3.so3_wrapped_log_density_plain(vt, st, k)
    (plain * torch.tensor(g)).sum().backward()
    p_dv, p_ds = vt.grad, st.grad
    log_q, dv, ds = _emulate(torch.tensor(v), torch.tensor(sigma), k, G)
    dv = dv * torch.tensor(g)[..., None]
    ds = (ds * torch.tensor(g)[..., None]).sum(0)
    _close(log_q, plain.detach())
    _close(log_q, val_ref)
    at_zero = np.all(v == 0.0, axis=-1)
    assert at_zero.sum() == 2 and np.isnan(dv_ref[at_zero]).all()
    np.testing.assert_array_equal(dv.numpy()[at_zero], 0.0)
    for want in (p_dv.numpy(), dv_ref):
        _close_rows(dv.numpy()[~at_zero], want[~at_zero])
    for want in (p_ds.numpy(), ds_ref):
        _close_rows(ds, want)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("k", KS)
def test_kl_plain_matches_jax(jax_tie_reference, k, n):
    """The KL entry's plain version (the CPU path of ``SO3Stats.kl``) and
    its gradients, dv and dsigma summed over the n samples, against the
    JAX package's ``SO3Stats.kl`` jitted and its autodiff."""
    v, sigma, _, gr = jax_tie_reference[k]
    kl_ref, dv_ref, ds_ref = jax_tie_reference[k, "kl", n]
    vt = torch.tensor(v[:n], requires_grad=True)
    st = torch.tensor(sigma, requires_grad=True)
    kl = tdist.so3_wrapped_kl(vt, st, k)
    assert kl.shape == (9,) and kl.dtype == torch.float64
    _close(kl.detach(), kl_ref)
    (kl * torch.tensor(gr)).sum().backward()
    dv, ds = vt.grad, st.grad
    at_zero = np.all(v[:n] == 0.0, axis=-1)
    assert np.isnan(dv_ref[at_zero]).all()
    np.testing.assert_array_equal(dv.numpy()[at_zero], 0.0)
    _close_rows(dv.numpy()[~at_zero], dv_ref[~at_zero])
    _close_rows(ds, ds_ref)


def test_kl_cpu_is_the_plain_kl_and_launches_nothing():
    v, sigma = _inputs(n=2, dtype=np.float32)
    fused = so3_density.so3_wrapped_log_density_fused
    before = fused.launches, fused.launches_backward
    vt = torch.tensor(v, requires_grad=True)
    st = torch.tensor(sigma, requires_grad=True)
    for impl in ("fused", "xla"):
        kl = tdist.so3_wrapped_kl(vt, st, impl=impl)
        kl.sum().backward()
        assert torch.equal(kl, torch.mean(tso3.so3_wrapped_log_density_plain(
            vt, st) - tdist.LOG_HAAR_UNIFORM, dim=0))
    assert (fused.launches, fused.launches_backward) == before


def test_lanes_follow_the_sample_count():
    """A wide lane group while the samples leave the card room, one lane
    a sample once they fill it; K4 keeps wide groups longer."""
    fwd = so3_density.FWD_LANE_SAMPLES_PER_SM
    bwd = so3_density.BWD_LANE_SAMPLES_PER_SM
    assert so3_density.lanes_for(64, fwd) == 8
    assert so3_density.lanes_for(500, fwd) == 8
    assert so3_density.lanes_for(132 * fwd // 8, fwd) == 8
    assert so3_density.lanes_for(132 * fwd // 8 + 1, fwd) == 4
    assert so3_density.lanes_for(132 * fwd, fwd) == 1
    assert so3_density.lanes_for(4096, fwd) == 4
    assert so3_density.lanes_for(4096, bwd) == 8
    assert so3_density.lanes_for(65536, bwd) == 1
    assert so3_density.lanes_for(10 ** 8, bwd) == 1


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


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n,B", [(1, 64), (4, 9), (1, 4103), (4, 16384)])
def test_kl_kernels_match_plain(cuda_device, k, n, B):
    """The KL entry (one launch of K3 with the mean folded in) and its
    backward (one launch of K4 taking the (B,) cotangent) against the plain
    KL and its autograd in float64, as ``test_kernels_match_plain``; and
    twice the same bits."""
    fused = so3_density.so3_wrapped_log_density_fused
    v, sigma = _inputs(n=n, B=B, seed=k, dtype=np.float32)
    g = np.random.default_rng(6).normal(size=B)
    res = []
    for fn, dtype in ((so3_density.so3_wrapped_kl_fused, torch.float32),
                      (so3_density.so3_wrapped_kl_fused, torch.float32),
                      (tso3.so3_wrapped_kl_plain, torch.float64)):
        vt = torch.tensor(v, dtype=dtype, device=cuda_device,
                          requires_grad=True)
        st = torch.tensor(sigma, dtype=dtype, device=cuda_device,
                          requires_grad=True)
        before = fused.launches, fused.launches_backward
        kl = fn(vt, st, k)
        kl.backward(torch.tensor(g, dtype=dtype, device=cuda_device))
        after = fused.launches, fused.launches_backward
        assert after == ((before[0] + 1, before[1] + 1) if dtype ==
                         torch.float32 else before)
        res.append([t.double() for t in (kl.detach(), vt.grad, st.grad)])
    assert all(torch.equal(a, b) for a, b in zip(res[0], res[1]))
    (o1, dv1, ds1), _, (o2, dv2, ds2) = res
    assert float(((o1 - o2).abs() - 1e-4 - 1e-4 * o2.abs()).max()) <= 0
    for a, b in ((dv1, dv2), (ds1, ds2)):
        err = (a - b).abs().amax(-1)
        assert float((err - 1e-3 - 1e-3 * b.abs().amax(-1)).max()) <= 0
