"""The port's von Mises-Fisher latent held against the JAX package's, on the
CPU in float64.

- ``ive``, ``log_ive`` and ``bessel_ratio`` at orders v in {0.5, 1, 1.5, 2,
  3.5} and at z on both branches and around the branch threshold max(1, v),
  values and their derivatives in z, relative 1e-8 (both sides compose
  i0e/i1e, the series and the recurrence in the same order);
- the KL, the entropy, ``log_posterior`` and ``log_prior``;
- ``sample_vmf`` with the noise handed over, for p in {3, 4, 9} and
  mu = e1 (the Householder vector is 0 there), its samples and the
  gradients in mu and kappa. JAX keeps its accepted Beta draw inside a
  ``while_loop``, so the test recovers it from JAX's own sample: w = mu . z
  (the reflection maps e1 to mu), then eps = (1 - w) / ((1 + b) - (1 - b) w)
  at kappa, and the tangent direction from the reflected sample, in
  float64;
- finite gradients at kappa in {1e-6, 1e4, 1e6} in float32, as
  ``tests/test_distributions.py`` pins the JAX sampler;
- the generator-drawn sampler: the first accepted of 32 proposals against
  a float64 replay of the same draws, 0.5 once all 32 are rejected, and no
  host synchronisation in the sampling path;
- ``vmf`` with the MLP decoder and ``vmfq`` with the action decoder (with
  ``kernel_impl`` 'fused' and 'pallas', whose CPU path is the plain ops)
  against the JAX models from the same weights: encoder features,
  posterior, sample, decode, ELBO terms and every gradient, to
  ``test_torch_port_modes.py``'s tolerances;
- ``compat`` both ways for both modes.
"""
import inspect
import math
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_port_modes as modes_test
import test_torch_port_models as models_test
from lie_vae_tpu.distributions import vmf as jvmf
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu_torch.compat import state_dict_from_jax, state_dict_to_jax
from lie_vae_tpu_torch.distributions import vmf
from lie_vae_tpu_torch.models import LieVAE

ORDERS = (0.5, 1.0, 1.5, 2.0, 3.5)
PS = (3, 4, 9)


def _z_grid(v):
    thr = max(1.0, v)
    return np.array([1e-8, 1e-4, 0.5, 0.999 * thr, thr, 1.001 * thr, 10.0,
                     300.0, 1e4])


_BESSEL = []


def _bessel_ref(v):
    """JAX values and z-derivatives of ive, log_ive, bessel_ratio at v (all
    orders in one jitted call, computed once)."""
    if not _BESSEL:
        @jax.jit
        def run(zs):
            out = []
            for v_, z in zip(ORDERS, zs):
                fns = (lambda z, v_=v_: jvmf.ive(v_, z),
                       lambda z, v_=v_: jvmf.log_ive(v_, z),
                       lambda z, v_=v_: jvmf.bessel_ratio(v_, z))
                out.append([(f(z), jax.grad(lambda zz: jnp.sum(f(zz)))(z))
                            for f in fns])
            return out

        _BESSEL.extend(jax.tree_util.tree_map(
            np.asarray, run([jnp.asarray(_z_grid(v_)) for v_ in ORDERS])))
    return _BESSEL[ORDERS.index(v)]


@pytest.mark.parametrize("v", ORDERS)
@pytest.mark.parametrize("fn", ["ive", "log_ive", "bessel_ratio"])
def test_bessel_functions_match_jax(fn, v):
    want, dwant = _bessel_ref(v)[["ive", "log_ive", "bessel_ratio"]
                                 .index(fn)]
    z = torch.tensor(_z_grid(v), requires_grad=True)
    got = getattr(vmf, fn)(v, z)
    (dgot,) = torch.autograd.grad(got.sum(), z)
    for what, g, w in (("value", got.detach(), want), ("d/dz", dgot, dwant)):
        g = g.numpy()
        assert np.isfinite(g).all(), (what, g)
        np.testing.assert_allclose(g, w, rtol=1e-8, atol=0, err_msg=what)


def test_half_integer_and_integer_orders_only():
    with pytest.raises(ValueError, match="half-integer"):
        vmf.ive(0.3, torch.tensor([2.0]))


def _rng_inputs(p, b=5, seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(b, p))
    mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
    mu[0] = np.eye(p)[0]                       # mu = e1: Householder u = 0
    kappa = np.exp(rng.uniform(-3.0, 6.0, size=(b, 1)))
    kappa[1, 0] = 0.7
    return mu, kappa


_KL = {}


def _kl_inputs(p):
    mu, kappa = _rng_inputs(p)
    z = np.random.default_rng(1).normal(size=(3,) + mu.shape)
    return mu, kappa, z / np.linalg.norm(z, axis=-1, keepdims=True)


def _kl_ref(p):
    """JAX kl, entropy, log_posterior, log_prior (every p in one call)."""
    if not _KL:
        @jax.jit
        def run(args):
            out = []
            for mu, kappa, z in args:
                s = jvmf.VonMisesFisherStats(mu=mu, kappa=kappa, z=z)
                out.append((s.kl(), s.entropy(), s.log_posterior(),
                            s.log_prior()))
            return out

        _KL.update(zip(PS, jax.tree_util.tree_map(np.asarray, run(
            [tuple(map(jnp.asarray, _kl_inputs(p_))) for p_ in PS]))))
    return _KL[p]


@pytest.mark.parametrize("p", PS)
def test_kl_entropy_and_densities_match_jax(p):
    mu, kappa, z = _kl_inputs(p)
    want = _kl_ref(p)
    s = vmf.VonMisesFisherStats(mu=torch.tensor(mu),
                                kappa=torch.tensor(kappa), z=torch.tensor(z))
    got = (s.kl(), s.entropy(), s.log_posterior(), s.log_prior())
    for name, g, w in zip(("kl", "entropy", "log_posterior", "log_prior"),
                          got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    np.testing.assert_allclose(
        float(vmf.hyperspherical_uniform_entropy(3, torch.float64)),
        math.log(2 * math.pi ** 2), rtol=1e-12)


def _recover_noise(mu, kappa, z):
    """The accepted Beta draw (n, B) and a tangent normal (n, B, p) that
    reproduce JAX's samples z (n, B, p) at mu (B, p), kappa (B, 1), float64:
    undo the reflection (it maps e1 to mu and is its own inverse), read w,
    and invert w = (1 - (1+b) e) / (1 - (1-b) e)."""
    p = mu.shape[-1]
    u = np.eye(p)[0] - mu
    u = u / np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
    z_e1 = z - 2.0 * np.sum(z * u, axis=-1, keepdims=True) * u
    w = z_e1[..., 0]
    k = kappa[..., 0]
    b = (p - 1.0) / (2.0 * k + np.sqrt(4.0 * k ** 2 + (p - 1.0) ** 2))
    eps = (1.0 - w) / ((1.0 + b) - (1.0 - b) * w)
    tangent = z_e1.copy()
    tangent[..., 0] = 0.0
    return eps, tangent


_SAMPLES = {}


def _sample_ref(p, n=3):
    """JAX samples and the gradients of sum(c * z) in mu and kappa (every p
    in one jitted call)."""
    if not _SAMPLES:
        inputs = {p_: _rng_inputs(p_) + (np.random.default_rng(2).normal(
            size=(n, 5, p_)),) for p_ in PS}

        @jax.jit
        def run(args):
            out = []
            for p_, (mu, kappa, c) in zip(PS, args):
                def f(mu, kappa, c=c, p_=p_):
                    z = jvmf.sample_vmf(jax.random.PRNGKey(p_), mu, kappa,
                                        n=n).z
                    return jnp.sum(c * z), z
                (_, z), g = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(mu, kappa)
                out.append((z, g))
            return out

        res = jax.tree_util.tree_map(np.asarray, run(
            [tuple(map(jnp.asarray, inputs[p_])) for p_ in PS]))
        for p_, (z, (gmu, gk)) in zip(PS, res):
            _SAMPLES[p_] = inputs[p_] + (z, gmu, gk)
    return _SAMPLES[p]


@pytest.mark.parametrize("p", PS)
def test_sample_with_handed_over_noise_matches_jax(p):
    mu, kappa, c, z, gmu, gk = _sample_ref(p)
    eps, tangent = _recover_noise(mu, kappa, z)
    mu_t = torch.tensor(mu, requires_grad=True)
    k_t = torch.tensor(kappa, requires_grad=True)
    s = vmf.sample_vmf(mu_t, k_t, n=3,
                       eps=(torch.tensor(eps), torch.tensor(tangent)))
    np.testing.assert_allclose(s.z.detach().numpy(), z, rtol=0, atol=1e-12)
    torch.sum(torch.tensor(c) * s.z).backward()
    # mu = e1 (row 0): JAX's norm of the zero Householder vector has a NaN
    # gradient there, torch's a zero one; every other row must agree
    rows = np.isfinite(gmu).all(-1)
    assert rows[1:].all()
    assert torch.isfinite(mu_t.grad).all()
    np.testing.assert_allclose(mu_t.grad.numpy()[rows], gmu[rows], rtol=0,
                               atol=1e-9 * max(1.0, np.abs(gmu[rows]).max()))
    np.testing.assert_allclose(k_t.grad.numpy(), gk, rtol=1e-8,
                               atol=1e-12)


def test_deterministic_sample_is_the_mean():
    mu = torch.tensor(_rng_inputs(4)[0])
    s = vmf.sample_vmf(mu, torch.ones(5, 1, dtype=torch.float64), n=2,
                       deterministic=True)
    assert torch.equal(s.z, mu.expand(2, 5, 4))


def test_pair_is_required_as_noise():
    with pytest.raises(TypeError, match="pair"):
        vmf.sample_vmf(torch.ones(2, 4) / 2, torch.ones(2, 1), n=1,
                       eps=torch.zeros(1, 2, 4))


@pytest.mark.parametrize("kap", [1e-6, 300.0, 1e4, 1e6])
def test_gradients_finite_at_extreme_kappa(kap):
    """float32 from the generator, as the JAX package's test holds its own
    sampler: the KL's and the samples' kappa gradients stay finite."""
    mu = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.5, 0.5, 0.5, 0.5]])
    k = torch.full((2, 1), kap, requires_grad=True)
    gen = torch.Generator().manual_seed(0)
    s = vmf.sample_vmf(mu, k, n=8, generator=gen)
    (g_kl,) = torch.autograd.grad(s.kl().sum(), k, retain_graph=True)
    (g_z,) = torch.autograd.grad(s.z.sum(), k)
    assert torch.isfinite(g_kl).all() and torch.isfinite(g_z).all(), kap
    assert torch.isfinite(s.z).all()


def test_generator_draw_keeps_the_first_accepted_proposal():
    """The accepted draw against a float64 replay of the same proposals:
    each (sample, item) keeps its first proposal that passes Wood's test."""
    p, n = 4, 6
    kappa = torch.tensor([[0.5], [3.0], [40.0], [2e3]], dtype=torch.float64)
    got = vmf.accepted_beta_draw(kappa, p, n,
                                 torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    shape = (vmf.NUM_PROPOSALS, n, 4)
    g = torch.randn((2, p - 1) + shape, generator=gen, dtype=torch.float64)
    x, y = (g * g).sum(1).numpy()
    eps = x / (x + y)
    u = torch.rand(shape, generator=gen, dtype=torch.float64).numpy()
    k = kappa.numpy()[:, 0]
    root = np.sqrt(4 * k ** 2 + (p - 1) ** 2)
    b = (p - 1) / (2 * k + root)
    a = (p - 1 + 2 * k + root) / 4
    d = 4 * a * b / (1 + b) - (p - 1) * math.log(p - 1)
    t = 2 * a * b / (1 - (1 - b) * eps)
    accept = (p - 1) * np.log(t) - t + d >= np.log(u)
    assert accept.any(0).all()
    want = np.take_along_axis(eps, accept.argmax(0)[None], 0)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (accept.argmax(0) > 0).any()        # some first proposals fail


def test_generator_draw_falls_back_to_half_after_32_rejections(monkeypatch):
    """Uniforms above 1 reject every proposal (Wood's log-ratio is at most
    0): all draws fall back to 0.5, as the JAX loop's initial value."""
    rand = torch.rand
    monkeypatch.setattr(torch, "rand",
                        lambda *a, **k: rand(*a, **k) + 2.0)
    got = vmf.accepted_beta_draw(torch.tensor([[1.0], [50.0]]), 4, 3,
                                 torch.Generator().manual_seed(0))
    assert torch.equal(got, torch.full((3, 2), 0.5))


# torch.cumprod's backward tests its input for zeros on the host
# (float(v) of the Python order v is no tensor)
_SYNC = re.compile(r"\.(item|tolist|numpy|cpu|all|any)\(\)|\bbool\("
                   r"|\bfloat\((?!v\))|cumprod")


def test_sampling_path_does_not_synchronise(monkeypatch):
    """No ``.item()``, ``.all()``, ``.tolist()``, ``bool()``, ``float()``
    or ``torch.cumprod`` in the sampling path or the Bessel functions of the
    KL (each waits for the device inside the training step), by the source
    and by a run with them made to raise."""
    for fn in (vmf.accepted_beta_draw, vmf.sample_vmf, vmf._beta_draws,
               vmf._wood_b, vmf._onto, vmf._series_scaled, vmf.ive,
               vmf.log_ive, vmf.bessel_ratio, vmf._recurrence):
        assert not _SYNC.findall(inspect.getsource(fn)), fn.__name__

    def refuse(*_):
        raise AssertionError("host synchronisation in the sampling path")

    mu = torch.tensor([[0.5, 0.5, 0.5, 0.5]] * 3)
    kappa = torch.full((3, 1), 5.0, requires_grad=True)
    for name in ("item", "tolist", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    s = vmf.sample_vmf(mu, kappa, n=2,
                       generator=torch.Generator().manual_seed(0))
    monkeypatch.undo()
    assert torch.isfinite(s.z).all()


# ------------------------------------------------------------- the models

VMF_CONFIGS = {
    "vmf_mlp": dict(modes_test.TOY, latent_mode="vmf", decoder_mode="mlp"),
    "vmfq_action_fused": dict(modes_test.TOY, latent_mode="vmfq",
                              kernel_impl="fused"),
    "vmfq_action_pallas": dict(modes_test.TOY, latent_mode="vmfq",
                               kernel_impl="pallas"),
    "conv_vmfq_action": dict(modes_test.CONV, latent_mode="vmfq"),
}


def _jax_cfg(cfg):
    return {k: v for k, v in cfg.items() if k != "kernel_impl"}


_MODELS = {}
_JAX_RUNS = {}


def _jax_run(cfg):
    """Weights, inputs and the JAX run of a configuration, once per JAX
    config (the port's kernel_impl is no JAX config)."""
    key = repr(sorted(_jax_cfg(cfg).items()))
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    jmodel = JaxLieVAE(**_jax_cfg(cfg))
    flat = modes_test._flat_weights(jmodel)
    variables = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64),
        {k: v for k, v in models_test._unflatten(flat).items() if v})
    x = modes_test._inputs(cfg)

    @jax.jit
    def run(variables, x, key):
        def features(m, x):
            if m.encode_mode == "toy":
                return m.encoder(x.reshape(x.shape[0], -1))
            return m.encoder(x, train=False)

        def loss_fn(params):
            v = {**variables, "params": params}
            out, stats = jmodel.apply(v, x, n=1, train=False,
                                      rngs={"sample": key})
            recon = jnp.sum((out - x) ** 2, axis=tuple(range(2, out.ndim)))
            kl = stats[0].kl()
            return jnp.mean(recon) + jnp.mean(kl), (out, recon, kl, stats)

        (_, (out, recon, kl, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        s = stats[0]
        h = jmodel.apply(variables, x, method=features)
        return h, (s.mu, s.kappa, s.z), out, recon, kl, grads

    _JAX_RUNS[key] = flat, x, jax.tree_util.tree_map(
        np.asarray, run(variables, jnp.asarray(x), jax.random.PRNGKey(5)))
    return _JAX_RUNS[key]


def _run(name):
    """JAX and port values of one vMF configuration (computed once)."""
    if name in _MODELS:
        return _MODELS[name]
    cfg = VMF_CONFIGS[name]
    flat, x, (h, post, out, recon, kl, grads) = _jax_run(cfg)
    eps = _recover_noise(post[0], post[1], post[2])

    model = LieVAE(device="cpu", **cfg)
    model.load_state_dict(state_dict_from_jax(flat, model), strict=True)
    model.double().eval()
    grad_flat = dict(modes_test._flat(grads, "params"),
                     **{k: v for k, v in flat.items()
                        if k.startswith("batch_stats/")})
    want_grads = state_dict_from_jax(grad_flat, model)
    xt = torch.tensor(x)
    eps_t = tuple(torch.tensor(e) for e in eps)
    with torch.no_grad():
        feats = (model.encoder(xt.reshape(xt.shape[0], -1))
                 if cfg["encode_mode"] == "toy"
                 else model.encoder(xt.permute(0, 3, 1, 2)))
        s = model.encode(xt, eps=eps_t)[0]
        got_out = model.decode(s.z)
    g_recon, g_kl, _, _ = model.elbo(xt, eps=eps_t)
    (g_recon.mean() + g_kl.mean()).backward()
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    _MODELS[name] = dict(
        want=dict(h=h, post=post, out=out, recon=recon, kl=kl,
                  grads={k: want_grads[k] for k in got_grads}),
        got=dict(h=feats, post=(s.mu, s.kappa, s.z), out=got_out,
                 recon=g_recon.detach(), kl=g_kl.detach(), grads=got_grads),
        flat=flat, model=model)
    return _MODELS[name]


def _tol(name):
    return modes_test._tol(name)


@pytest.mark.parametrize("name", VMF_CONFIGS)
def test_vmf_models_match_jax(name):
    r = _run(name)
    tol = _tol(name)
    modes_test._close(r["got"]["h"], r["want"]["h"], tol, "features")
    for what, got, want in zip(("mu", "kappa", "z"), r["got"]["post"],
                               r["want"]["post"]):
        modes_test._close(got, want, tol, what)
    assert r["got"]["out"].shape == (1, 4) + r["model"].out_shape
    modes_test._close(r["got"]["out"], r["want"]["out"], tol, "decode")
    modes_test._close(r["got"]["recon"], r["want"]["recon"], tol, "recon")
    modes_test._close(r["got"]["kl"], r["want"]["kl"], tol, "kl")


@pytest.mark.parametrize("name", VMF_CONFIGS)
def test_vmf_model_gradients_match_jax(name):
    r = _run(name)
    assert set(r["got"]["grads"]) >= {"reparameterize.0.mu_linear.weight",
                                      "reparameterize.0.k_linear.weight"}
    for key, got in r["got"]["grads"].items():
        modes_test._close(got, r["want"]["grads"][key], _tol(name), key)


@pytest.mark.parametrize("name", list(VMF_CONFIGS) + list(modes_test.CONFIGS))
def test_compat_round_trips_both_ways(name):
    """JAX flat paths -> the port's state_dict -> JAX flat paths gives back
    every array exactly, for the vMF configurations and every mode of
    ``test_torch_port_modes.py``."""
    cfg = {**modes_test.CONFIGS, **VMF_CONFIGS}[name]
    flat = modes_test._flat_weights(JaxLieVAE(**modes_test._jax_config(
        _jax_cfg(cfg))))
    model = LieVAE(device="cpu", **cfg)
    back = state_dict_to_jax(state_dict_from_jax(flat, model), model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == np.float32


def test_state_dict_to_jax_is_strict():
    model = LieVAE(device="cpu", **VMF_CONFIGS["vmf_mlp"])
    sd = model.state_dict()
    with pytest.raises(ValueError, match="k_linear"):
        state_dict_to_jax({k: v for k, v in sd.items()
                           if "k_linear" not in k}, model)
    with pytest.raises(ValueError, match="unknown"):
        state_dict_to_jax(dict(sd, extra=torch.zeros(1)), model)
    with pytest.raises(ValueError, match="shape"):
        state_dict_to_jax(dict(
            sd, **{"reparameterize.0.k_linear.bias": torch.zeros(2)}), model)


def test_vmf_noise_dims_and_config_error():
    m = LieVAE(device="cpu", **VMF_CONFIGS["vmfq_action_fused"])
    assert m.group_dims == m.noise_dims == 4 and m.is_vmf
    assert LieVAE(device="cpu", deterministic=True,
                  **VMF_CONFIGS["vmf_mlp"]).noise_dims is None
    with pytest.raises(ValueError, match="no Euler chart"):
        LieVAE(device="cpu", **dict(modes_test.TOY, latent_mode="vmf"))
