"""Every LieVAE mode of the port held against the JAX package's, on the CPU
at a small size.

For each configuration the JAX model's weights (``compat.template_variables``,
BatchNorm randomised as in ``test_torch_port_models.py``) are carried into
the port by ``state_dict_from_jax``; both run in float64 on the same
inputs, the JAX noise handed over (``inner.z / inner.sigma`` for SO(3),
``(z - mu) / sigma`` for the Gaussian; none when deterministic). Held: the
encoder's features, the posterior statistics and the sample, the decode of
that sample, the ELBO terms (reconstruction and KL) and the gradient of
mean(recon) + mean(KL) for every parameter (the JAX gradients carried into
the port's layout by ``state_dict_from_jax`` too).

Tolerances, each against max(1, max |reference|): 1e-6 where both run in
float64 throughout (the toy encoder and decoder are MLPs; XLA's float64
trigonometry on the CPU is good to about 1e-8, and the gradients through
the Euler angles magnify it: 5e-8 seen), as the harness tests hold their
float64 runs; 1e-5 for the conv configurations, whose JAX ``ConvEncoder``
and ``DeconvNet`` cast their outputs to float32 whatever the input's
dtype. Models run in eval
mode (BatchNorm on its running statistics).

Configurations: ``normal`` with the action and the MLP decoder, ``so3``
with the MLP decoder, the toy encoder and decoder with ``so3`` and the
action decoder, each mean head (``s2s1`` among them), ``fixed_sigma``,
``fixed_item_rep``, ``deterministic`` for both latents, ``mlp_layers=0``,
each activation and ``r_callback``; two with the conv encoder and deconv
head. Also ``with_mlp`` of the action decoder alone and the config errors
the JAX model raises.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import test_torch_port_models as models_test
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu.models.decoders import ActionDecoder as JaxActionDecoder
from lie_vae_tpu_torch.compat import state_dict_from_jax
from lie_vae_tpu_torch.models import ActionDecoder, LieVAE
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

TOY = dict(encode_mode="toy", deconv_mode="toy", degrees=2, rep_copies=3,
           mlp_hidden=6, group_reparam_in_dims=4)
CONV = dict(encode_mode="conv", deconv_mode="deconv", degrees=2,
            rep_copies=2, conv_hidden=4, deconv_hidden=6, rgb=False,
            batch_norm=True)
_SPECTRUM = np.random.default_rng(7).normal(size=(9, 3)).astype(np.float32)


def _double(h):
    return 2.0 * h


CONFIGS = {
    "so3_action_toy_r_callback": dict(TOY, mean_mode="s2s2",
                                      r_callback=(_double,)),
    "s2s1_fixed_sigma": dict(TOY, mean_mode="s2s1", fixed_sigma=0.3),
    "q_fixed_item_rep": dict(TOY, mean_mode="q", fixed_item_rep=_SPECTRUM),
    "alg_deterministic": dict(TOY, mean_mode="alg", deterministic=True),
    "normal_action": dict(TOY, latent_mode="normal", normal_dims=3),
    "normal_mlp_tanh": dict(TOY, latent_mode="normal", decoder_mode="mlp",
                            normal_dims=5, mlp_layers=1,
                            mlp_activation="tanh"),
    "so3_mlp_layers0_softplus": dict(TOY, decoder_mode="mlp", mlp_layers=0,
                                     mlp_activation="softplus"),
    "conv_normal_action": dict(CONV, latent_mode="normal"),
}


def _tol(name):
    return 1e-5 if name.startswith("conv") else 1e-6


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


def _inputs(cfg, seed=3, batch=4):
    rng = np.random.default_rng(seed)
    if cfg["encode_mode"] == "toy":
        shape = ((cfg["degrees"] + 1) ** 2, cfg["rep_copies"])
    else:
        shape = (64, 64, 3 if cfg["rgb"] else 1)
    return rng.random((batch,) + shape)


def _jax_config(cfg):
    out = dict(cfg)
    if "fixed_item_rep" in out:
        out["fixed_item_rep"] = jnp.asarray(out["fixed_item_rep"])
    return out


def _flat(tree, coll):
    return {f"{coll}/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


_CACHE = {}


def _run(name):
    """JAX and port values of one configuration (computed once)."""
    if name in _CACHE:
        return _CACHE[name]
    cfg = CONFIGS[name]
    jmodel = JaxLieVAE(**_jax_config(cfg))
    flat = _flat_weights(jmodel)
    variables = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64),
        {k: v for k, v in models_test._unflatten(flat).items() if v})
    x = _inputs(cfg)

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
        if cfg.get("latent_mode", "so3") == "so3":
            post = (s.mu_lie, s.inner.sigma, s.z)
            eps = s.inner.z / s.inner.sigma
        else:
            post = (s.mu, s.sigma, s.z)
            eps = (s.z - s.mu) / s.sigma
        return h, post, eps, out, recon, kl, grads

    h, post, eps, out, recon, kl, grads = jax.tree_util.tree_map(
        np.asarray, run(variables, jnp.asarray(x), jax.random.PRNGKey(5)))

    model = LieVAE(device="cpu", **cfg)
    model.load_state_dict(state_dict_from_jax(flat, model), strict=True)
    model.double().eval()
    grad_flat = dict(_flat(grads, "params"),
                     **{k: v for k, v in flat.items()
                        if k.startswith("batch_stats/")})
    want_grads = state_dict_from_jax(grad_flat, model)
    xt = torch.tensor(x)
    eps_t = None if cfg.get("deterministic") else torch.tensor(eps)
    with torch.no_grad():
        feats = (model.encoder(xt.reshape(xt.shape[0], -1))
                 if cfg["encode_mode"] == "toy"
                 else model.encoder(xt.permute(0, 3, 1, 2)))
        s = model.encode(xt, eps=eps_t)[0]
        got_post = ((s.mu_lie, s.inner.sigma, s.z) if hasattr(s, "inner")
                    else (s.mu, s.sigma, s.z))
        got_out = model.decode(s.z)
    g_recon, g_kl, _, _ = model.elbo(xt, eps=eps_t)
    (g_recon.mean() + g_kl.mean()).backward()
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    _CACHE[name] = dict(
        want=dict(h=h, post=post, out=out, recon=recon, kl=kl,
                  grads={k: want_grads[k] for k in got_grads}),
        got=dict(h=feats, post=got_post, out=got_out, recon=g_recon.detach(),
                 kl=g_kl.detach(), grads=got_grads))
    return _CACHE[name]


def _flat_weights(jmodel, seed=0):
    """Random JAX variables as ``export_npz`` flattens them, float32: the
    tree's shapes from a trace of the init (no compile), each kernel
    N(0, 1 / fan_in), biases N(0, 0.1), BatchNorm scales and variances
    U(0.5, 2), shifts and means N(0, 0.3), ``item_rep`` N(0, 1)."""
    from lie_vae_tpu.compat import template_variables
    shapes = jax.eval_shape(lambda: template_variables(jmodel, seed))
    rng = np.random.default_rng(seed)
    flat = {}
    for coll, tree in shapes.items():
        for k, v in traverse_util.flatten_dict(tree, sep="/").items():
            if "BatchNorm" in k and k.endswith(("scale", "var")):
                a = rng.uniform(0.5, 2.0, v.shape)
            elif k.endswith("kernel"):
                a = rng.normal(0.0, 1.0, v.shape) / np.sqrt(
                    np.prod(v.shape[:-1]))
            elif k.endswith("item_rep"):
                a = rng.normal(0.0, 1.0, v.shape)
            else:
                a = rng.normal(0.0, 0.3 if "BatchNorm" in k else 0.1,
                               v.shape)
            flat[f"{coll}/{k}"] = a.astype(np.float32)
    return flat


@pytest.mark.parametrize("name", CONFIGS)
def test_encoder_features_match_jax(name):
    r = _run(name)
    _close(r["got"]["h"], r["want"]["h"], _tol(name), "features")


@pytest.mark.parametrize("name", CONFIGS)
def test_posterior_and_sample_match_jax(name):
    r = _run(name)
    for what, got, want in zip(("mean", "sigma", "z"), r["got"]["post"],
                               r["want"]["post"]):
        _close(got, want, _tol(name), what)


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_matches_jax(name):
    r = _run(name)
    model_shape = LieVAE(device="cpu", **CONFIGS[name]).out_shape
    assert r["got"]["out"].shape == (1, 4) + model_shape
    _close(r["got"]["out"], r["want"]["out"], _tol(name), "decode")


@pytest.mark.parametrize("name", CONFIGS)
def test_elbo_terms_match_jax(name):
    r = _run(name)
    _close(r["got"]["recon"], r["want"]["recon"], _tol(name), "recon")
    _close(r["got"]["kl"], r["want"]["kl"], _tol(name), "kl")


@pytest.mark.parametrize("name", CONFIGS)
def test_gradients_match_jax(name):
    r = _run(name)
    assert r["got"]["grads"], "no parameter took a gradient"
    for key, got in r["got"]["grads"].items():
        want = r["want"]["grads"][key]
        if CONFIGS[name].get("fixed_sigma") and "sigma_linear" in key:
            assert got is None, key       # the reference's unused head
            continue
        _close(got, want, _tol(name), key)


def test_fixed_item_rep_is_a_buffer_without_gradient():
    model = LieVAE(device="cpu", **CONFIGS["q_fixed_item_rep"])
    assert "decoder.item_rep" not in dict(model.named_parameters())
    np.testing.assert_array_equal(model.state_dict()["decoder.item_rep"],
                                  _SPECTRUM.astype(np.float32))


def test_action_decoder_with_mlp_matches_jax():
    """``with_mlp``: the rotated spectrum through MLP(S C, 50, 3), no
    deconv head, against the JAX ActionDecoder, float64."""
    rng = np.random.default_rng(4)
    angles = rng.uniform(-3, 3, (5, 3))
    jdec = JaxActionDecoder(degrees=2, deconv=None, rep_copies=3,
                            with_mlp=True)
    params = jax.jit(jdec.init)(jax.random.PRNGKey(0), jnp.asarray(angles))
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), params)
    want = np.asarray(jax.jit(jdec.apply)(params, jnp.asarray(angles)))
    dec = ActionDecoder(2, None, rep_copies=3, with_mlp=True,
                        wigner_impl="xla").double()
    p = traverse_util.flatten_dict(params["params"], sep="/")
    sd = {"item_rep": torch.tensor(np.asarray(p["item_rep"]))}
    for i in range(4):
        sd[f"mlp.{2 * i}.weight"] = torch.tensor(
            np.asarray(p[f"MLP_0/Dense_{i}/kernel"]).T)
        sd[f"mlp.{2 * i}.bias"] = torch.tensor(
            np.asarray(p[f"MLP_0/Dense_{i}/bias"]))
    dec.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = dec(torch.tensor(angles))
    assert got.shape == want.shape == (5, 9, 3)
    _close(got, want, 1e-6, "with_mlp")


@pytest.mark.parametrize("cfg,match", [
    (dict(latent_mode="normal", decoder_mode="action", normal_dims=4),
     "Normal Action must be 3 dim"),
    (dict(latent_mode="vmf", decoder_mode="action"), "no Euler chart"),
    (dict(encode_mode="dense"), "Wrong encode mode"),
    (dict(deconv_mode="dense"), "Wrong deconv mode"),
    (dict(decoder_mode="proj"), "Wrong decoder mode")])
def test_config_errors_as_in_jax(cfg, match):
    with pytest.raises(ValueError, match=match):
        LieVAE(device="cpu", **dict(TOY, **cfg))
    with pytest.raises(ValueError, match=match):
        jax.eval_shape(
            lambda: JaxLieVAE(**dict(TOY, **cfg)).init(
                {"params": jax.random.PRNGKey(0),
                 "sample": jax.random.PRNGKey(0)},
                jnp.zeros((1, 9, 3)), n=1))


def test_group_and_noise_dims():
    assert LieVAE(device="cpu", **TOY).group_dims == 9
    normal = LieVAE(device="cpu", latent_mode="normal", decoder_mode="mlp",
                    normal_dims=7, **TOY)
    assert normal.group_dims == normal.noise_dims == 7
    assert LieVAE(device="cpu", deterministic=True, **TOY).noise_dims is None

