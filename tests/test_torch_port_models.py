"""The PyTorch port's LieVAE held against the JAX package's at small width.

The JAX model's weights (``compat.template_variables``, with every
BatchNorm scale, bias and running statistic randomised so the eval-mode
statistics matter) are flattened to numpy ``'/'`` paths, carried into the
port by ``state_dict_from_jax``, and both models run in eval mode on the
same images. The posterior noise JAX draws from its own key is recovered
as ``eps = v / sigma`` and handed to the port. Float32, atol 1e-4: the same
network in float32, convolutions summed in another order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from lie_vae_tpu.compat import template_variables
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu.models import MEAN_MODULES as JAX_MEAN_MODULES
from lie_vae_tpu_torch.compat import state_dict_from_jax
from lie_vae_tpu_torch.models import MEAN_MODULES, LieVAE

TOL = 1e-4
SMALL = dict(latent_mode="so3", decoder_mode="action", encode_mode="conv",
             deconv_mode="deconv", degrees=3, rep_copies=4, conv_hidden=8,
             deconv_hidden=16, rgb=True, batch_norm=True)


def _flat_jax_weights(model, seed=0):
    """JAX variables as export_npz flattens them, BatchNorm randomised.
    (jitted: one compile instead of eager dispatch's op-by-op compiles)"""
    variables = jax.jit(template_variables, static_argnums=(0, 1))(model,
                                                                   seed)
    rng = np.random.default_rng(seed)
    flat = {}
    for coll in ("params", "batch_stats"):
        for k, v in traverse_util.flatten_dict(
                variables[coll], sep="/").items():
            v = np.asarray(v, np.float32)
            if "BatchNorm" in k:
                v = (rng.uniform(0.5, 2.0, v.shape) if k.endswith(("scale",
                                                                   "var"))
                     else rng.normal(0.0, 0.3, v.shape)).astype(np.float32)
            flat[f"{coll}/{k}"] = v
    return flat


def _unflatten(flat):
    out = {}
    for coll in ("params", "batch_stats"):
        sub = {k[len(coll) + 1:]: jnp.asarray(v) for k, v in flat.items()
               if k.startswith(coll + "/")}
        out[coll] = traverse_util.unflatten_dict(sub, sep="/")
    return out


@pytest.fixture(scope="module")
def pair():
    """(JAX values, port model, inputs) for the flagship's S2xS2 head."""
    jmodel = JaxLieVAE(mean_mode="s2s2", **SMALL)
    flat = _flat_jax_weights(jmodel)
    variables = _unflatten(flat)
    x = np.random.default_rng(1).random((4, 64, 64, 3), dtype=np.float32)

    @jax.jit
    def run(variables, x, key):
        h = jmodel.apply(variables, x, train=False,
                         method=lambda m, x, train: m.encoder(x, train=train))
        s = jmodel.apply(variables, x, n=1, train=False, method=jmodel.encode,
                         rngs={"sample": key})[0]
        img = jmodel.apply(variables, s.z, method=jmodel.decode)
        return h, s.mu_lie, s.inner.sigma, s.inner.z, s.z, img

    ref = [np.asarray(a) for a in run(variables, jnp.asarray(x),
                                      jax.random.PRNGKey(2))]
    model = LieVAE(mean_mode="s2s2", device="cpu", **SMALL)
    model.load_state_dict(state_dict_from_jax(flat, model), strict=True)
    model.eval()
    return ref, model, x


def test_encoder_matches_jax(pair):
    (h, *_), model, x = pair
    with torch.no_grad():
        got = model.encoder(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), h, rtol=0, atol=TOL)


def test_posterior_and_sample_match_jax(pair):
    (_, mu, sigma, v, z, _), model, x = pair
    eps = torch.tensor(v / sigma[None])
    with torch.no_grad():
        s = model.encode(torch.tensor(x), n=1, eps=eps)[0]
    np.testing.assert_allclose(s.mu_lie.numpy(), mu, rtol=0, atol=TOL)
    np.testing.assert_allclose(s.inner.sigma.numpy(), sigma, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(s.z.numpy(), z, rtol=0, atol=TOL)


def test_decode_matches_jax(pair):
    (*_, z, img), model, _ = pair
    with torch.no_grad():
        got = model.decode(torch.tensor(z))
    assert got.shape == img.shape == (1, 4, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), img, rtol=0, atol=TOL)


def test_forward_is_encode_then_decode(pair):
    (*_, img), model, x = pair
    (_, _, sigma, v, _, _) = pair[0]
    with torch.no_grad():
        recon, stats = model(torch.tensor(x), eps=torch.tensor(v / sigma))
    np.testing.assert_allclose(recon.numpy(), img, rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["alg", "q", "s2s2"])
def test_mean_heads_match_jax(mode):
    """Each SO(3) mean head from the same Linear weights as the JAX one."""
    rng = np.random.default_rng(3)
    head = MEAN_MODULES[mode](10)
    out = head.map.out_features
    kernel = rng.normal(size=(10, out)).astype(np.float32)
    bias = rng.normal(size=(out,)).astype(np.float32)
    h = rng.normal(size=(6, 10)).astype(np.float32)
    want = JAX_MEAN_MODULES[mode]().apply(
        {"params": {"Dense_0": {"kernel": kernel, "bias": bias}}}, h)
    with torch.no_grad():
        head.map.weight.copy_(torch.tensor(kernel.T))
        head.map.bias.copy_(torch.tensor(bias))
        got = head(torch.tensor(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_state_dict_from_jax_is_strict():
    model = LieVAE(mean_mode="s2s2", device="cpu", **SMALL)
    flat = _flat_jax_weights(JaxLieVAE(mean_mode="s2s2", **SMALL))
    state_dict_from_jax(flat, model)
    missing = dict(flat)
    missing.pop("params/decoder/item_rep")
    with pytest.raises(ValueError, match="item_rep"):
        state_dict_from_jax(missing, model)
    wrong = dict(flat, **{"params/decoder/item_rep": np.zeros((9, 4))})
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_jax(wrong, model)
