"""The PyTorch port's train step held against the JAX package's.

- BatchNorm's running statistics after train-mode forwards, against flax's
  mutated ``batch_stats`` (flax moves the running variance toward the
  biased batch variance; ``torch.nn.BatchNorm2d`` toward the unbiased one);
- every beta-schedule preset and ``warmupN`` against the JAX package's;
- ``make_optimizer`` against the JAX package's optax chain over 5 steps, in
  float64 at 1e-10: clip on and off, triggered and not, selective, weight
  decay;
- ``train_step`` of a small flagship-shaped model (S2xS2 mean, L = 3,
  3 copies, conv width 4, deconv width 8, RGB, BatchNorm, batch 4, 64x64
  uint8 images), training in float32, against a jitted JAX step built as
  ``bench.py``'s (lr 1e-3, clip 1e-5, beta 1) from the same weights, which
  also returns the noise it drew; the port gets that noise. Tolerances:
  loss at rtol 1e-5; a gradient tensor within 1e-4 * max|reference| + 1e-5
  (its small elements are sums that cancel); parameters and running
  statistics at rtol 1e-4, atol 1e-5, as ``tests/test_kernels.py`` holds
  its kernels' training. The JAX step runs in float64 for 3 steps (loss and
  gradients at each, parameters and statistics after them), and in float32
  for the first step. The noise must be handed over in each dtype:
  ``jax.random.normal`` draws other numbers in float32 than in float64 from
  one key;
- past the first step JAX's float32 trajectory is no reference at these
  tolerances: at the states it reaches, JAX's own float64 step with the
  same noise agrees with the port and not with it (flax's BatchNorm
  computes the variance as E[x^2] - E[x]^2 by default, which cancels in
  float32). So at each state of the float32 JAX trajectory, the port is
  held against the float64 JAX step at that state with that noise
  (ROADMAP.md, Queue C, C2);
- beta = 0 skips the KL: zero KL, finite gradients.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn
from flax import traverse_util

import test_torch_port_models as models_test
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu.train import schedules as jschedules
from lie_vae_tpu.train import state as jstate
from lie_vae_tpu_torch import distributions as tdist
from lie_vae_tpu_torch.compat import state_dict_from_jax
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.models.nets import ConvEncoder
from lie_vae_tpu_torch.train import (get_beta_schedule, make_optimizer,
                                     train_step)

SMALL = dict(latent_mode="so3", decoder_mode="action", encode_mode="conv",
             deconv_mode="deconv", mean_mode="s2s2", degrees=3, rep_copies=3,
             conv_hidden=4, deconv_hidden=8, rgb=True, batch_norm=True)
STEPS = 3


def _images(seed, n=4):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                dtype=np.uint8)


def _port_model(flat):
    model = LieVAE(device="cpu", **SMALL)
    model.load_state_dict(state_dict_from_jax(flat, model), strict=True)
    return model


# ------------------------------------------------------------ BatchNorm


def test_batchnorm_running_stats_match_flax():
    """One train-mode forward of one BatchNorm layer on a (4, 4, 4, 8)
    batch: output and both running statistics as flax's."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 1.0, (4, 4, 4, 8)).astype(np.float32)
    scale, bias = (rng.uniform(0.5, 2.0, 8).astype(np.float32),
                   rng.normal(0.0, 0.3, 8).astype(np.float32))
    mean, var = (rng.normal(0.0, 0.3, 8).astype(np.float32),
                 rng.uniform(0.5, 2.0, 8).astype(np.float32))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    y, mut = bn.apply({"params": {"scale": scale, "bias": bias},
                       "batch_stats": {"mean": mean, "var": var}}, x,
                      mutable=["batch_stats"])
    port = ConvEncoder(10, hidden_dims=8)[1]          # the encoder's layer
    with torch.no_grad():
        for name, value in (("weight", scale), ("bias", bias),
                            ("running_mean", mean), ("running_var", var)):
            getattr(port, name).copy_(torch.tensor(value))
    got = port.train()(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)
    assert int(port.num_batches_tracked) == 1
    with torch.no_grad():             # eval mode reads, never updates
        port.eval()(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)


def test_model_batch_stats_after_train_forward_match_flax():
    """The small model's four BatchNorm layers after one train-mode
    forward (the deepest normalises 4 x 4 x 4 = 64 values per channel,
    where the unbiased variance is 1.6% larger); the state_dict keys of the
    reference checkpoint stay."""
    jmodel = JaxLieVAE(**SMALL)
    flat = models_test._flat_jax_weights(jmodel)
    variables = models_test._unflatten(flat)
    x = _images(1).astype(np.float32) / 255.0

    @jax.jit
    def forward(variables, x):
        _, mut = jmodel.apply(variables, x, n=1, train=True,
                              rngs={"sample": jax.random.PRNGKey(0)},
                              mutable=["batch_stats"])
        return mut["batch_stats"]

    stats = traverse_util.flatten_dict(forward(variables, x), sep="/")
    model = _port_model(flat)
    model.train()
    with torch.no_grad():
        model(torch.tensor(x), eps=torch.zeros((1, 4, 3)))
    keys = set(model.state_dict())
    for j, t in enumerate((1, 4, 7, 10)):
        for name in ("weight", "bias", "running_mean", "running_var",
                     "num_batches_tracked"):
            assert f"encoder.{t}.{name}" in keys
        bn = model.encoder[t]
        np.testing.assert_allclose(
            bn.running_mean.numpy(),
            np.asarray(stats[f"encoder/BatchNorm_{j}/mean"]), rtol=1e-5,
            atol=1e-6)
        np.testing.assert_allclose(
            bn.running_var.numpy(),
            np.asarray(stats[f"encoder/BatchNorm_{j}/var"]), rtol=1e-5,
            atol=1e-6)


# ------------------------------------------------------------ schedules

_XS = (0, 1, 1000, 2000, 20000, 30000, 45000, 60000, 90000, 120000,
       200000, 240000, 600000, 750000, 10 ** 7)


@pytest.mark.parametrize("name", sorted(jschedules._PRESETS) + [
    None, "warmup2000", "warmup2_000", "warmup1"])
def test_schedule_matches_jax(name):
    want = jschedules.get_beta_schedule(name, 0.7)
    got = get_beta_schedule(name, 0.7)
    assert [got(x) for x in _XS] == [want(x) for x in _XS]


@pytest.mark.parametrize("name,beta", [("t", 1.0), ("warmup0", 1.0),
                                       ("warmupx", 1.0), ("warmup", 1.0),
                                       (None, None)])
def test_bad_schedule_raises_as_in_jax(name, beta):
    with pytest.raises(ValueError):
        jschedules.get_beta_schedule(name, beta)
    with pytest.raises(ValueError, match="Wrong beta schedule"):
        get_beta_schedule(name, beta)


# ------------------------------------------------------------ optimizer

_OPT_SHAPES = {"encoder": {"w": (3, 4)}, "rep_group": {"b": (5,)},
               "decoder": {"item_rep": (4, 3)}}
_PORT_NAME = {"encoder/w": "encoder.w", "rep_group/b": "reparameterize.b",
              "decoder/item_rep": "decoder.item_rep"}


@pytest.mark.parametrize("cfg", [
    dict(clip_grads=1e-5), dict(clip_grads=None), dict(clip_grads=1e3),
    dict(clip_grads=1e-5, selective_clip=True),
    dict(clip_grads=1e-5, weight_decay=1e-2),
    dict(clip_grads=0.5, selective_clip=True, weight_decay=0.1),
], ids=["clip", "noclip", "clip-untriggered", "selective", "decay",
        "selective-decay"])
def test_optimizer_matches_optax(cfg):
    rng = np.random.default_rng(0)
    params = {top: {k: rng.normal(size=s) for k, s in sub.items()}
              for top, sub in _OPT_SHAPES.items()}
    scales = {"encoder/w": 1e-3, "rep_group/b": 1.0, "decoder/item_rep": 1e2}
    tx = jstate.make_optimizer(lr=1e-3, params=params, **cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    tparams = {_PORT_NAME[k]: torch.nn.Parameter(torch.tensor(v))
               for k, v in traverse_util.flatten_dict(params,
                                                      sep="/").items()}
    opt = make_optimizer(tparams, lr=1e-3, **cfg)
    for _ in range(5):
        flat = {k: rng.normal(size=v.shape) * scales[k]
                for k, v in traverse_util.flatten_dict(params,
                                                       sep="/").items()}
        grads = traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, v in flat.items():
            tparams[_PORT_NAME[k]].grad = torch.tensor(v)
        opt.step()
        for k, v in flat.items():           # step leaves .grad as it was
            np.testing.assert_array_equal(
                tparams[_PORT_NAME[k]].grad.numpy(), v)
    for k, v in traverse_util.flatten_dict(jparams, sep="/").items():
        np.testing.assert_allclose(tparams[_PORT_NAME[k]].detach().numpy(),
                                   np.asarray(v), rtol=1e-10, atol=1e-12)


def test_selective_clip_of_nothing_raises():
    with pytest.raises(ValueError, match="zero parameters"):
        make_optimizer({"decoder.w": torch.nn.Parameter(torch.zeros(2))},
                       selective_clip=True)


# ------------------------------------------------------------ train step


def _trajectories(dtype):
    """STEPS steps of the JAX step in ``dtype`` and of the port's in
    float32 on the same weights, images and noise."""
    jmodel = JaxLieVAE(**SMALL)
    flat = models_test._flat_jax_weights(jmodel, seed=2)
    variables = jax.tree_util.tree_map(
        lambda a: a.astype(dtype), models_test._unflatten(flat))
    tx = jstate.make_optimizer(lr=1e-3, clip_grads=1e-5)
    state = jstate.TrainState.create(params=variables["params"],
                                     batch_stats=variables["batch_stats"],
                                     tx=tx)

    @jax.jit
    def step(state, x, rng):
        x = x.astype(dtype) / 255.0

        def loss_fn(params):
            (recon, kl_sum, _, stats), mut = jmodel.apply(
                {"params": params, "batch_stats": state.batch_stats},
                x, n=1, train=True, method="elbo", rngs={"sample": rng},
                mutable=["batch_stats"])
            loss = jnp.mean(recon) + 1.0 * jnp.mean(kl_sum)
            eps = stats[0].inner.z / stats[0].inner.sigma
            return loss, (mut["batch_stats"], eps)

        (loss, (bs, eps)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        return state.apply_gradients(grads, new_batch_stats=bs), loss, \
            grads, eps

    model = _port_model(flat)
    opt = make_optimizer(model.named_parameters(), lr=1e-3, clip_grads=1e-5)
    steps, inputs = [], []
    for i in range(STEPS):
        x = _images(10 + i)
        before = state
        state, loss, grads, eps = step(state, jnp.asarray(x),
                                       jax.random.PRNGKey(20 + i))
        inputs.append((before, x, np.asarray(eps)))
        metrics = train_step(model, opt, torch.tensor(x), 1.0,
                             eps=torch.tensor(np.asarray(eps, np.float32)))
        grad_flat = {f"params/{k}": np.asarray(v) for k, v in
                     traverse_util.flatten_dict(grads, sep="/").items()}
        grad_flat.update({k: v for k, v in flat.items()
                          if k.startswith("batch_stats/")})
        want = state_dict_from_jax(grad_flat, model)
        got = {k: p.grad.detach().clone() for k, p in
               model.named_parameters()}
        steps.append((float(loss), metrics, want, got))
    final = {f"{c}/{k}": np.asarray(v) for c, tree in
             (("params", state.params), ("batch_stats", state.batch_stats))
             for k, v in traverse_util.flatten_dict(tree, sep="/").items()}
    return steps, state_dict_from_jax(final, model), model, inputs


@pytest.fixture(scope="module")
def trajectories():
    return _trajectories(jnp.float64)


@pytest.fixture(scope="module")
def trajectories_f32():
    return _trajectories(jnp.float32)


@pytest.mark.parametrize("i", range(STEPS))
def test_train_step_loss_and_grads_match_jax(trajectories, i):
    loss, metrics, want, got = trajectories[0][i]
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-5)
    assert float(metrics["recon"] + metrics["kl"]) == pytest.approx(
        loss, rel=1e-5)
    assert set(got) <= set(want) and len(got) == 33
    for name, g in got.items():
        ref = want[name].numpy()
        tol = 1e-4 * np.abs(ref).max() + 1e-5
        assert np.abs(g.numpy() - ref).max() <= tol, name


def test_params_and_batch_stats_after_steps_match_jax(trajectories):
    want, model = trajectories[1:3]
    got = model.state_dict()
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            assert int(got[name]) == STEPS
            continue
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_first_train_step_matches_float32_jax(trajectories_f32):
    """The port against JAX's own float32 step from the same weights, with
    the noise JAX drew (ROADMAP.md, Queue C, C2), at the float64 test's
    tolerances."""
    test_train_step_loss_and_grads_match_jax(trajectories_f32, 0)


def _flat_state(state):
    return {f"{c}/{k}": np.asarray(v) for c, tree in
            (("params", state.params), ("batch_stats", state.batch_stats))
            for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def float64_at_float32_states(trajectories_f32):
    """The float64 JAX loss and gradients at each state of the float32 JAX
    trajectory, with that step's float32 noise (``jax.random.normal`` is
    replaced while the step is traced, so the noise is an argument)."""
    jmodel = JaxLieVAE(**SMALL)

    @jax.jit
    def loss_and_grads(params, batch_stats, x, noise):
        def loss_fn(params):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax.random, "normal",
                           lambda key, shape, dtype=None:
                           noise.astype(dtype).reshape(shape))
                (recon, kl_sum, _, _), _ = jmodel.apply(
                    {"params": params, "batch_stats": batch_stats},
                    x.astype(jnp.float64) / 255.0, n=1, train=True,
                    method="elbo", rngs={"sample": jax.random.PRNGKey(0)},
                    mutable=["batch_stats"])
            return jnp.mean(recon) + 1.0 * jnp.mean(kl_sum)

        return jax.value_and_grad(loss_fn)(params)

    out = []
    for state, x, eps in trajectories_f32[3]:
        to64 = functools.partial(jax.tree_util.tree_map,
                                 lambda a: jnp.asarray(a, jnp.float64))
        loss, grads = loss_and_grads(to64(state.params),
                                     to64(state.batch_stats), jnp.asarray(x),
                                     jnp.asarray(eps, jnp.float64))
        out.append((float(loss), grads))
    return out


@pytest.mark.parametrize("i", range(STEPS))
def test_port_matches_float64_at_float32_jax_states(
        trajectories_f32, float64_at_float32_states, i):
    state, x, eps = trajectories_f32[3][i]
    flat = _flat_state(state)
    model = _port_model(flat)
    opt = make_optimizer(model.named_parameters(), lr=1e-3, clip_grads=1e-5)
    metrics = train_step(model, opt, torch.tensor(x), 1.0,
                         eps=torch.tensor(eps))
    loss, grads = float64_at_float32_states[i]
    grad_flat = {f"params/{k}": np.asarray(v) for k, v in
                 traverse_util.flatten_dict(grads, sep="/").items()}
    grad_flat.update({k: v for k, v in flat.items()
                      if k.startswith("batch_stats/")})
    want = state_dict_from_jax(grad_flat, model)
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-5)
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        tol = 1e-4 * np.abs(ref).max() + 1e-5
        assert np.abs(p.grad.numpy() - ref).max() <= tol, name


def test_beta_zero_skips_the_kl(monkeypatch):
    """At beta = 0 the KL is never computed: a NaN KL would otherwise reach
    the shared gradients."""
    flat = models_test._flat_jax_weights(JaxLieVAE(**SMALL))
    model = _port_model(flat)
    monkeypatch.setattr(tdist.SO3Stats, "kl",
                        lambda self: torch.full(self.inner.z.shape[1:2],
                                                float("nan")))
    opt = make_optimizer(model.named_parameters())
    metrics = train_step(model, opt, torch.tensor(_images(3)), 0.0,
                         eps=torch.zeros((1, 4, 3)), monitor_sigma=True)
    assert float(metrics["kl"]) == 0.0 and metrics["kls"][0] == 0.0
    assert float(metrics["loss"]) == float(metrics["recon"])
    assert float(metrics["sigma_max"]) > 0.0
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        assert torch.isfinite(p).all(), name
    with pytest.raises(NotImplementedError, match="A6"):
        train_step(model, opt, torch.tensor(_images(3)), 1.0,
                   equivariance_lamb=1.0)


@pytest.mark.parametrize("control_p", [1, 2])
def test_control_loss_forms(control_p):
    flat = models_test._flat_jax_weights(JaxLieVAE(**SMALL))
    model = _port_model(flat)
    eps = torch.tensor(np.random.default_rng(0).normal(size=(1, 4, 3)),
                       dtype=torch.float32)
    x = torch.tensor(_images(4))
    with torch.no_grad():
        model.train()
        recon, kl_sum, _, _ = _port_model(flat).train().elbo(
            x.float() / 255.0, eps=eps)
    want = recon.mean() + 0.5 * (torch.abs(2.0 - kl_sum) if control_p == 1
                                 else (2.0 - kl_sum) ** 2).mean()
    metrics = train_step(model, make_optimizer(model.named_parameters()), x,
                         2.0, eps=eps, control=0.5, control_p=control_p)
    assert float(metrics["loss"]) == pytest.approx(float(want), rel=1e-6)
