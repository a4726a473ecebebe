"""The port's per-stack compute dtypes held against the JAX package's.

A small conv model (S2xS2 mean, RGB, L = 2, 2 copies, deconv width 8,
BatchNorm, deterministic: no noise), the JAX model's own bf16 test
configuration (``tests/test_models.py::test_per_stack_dtype_overrides``),
batch 2, one train-mode forward (BatchNorm on batch statistics) and the
gradient of mean(recon) + mean(KL), from the same JAX weights carried
across by ``state_dict_from_jax``:

- every stack overridden to float32 (``compute_dtype='bfloat16'``,
  ``encoder_dtype`` and ``decoder_dtype`` ``'float32'``) equals the
  float32 model within 1e-5;
- the port's bfloat16 image, and its parameter gradients but the conv and
  linear biases' taken together, are within half of the JAX bfloat16
  model's own distance from its float32 run of the JAX bfloat16 ones (L2):
  the two bfloat16 implementations agree with each other better than
  either with float32. bfloat16 keeps 8 bits, so no fixed float tolerance
  fits: the two round at the same points (flax's: input, weight and bias
  cast, the product rounded, the bias added in bfloat16; BatchNorm in
  float32, rounded once; the JAX model compiled without XLA's excess
  precision, so it keeps them too) but sum their products in other
  orders, and once one rounding differs, the layers after it differ more.
  The ratios are printed (``-s``) and kept in ``PERF.md``;
- the conv and linear bias gradients, which the JAX bf16 model sums in
  bfloat16 (ROADMAP.md, Queue C, C4), are held to float32 instead;
- LeakyReLU on bfloat16 equals flax's bit for bit: flax multiplies by the
  slope rounded to bfloat16 (ROADMAP.md, Queue C, C6);
- the last encoder conv's and the sigma head's weight gradients, each on
  its own, within 1.5 times the JAX bf16 model's own spread: its distance
  from itself when every input pixel moves by one float32 ulp (which flips
  bfloat16 roundings at ties, as the two implementations' float32
  arithmetic does), over its distance from float32. The rounding points
  agree (C6); what is left is where ties fall;
- ``decoder_dtype='float32'`` is no farther from float32 than all-bf16;
- ``bench.py``'s recipe (``bench_model``: bf16 stacks, float32 image head,
  sigma clamp) keeps the flagship's state_dict, loads the converged
  reference weights strictly, and trains one step at a small width with
  finite loss and gradients, float32 parameters and a float32 image.
"""
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import test_torch_port_models as models_test
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu_torch import compat
from lie_vae_tpu_torch.compat import state_dict_from_jax
from lie_vae_tpu_torch.models import LieVAE, bench_model, flagship_model
from lie_vae_tpu_torch.train import make_optimizer, train_step
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

KW = dict(latent_mode="so3", decoder_mode="action", mean_mode="s2s2",
          encode_mode="conv", deconv_mode="deconv", rgb=True, degrees=2,
          deconv_hidden=8, conv_hidden=8, rep_copies=2, deterministic=True)
BF16 = dict(compute_dtype="bfloat16")
ALL_F32 = dict(compute_dtype="bfloat16", encoder_dtype="float32",
               decoder_dtype="float32")
DEC_F32 = dict(compute_dtype="bfloat16", decoder_dtype="float32")
RATIO = 0.5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "converged_state", "torch_clean", "best.pt")


@pytest.fixture(scope="module")
def setup():
    flat = models_test._flat_jax_weights(JaxLieVAE(**KW), seed=1)
    x = np.random.default_rng(2).random((2, 64, 64, 3), dtype=np.float32)
    return flat, x


def _ulp(x):
    """x with every element moved up by one float32 ulp."""
    return np.nextafter(x, np.float32(np.inf)).astype(np.float32)


def _jax_run(flat, x, **dtypes):
    """Train-mode image and parameter gradients of the JAX model."""
    jmodel = JaxLieVAE(**KW, **dtypes)
    variables = models_test._unflatten(flat)

    @jax.jit
    def run(variables, x):
        def loss_fn(params):
            (out, stats), _ = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                x, n=1, train=True, rngs={"sample": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            recon = jnp.sum((out - x) ** 2, axis=(2, 3, 4))
            return jnp.mean(recon) + jnp.mean(stats[0].kl()), out

        (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        return out, grads

    # flax's rounding points kept: XLA may otherwise skip the rounding of
    # bfloat16 intermediates (excess precision)
    compiled = run.lower(variables, jnp.asarray(x)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    out, grads = compiled(variables, jnp.asarray(x))
    gflat = {f"params/{k}": np.asarray(v, np.float32) for k, v in
             traverse_util.flatten_dict(grads, sep="/").items()}
    gflat.update({k: v for k, v in flat.items()
                  if k.startswith("batch_stats/")})
    port = LieVAE(device="cpu", **KW)
    g = state_dict_from_jax(gflat, port)
    return np.asarray(out, np.float32), {
        k: g[k].numpy() for k, _ in port.named_parameters()}


def _port_run(flat, x, **dtypes):
    model = LieVAE(device="cpu", **KW, **dtypes)
    model.load_state_dict(state_dict_from_jax(flat, model), strict=True)
    model.train()
    xt = torch.tensor(x)
    out, stats = model(xt)
    loss = model.recon_loss(out, xt).mean() + stats[0].kl().mean()
    loss.backward()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert out.dtype == torch.float32
    return out.detach().numpy(), {k: p.grad.numpy()
                                  for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def runs(setup):
    flat, x = setup
    return {
        "jax_f32": _jax_run(flat, x), "jax_bf16": _jax_run(flat, x, **BF16),
        "jax_bf16_ulp": _jax_run(flat, _ulp(x), **BF16),
        "f32": _port_run(flat, x), "bf16": _port_run(flat, x, **BF16),
        "all_f32": _port_run(flat, x, **ALL_F32),
        "dec_f32": _port_run(flat, x, **DEC_F32)}


def _dist(a, b, norm=lambda d: np.abs(d).max()):
    """max |a - b| (or ``norm``) of the image, and of each gradient."""
    out = {"image": float(norm(a[0] - b[0]))}
    out.update({k: float(norm(a[1][k] - b[1][k])) for k in a[1]})
    return out


def _l2(d):
    return np.sqrt(np.sum(np.square(d.astype(np.float64))))


def test_float32_port_matches_jax(runs):
    for key, dist in _dist(runs["f32"], runs["jax_f32"]).items():
        scale = max(1.0, float(np.abs(
            runs["jax_f32"][0] if key == "image"
            else runs["jax_f32"][1][key]).max()))
        assert dist <= 1e-4 * scale, (key, dist)


def test_all_stacks_float32_equals_float32(runs):
    for key, dist in _dist(runs["all_f32"], runs["f32"]).items():
        scale = max(1.0, float(np.abs(
            runs["f32"][0] if key == "image" else runs["f32"][1][key]).max()))
        assert dist <= 1e-5 * scale, (key, dist)


def _is_bias(key, model=LieVAE(device="cpu", **KW)):
    return key.endswith(".bias") and isinstance(
        model.get_submodule(key[:-len(".bias")]),
        (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d))


def _concat(run, keys):
    return np.concatenate([run[1][k].ravel() for k in keys])


def test_bf16_agrees_with_jax_bf16_better_than_with_float32(runs):
    """The image, and the gradients of every parameter but the conv and
    linear biases taken together: ||port bf16 - JAX bf16|| <= RATIO *
    ||JAX bf16 - JAX f32|| (L2). Per tensor the ratios are printed."""
    port, jbf, jf = runs["bf16"], runs["jax_bf16"], runs["jax_f32"]
    ours, theirs = _dist(port, jbf, _l2), _dist(jbf, jf, _l2)
    print("per tensor ||port - JAX bf16|| / ||JAX bf16 - JAX f32||:",
          {k: round(ours[k] / theirs[k], 3) for k in ours})
    assert ours["image"] <= RATIO * theirs["image"], (ours["image"],
                                                      theirs["image"])
    weights = [k for k in port[1] if not _is_bias(k)]
    a = _l2(_concat(port, weights) - _concat(jbf, weights))
    b = _l2(_concat(jbf, weights) - _concat(jf, weights))
    print(f"image {ours['image'] / theirs['image']:.3f}, weight "
          f"gradients together {a / b:.3f}")
    assert a <= RATIO * b, (a, b)


def test_bf16_bias_gradients_no_farther_from_float32_than_jax(runs):
    """Conv and linear bias gradients: the sum over (N, H, W) of a bfloat16
    cotangent. The JAX bf16 model's (XLA on the CPU) sums them in bfloat16
    and loses up to all of the image head's (ROADMAP.md, Queue C, C4); the
    port sums in float32 and rounds once. So they are held to float32: all
    of them together no farther from the float32 port's than the JAX bf16
    ones are from the JAX float32 ones, and the two largest sums' (the
    last hidden deconv's, 32x32 positions, and the image head's, 64x64)
    within 1% of the float32 port's."""
    port, jbf, jf, f32 = (runs["bf16"], runs["jax_bf16"], runs["jax_f32"],
                          runs["f32"])
    biases = [k for k in port[1] if _is_bias(k)]
    a = _l2(_concat(port, biases) - _concat(f32, biases))
    b = _l2(_concat(jbf, biases) - _concat(jf, biases))
    print(f"bias gradients from float32: port {a:.4g}, JAX bf16 {b:.4g}")
    assert a <= b, (a, b)
    for k in ("decoder.deconv.7.bias", "decoder.deconv.9.bias"):
        ref = f32[1][k]
        print(f"{k}: port {_l2(port[1][k] - ref) / _l2(ref):.2e}, JAX bf16 "
              f"{_l2(jbf[1][k] - jf[1][k]) / _l2(jf[1][k]):.2e} of its norm "
              "from float32")
        assert _l2(port[1][k] - ref) <= 0.01 * _l2(ref), k


def test_leaky_relu_rounds_its_slope_as_flax():
    """flax's leaky_relu on bfloat16 multiplies by bfloat16(0.2) =
    0.2001953125 (JAX casts the weakly typed Python float to the input's
    dtype); the port's LeakyReLU does the same, bit for bit, over every
    finite negative bfloat16 of magnitude below 2^16 and a few positive
    ones, forward and backward."""
    from flax import linen as fnn
    from lie_vae_tpu_torch.models.nets import LeakyReLU
    bits = np.arange(0x8D00, 0xC780, dtype=np.uint32)
    x = (bits << 16).view(np.float32)
    x = np.concatenate([x, -x[:: 97]])
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    @jax.jit
    def ref(x, g):
        y, vjp = jax.vjp(lambda x: fnn.leaky_relu(x, 0.2),
                         x.astype(jnp.bfloat16))
        return y, vjp(g.astype(jnp.bfloat16))[0]

    compiled = ref.lower(x, g).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want_y, want_g = (np.asarray(a, np.float32) for a in compiled(x, g))
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    y = LeakyReLU(0.2)(xt)
    y.backward(torch.tensor(g).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.detach().float().numpy(), want_y)
    np.testing.assert_array_equal(xt.grad.float().numpy(), want_g)
    plain = torch.nn.functional.leaky_relu(xt.detach(), 0.2).float().numpy()
    assert (plain != want_y).any()      # the plain op rounds otherwise


@pytest.mark.parametrize("key", [
    "encoder.12.weight",
    "reparameterize.0.reparameterize.sigma_linear.weight"])
def test_bf16_last_conv_and_sigma_head_gradients(runs, key):
    """||port bf16 - JAX bf16|| / ||JAX bf16 - JAX f32|| for the tensor,
    within 1.5 times the same ratio of the JAX bf16 model against itself
    with its input one float32 ulp up (ROADMAP.md, Queue C, C6)."""
    port, jbf, jf, jbu = (runs["bf16"][1][key], runs["jax_bf16"][1][key],
                          runs["jax_f32"][1][key],
                          runs["jax_bf16_ulp"][1][key])
    spread = _l2(jbf - jf)
    ratio, floor = _l2(port - jbf) / spread, _l2(jbu - jbf) / spread
    print(f"{key}: port {ratio:.3f}, JAX one ulp up {floor:.3f}")
    assert ratio <= 1.5 * floor, (ratio, floor)


def test_decoder_float32_is_no_farther_than_all_bf16(runs):
    assert _dist(runs["dec_f32"], runs["f32"])["image"] <= _dist(
        runs["bf16"], runs["f32"])["image"]


def test_bench_model_is_the_flagship_in_bf16():
    model = bench_model("cpu")
    flagship = flagship_model("cpu")
    assert list(model.state_dict()) == list(flagship.state_dict())
    weights = compat.load_torch(CHECKPOINT)
    model.load_state_dict(weights, strict=True)
    flagship.load_state_dict(weights, strict=True)
    rep = model.reparameterize[0]
    assert rep.sigma_clamp == pytest.approx(math.pi * 10 / 2)
    convs = [m for m in model.modules() if hasattr(m, "compute_dtype")]
    head = model.decoder.deconv[-1]
    assert head.compute_dtype == torch.float32
    assert all(m.compute_dtype == torch.bfloat16
               for m in convs if m is not head)


def test_bench_recipe_trains_one_step():
    """bench.py's dtypes at a small width: one train_step, finite loss and
    gradients, every parameter float32, and every tensor with a non-zero
    gradient moved (a conv bias before BatchNorm has an exact gradient of
    0, which bf16 sums can hit)."""
    torch.manual_seed(0)
    model = LieVAE(device="cpu", sigma_clamp=math.pi * 10 / 2,
                   compute_dtype="bfloat16", deconv_head_dtype="float32",
                   **dict(KW, deterministic=False))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = make_optimizer(model.named_parameters(), lr=1e-3, clip_grads=1e-5)
    x = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3), np.uint8)
    metrics = train_step(model, opt, x, 1.0,
                         generator=torch.Generator().manual_seed(0))
    assert math.isfinite(float(metrics["loss"]))
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all(), k
        if p.grad.any():
            assert not torch.equal(p.detach(), before[k]), k
