"""The paper's regularised training in the port held against the JAX
package's: the equivariance and encoder-continuity losses in the train step,
the sc-pairs data and the ``--config scpairs reg`` CLI.

- ``train_step`` with both losses (weights 100 and 3000, the ``reg``
  preset's) on the small flagship-shaped model of
  ``test_torch_port_train.py`` (S2xS2, L = 3, 3 copies, conv 4, deconv 8,
  RGB, BatchNorm), batch 4 = 2 pairs of 64x64 uint8 images, training in
  float32, against the JAX harness's own step
  (``UnsupervisedExperiment._build_train_step``) run in float64 from the
  same weights: 3 steps with the 'shear' rotation, one with 'gather', one
  at beta = 0. The JAX step splits its key into ``k_sample, k_eq,
  k_eq_enc``; theta is replayed from ``k_eq`` outside it, and the two
  passes' posterior noise is handed to both (``jax.random.normal`` is
  replaced while the step is traced), so the port gets the JAX step's
  theta and noises. Tolerances as ``test_torch_port_train.py``'s: loss at
  rtol 1e-5; a gradient tensor within 1e-4 * max|reference| + 1e-5, where
  the reference of a conv bias that feeds a BatchNorm is its conv weight's
  gradient (its own is 0 in exact arithmetic, the batch mean being
  subtracted: the port's float32 sum of the regularised loss's large
  cotangents leaves 3e-6 of the weight's gradient there, against 1e-10
  of it in float64); parameters and running statistics at rtol 1e-4, atol
  1e-5 after the
  steps (the statistics after both encoder passes of each step: the port's
  BatchNorm counts two batches a step);
- ``ScPairsDataset`` and ``prep_batch``: pairs rendered by the JAX
  generator (PNG files, the numpy ray-caster) and by the port's from the
  same seed, read by each package's dataset, whole and subsampled: equal
  items, poses and pair order, flattened to rows (2i, 2i + 1);
  ``sample_poses(pairs=True)`` bit for bit against the JAX sampler; the
  port's ``--singles`` output unchanged;
- ``cli.main --config scpairs reg`` end to end on the CPU at a tiny size:
  the four regularizer tags logged and finite, a checkpoint, an IW-LL.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import test_torch_port_models as models_test
from lie_vae_tpu.cli import gen_spherecube as jgen
from lie_vae_tpu.data import ScPairsDataset as JaxScPairsDataset
from lie_vae_tpu.data import render as jrender
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu.train import loop as jloop
from lie_vae_tpu.train import schedules as jschedules
from lie_vae_tpu.train import state as jstate
from lie_vae_tpu_torch.cli import gen_spherecube
from lie_vae_tpu_torch.cli import main as cli_main
from lie_vae_tpu_torch.compat import state_dict_from_jax
from lie_vae_tpu_torch.data import ScPairsDataset, SphereCubeDataset
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.train import make_optimizer, train_step
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

SMALL = dict(latent_mode="so3", decoder_mode="action", encode_mode="conv",
             deconv_mode="deconv", mean_mode="s2s2", degrees=3, rep_copies=3,
             conv_hidden=4, deconv_hidden=8, rgb=True, batch_norm=True)
STEPS = 3
LAMB_EQ, LAMB_CONT = 100.0, 3000.0
B = 4


class _Items:
    """A dataset of uint8 images for the JAX harness's constructor."""

    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def gather(self, idx):
        return (np.zeros(len(idx), np.int32), None, self.images[idx])

    @staticmethod
    def prep_batch(batch):
        return batch


def _images(seed):
    return np.random.default_rng(seed).integers(0, 256, (B, 64, 64, 3),
                                                dtype=np.uint8)


def _flat(tree, coll):
    return {f"{coll}/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def _port_model(flat):
    model = LieVAE(device="cpu", **SMALL)
    model.load_state_dict(state_dict_from_jax(flat, model), strict=True)
    return model


@pytest.fixture(scope="module")
def jax_step():
    """The JAX harness's regularised train step in float64, jitted once:
    (state, x, beta, rng, noise of the main pass, noise of the equivariance
    pass, rotation) -> (state, metrics, gradients)."""
    jmodel = JaxLieVAE(**SMALL)
    flat = models_test._flat_jax_weights(jmodel, seed=5)
    variables = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                       models_test._unflatten(flat))
    tx = jstate.make_optimizer(lr=1e-3, clip_grads=1e-5)
    state = jstate.TrainState.create(params=variables["params"],
                                     batch_stats=variables["batch_stats"],
                                     tx=tx)
    const = jschedules.ConstantSchedule
    steps = {}
    for impl in ("shear", "gather"):
        exp = jloop.UnsupervisedExperiment(
            model=jmodel, train_dataset=_Items(_images(0)),
            test_dataset=_Items(_images(0)), beta_schedule=const(1.0),
            lr=1e-3, clip_grads=1e-5, batch_size=B,
            equivariance_lamb=const(LAMB_EQ),
            encoder_continuity_lamb=const(LAMB_CONT), init_state=state,
            equivariance_rotate=impl)
        steps[impl] = _capturing(exp._build_train_step())
    return flat, state, steps


def _capturing(step):
    @jax.jit
    def run(state, x, beta, rng, noise_main, noise_eq):
        noises, grads = [noise_main, noise_eq], {}
        apply = jstate.TrainState.apply_gradients

        def capture(self, g, **kw):
            grads["g"] = g
            return apply(self, g, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal",
                       lambda key, shape, dtype=None:
                       noises.pop(0).astype(dtype).reshape(shape))
            mp.setattr(jstate.TrainState, "apply_gradients", capture)
            new_state, metrics = step(state, x, beta, LAMB_EQ, LAMB_CONT,
                                      rng)
        assert not noises, "the step drew other than two noises"
        return new_state, metrics, grads["g"]

    return run


def _theta(rng):
    """The JAX step's rotation angles, replayed from its key."""
    _, k_eq, _ = jax.random.split(rng, 3)
    return np.asarray(jax.random.uniform(k_eq, (B,), dtype=jnp.float64)
                      * 2.0 * math.pi)


def _run(jax_step, impl, steps, beta=1.0):
    """``steps`` steps of the JAX step and of the port's on the same
    weights, images, theta and noises; per step (JAX loss, JAX metrics,
    port metrics, JAX gradients as the port's state_dict keys, port
    gradients), and the final states."""
    flat, state, fns = jax_step
    model = _port_model(flat)
    opt = make_optimizer(model.named_parameters(), lr=1e-3, clip_grads=1e-5)
    out = []
    for i in range(steps):
        x = _images(10 + i)
        rng = jax.random.PRNGKey(20 + i)
        noise = np.random.default_rng(30 + i).normal(size=(2, 1, B, 3))
        state, jm, grads = fns[impl](
            state, jnp.asarray(x, jnp.float64) / 255.0, beta, rng,
            jnp.asarray(noise[0]), jnp.asarray(noise[1]))
        tm = train_step(model, opt, torch.tensor(x), beta,
                        eps=torch.tensor(noise[0], dtype=torch.float32),
                        equivariance_lamb=LAMB_EQ,
                        encoder_continuity_lamb=LAMB_CONT,
                        equivariance_rotate=impl, theta=_theta(rng),
                        eq_eps=torch.tensor(noise[1], dtype=torch.float32))
        gflat = _flat(grads, "params")
        gflat.update({k: v for k, v in flat.items()
                      if k.startswith("batch_stats/")})
        out.append((jm, tm, state_dict_from_jax(gflat, model),
                    {k: p.grad.detach().clone()
                     for k, p in model.named_parameters()}))
    final = _flat(state.params, "params")
    final.update(_flat(state.batch_stats, "batch_stats"))
    return out, state_dict_from_jax(final, model), model


@pytest.fixture(scope="module")
def shear_run(jax_step):
    return _run(jax_step, "shear", STEPS)


# the conv biases before a BatchNorm: encoder.{0,3,6,9} feed encoder.{1,..}
PRE_BN = {f"encoder.{i}.bias": f"encoder.{i}.weight" for i in (0, 3, 6, 9)}


def _check_step(jm, tm, want, got):
    for key in ("loss", "recon", "kl", "equivariance", "encoder_continuity"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5), key
    assert len(got) == 33
    for name, g in got.items():
        ref = want[name].numpy()
        scale = want[PRE_BN.get(name, name)].numpy()
        tol = 1e-4 * np.abs(scale).max() + 1e-5
        assert np.abs(g.numpy() - ref).max() <= tol, name


def _check_state(want, model, steps):
    got = model.state_dict()
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            # each step runs the encoder twice in train mode
            assert int(got[name]) == (2 * steps
                                      if name.startswith("encoder.")
                                      else steps)
            continue
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("i", range(STEPS))
def test_regularised_step_matches_jax(shear_run, i):
    jm, tm, want, got = shear_run[0][i]
    assert float(tm["equivariance"]) > 0 and \
        float(tm["encoder_continuity"]) > 0
    _check_step(jm, tm, want, got)


def test_params_and_batch_stats_after_regularised_steps(shear_run):
    want, model = shear_run[1:]
    _check_state(want, model, STEPS)


def test_batch_stats_advance_twice_a_step(jax_step):
    """The second encoder pass runs in train mode after the main pass: the
    running statistics kept are those after both, not after the main pass
    alone."""
    flat, _, _ = jax_step
    once, twice = _port_model(flat), _port_model(flat)
    x = torch.tensor(_images(10)).float() / 255.0
    eps = torch.zeros((1, B, 3))
    for model in (once, twice):
        opt = make_optimizer(model.named_parameters())
        train_step(model, opt, x, 1.0, eps=eps,
                   equivariance_lamb=None if model is once else LAMB_EQ,
                   theta=np.full(B, 0.3), eq_eps=eps)
    mean = "encoder.1.running_mean"
    assert int(twice.state_dict()["encoder.1.num_batches_tracked"]) == 2
    assert not torch.allclose(once.state_dict()[mean],
                              twice.state_dict()[mean])


def test_gather_rotation_step_matches_jax(jax_step):
    steps, want, model = _run(jax_step, "gather", 1)
    _check_step(*steps[0])
    _check_state(want, model, 1)


def test_beta_zero_keeps_the_regularizers(jax_step):
    """At beta = 0 the KL is skipped and both losses still add."""
    steps, want, model = _run(jax_step, "shear", 1, beta=0.0)
    jm, tm = steps[0][:2]
    assert float(tm["kl"]) == 0.0
    assert float(tm["loss"]) == pytest.approx(
        float(tm["recon"]) + LAMB_EQ * float(tm["equivariance"])
        + LAMB_CONT * float(tm["encoder_continuity"]), rel=1e-6)
    _check_step(*steps[0])
    _check_state(want, model, 1)


def test_equivariance_draws_theta_and_noise_from_the_generator():
    """Without theta and eq_eps the step draws both from its generator:
    two runs from one seed agree, two seeds differ."""
    flat = models_test._flat_jax_weights(JaxLieVAE(**SMALL))
    x = torch.tensor(_images(3))
    losses = []
    for seed in (1, 1, 2):
        model = _port_model(flat)
        m = train_step(model, make_optimizer(model.named_parameters()), x,
                       1.0, generator=torch.Generator().manual_seed(seed),
                       equivariance_lamb=1.0, encoder_continuity_lamb=1.0)
        losses.append(float(m["equivariance"]))
    assert losses[0] == losses[1] != losses[2]


# ------------------------------------------------------------- sc-pairs

NP = 12


def test_sample_poses_pairs_match_jax():
    for pairs in (True, False):
        want = jgen.sample_poses(NP, 0.2, pairs, 7)
        got = gen_spherecube.sample_poses(NP, 0.2, pairs, 7)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    assert got[0].shape == (NP, 1, 3, 3)
    assert want[0].shape == (NP, 1, 3, 3)
    r, q = gen_spherecube.sample_poses(NP, 0.2, True, 7)
    assert r.shape == (NP, 2, 3, 3) and q.shape == (NP, 2, 4)


@pytest.fixture(scope="module")
def pair_sets(tmp_path_factory):
    """NP pairs from seed 3 rendered by each package's generator."""
    root = tmp_path_factory.mktemp("pairs")
    jdir, tdir = str(root / "jax" / "sc-pairs"), str(root / "port" /
                                                     "sc-pairs")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrender, "_NATIVE", None)        # the numpy ray-caster
        jgen.generate(NP, jdir, 2 * np.pi / 60, pairs=True, seed=3)
    gen_spherecube.main([str(NP), tdir, "--seed", "3"])
    return jdir, tdir


@pytest.mark.parametrize("subsample", [1.0, 0.5])
def test_sc_pairs_dataset_matches_jax(pair_sets, subsample):
    jdir, tdir = pair_sets
    jset = JaxScPairsDataset(jdir, subsample=subsample)
    tset = ScPairsDataset(tdir, subsample=subsample)
    assert len(tset) == len(jset) == int(NP * subsample)
    np.testing.assert_array_equal(tset.indices, jset.indices)
    idx = np.arange(len(jset))[::-1]
    want, got = jset.gather(idx), tset.gather(idx)
    assert got[2].dtype == np.uint8 and got[2].shape[:2] == (len(idx), 2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    for w, g in zip(JaxScPairsDataset.prep_batch(want),
                    ScPairsDataset.prep_batch(got)):
        np.testing.assert_array_equal(g, w)
    names, poses, images = tset[1]
    np.testing.assert_array_equal(images, got[2][-2] / np.float32(255.0))


def test_prep_batch_puts_pair_i_on_rows_2i_and_2i_plus_1(pair_sets):
    _, tdir = pair_sets
    rows = np.load(os.path.join(tdir, "images.npy"))
    tset = ScPairsDataset(tdir)
    _, poses, images = ScPairsDataset.prep_batch(tset.gather([4, 1]))
    np.testing.assert_array_equal(images, rows[[8, 9, 2, 3]])
    assert poses.shape == (4, 3, 3)
    # the same directory read as single images holds all 2 NP renders
    assert len(SphereCubeDataset(tdir)) == 2 * NP


def test_device_data_gathers_both_rows_of_a_pair(pair_sets):
    """``device_data`` caches the flattened pairs and gathers rows 2i and
    2i + 1 of each drawn item: the batches the loader yields on the host."""
    from lie_vae_tpu_torch.train import (ConstantSchedule,
                                         UnsupervisedExperiment)
    _, tdir = pair_sets
    data = ScPairsDataset(tdir)
    model = LieVAE(device="cpu", **dict(SMALL, degrees=2, rep_copies=2))
    runs = [UnsupervisedExperiment(
        model=model, train_dataset=data, test_dataset=data,
        beta_schedule=ConstantSchedule(1.0), batch_size=4, seed=3,
        device_data=cached) for cached in (False, True)]
    host, device = (list(e._batches(e.train_loader, e._device_train))
                    for e in runs)
    assert len(host) == len(device) == NP // 4
    for h, d in zip(host, device):
        assert d.shape == (8, 64, 64, 3)
        np.testing.assert_array_equal(d.numpy(), h)


def test_singles_output_is_unchanged(tmp_path):
    """--singles draws the single poses as before pairs were added."""
    d = str(tmp_path / "singles")
    gen_spherecube.main(["3", d, "--singles", "--seed", "5"])
    with np.load(os.path.join(d, "_poses.npz")) as f:
        r, meta, step = f["r"], f["meta"], float(f["step_size"])
    want, _ = jgen.sample_poses(3, 0.0, False, 5)
    np.testing.assert_array_equal(r, want)
    np.testing.assert_array_equal(meta, [3, 1, 64, 5])
    assert step == 0.0


# ------------------------------------------------------------------ CLI

_TINY = ["--device", "cpu", "--degrees", "2", "--rep_copies", "2",
         "--conv_hidden", "4", "--deconv_hidden", "8"]


def test_cli_scpairs_reg_end_to_end(tmp_path, monkeypatch, capsys):
    """--config scpairs reg: one epoch over 60 rendered pairs (36 train
    pairs: one batch of the CLI's 32 pairs), a checkpoint and the IW-LL of
    two items."""
    data = str(tmp_path / "sc-pairs")
    gen_spherecube.main(["60", data])
    monkeypatch.chdir(tmp_path)
    experiment = cli_main.main(_TINY + [
        "--config", "scpairs", "reg", "--kernel_impl", "pallas",
        "--data_dir", data, "--epochs", "1", "--report_freq", "1",
        "--save_dir", "out", "--log_dir", "logs", "--ll_samples", "4",
        "--ll_max_items", "2"])
    out = capsys.readouterr().out
    assert "Dataset splits: train=36, valid=12, test=12" in out
    assert experiment.optimizer.count == 1
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        logged = {r["tag"]: r["value"] for r in map(json.loads, f)}
    for tag in ("equivariance", "equivariance_lamb", "encoder_continuity",
                "encoder_continuity_lamb"):
        assert math.isfinite(logged[tag]), tag
    assert logged["equivariance"] > 0 and logged["encoder_continuity"] > 0
    # LinearSchedule(0, v, 1000, end_it) is 0 at step 1
    assert logged["equivariance_lamb"] == logged[
        "encoder_continuity_lamb"] == 0.0
    assert os.path.exists(tmp_path / "out" / cli_main.CHECKPOINT)
    items = experiment.last_ll["items"]
    assert len(items) == 2 and np.isfinite(items).all()
