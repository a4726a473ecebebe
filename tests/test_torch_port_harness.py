"""The port's experiment harness, checkpoints and CLI held against the JAX
package's, on the CPU at a small size.

- One epoch and its ``test()`` of ``UnsupervisedExperiment`` with
  ``kernel_impl='pallas'`` (the plain version of K5/K6 on the CPU) over
  sphere-cube renders, a small flagship-shaped model (``SMALL`` of
  ``test_torch_port_train.py``), batch 4, a 12-item training split (3
  steps) and a 10-item evaluation split (batches of 4, 4 and a ragged 2),
  against the same loop built from jitted JAX float64 steps in the JAX
  loader's order, the noise JAX drew handed over: the reported train and
  test means (recon and loss at rtol 1e-5, the KL within 1e-5 of the loss,
  as ``test_torch_port_train.py`` holds a step's loss), parameters and
  running statistics after the epoch at rtol 1e-4, atol 1e-5;
- ``LieVAE.log_weights`` and ``log_likelihood``, and the harness's
  per-item ``log_likelihood`` (batches of 3 with a ragged tail, the samples
  in 2 chunks), in float64 against the JAX model's with the JAX noise
  handed over, at rtol 1e-6;
- the checkpoint round trip, ``InferenceSession.from_checkpoint`` included;
- ``cli.main.main`` on the CPU end to end over one epoch of a tiny split
  of sphere-cube renders, and the modes it does not run raising with their
  ROADMAP.md items (the toy dataset and the other model modes:
  ``test_torch_port_toy.py``).
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
from test_torch_port_train import SMALL
from lie_vae_tpu.data import BatchLoader as JaxBatchLoader
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu.train import state as jstate
from lie_vae_tpu_torch.cli import gen_spherecube
from lie_vae_tpu_torch.cli import main as cli_main
from lie_vae_tpu_torch.cli import serve as cli_serve
from lie_vae_tpu_torch.compat import state_dict_from_jax
from lie_vae_tpu_torch.data import SphereCubeDataset, random_split
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.serve import InferenceSession
from lie_vae_tpu_torch.train import (ConstantSchedule, UnsupervisedExperiment,
                                     make_optimizer, train_step)
from lie_vae_tpu_torch.train.checkpoint import (load_checkpoint,
                                                restore_state, save_state)
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """22 renders of the tracked manifest's first poses."""
    out = str(tmp_path_factory.mktemp("data") / "spherecube")
    gen_spherecube.generate(22, out)
    return out


@pytest.fixture(scope="module")
def weights():
    return models_test._flat_jax_weights(JaxLieVAE(**SMALL), seed=2)


def _port_model(flat, dtype=torch.float32):
    model = LieVAE(device="cpu", kernel_impl="pallas", **SMALL)
    model.load_state_dict(state_dict_from_jax(flat, model), strict=True)
    return model.to(dtype)


class _Noise:
    """Stands in for the harness's noise streams: hands out the given
    arrays in order."""

    def __init__(self, arrays, dtype):
        self.arrays, self.dtype = list(arrays), dtype

    def __call__(self, stream, n, batch):
        eps = torch.tensor(self.arrays.pop(0), dtype=self.dtype)
        assert eps.shape == (n, batch, 3), (stream, eps.shape)
        return eps


# ------------------------------------------------------------ one epoch


@pytest.fixture(scope="module")
def epoch(renders, weights, tmp_path_factory):
    """One epoch and test() of the port's harness and of the JAX loop."""
    dataset = SphereCubeDataset(renders)
    test_set, train_set = random_split(dataset, [10, 12])
    jmodel = JaxLieVAE(**SMALL)
    variables = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64), models_test._unflatten(weights))
    tx = jstate.make_optimizer(lr=1e-3, clip_grads=1e-5)
    state = jstate.TrainState.create(params=variables["params"],
                                     batch_stats=variables["batch_stats"],
                                     tx=tx)

    @jax.jit
    def step(state, x, rng):
        x = x.astype(jnp.float64) / 255.0

        def loss_fn(params):
            (recon, kl_sum, _, stats), mut = jmodel.apply(
                {"params": params, "batch_stats": state.batch_stats},
                x, n=1, train=True, method="elbo", rngs={"sample": rng},
                mutable=["batch_stats"])
            return jnp.mean(recon) + jnp.mean(kl_sum), (
                mut["batch_stats"], jnp.mean(recon), jnp.mean(kl_sum),
                stats[0].inner.z / stats[0].inner.sigma)

        (_, (bs, recon, kl, eps)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        return state.apply_gradients(grads, new_batch_stats=bs), recon, kl, \
            eps

    @jax.jit
    def evaluate(params, batch_stats, x, rng):
        recon, kl_sum, _, stats = jmodel.apply(
            {"params": params, "batch_stats": batch_stats},
            x.astype(jnp.float64) / 255.0, n=1, train=False, method="elbo",
            rngs={"sample": rng})
        return jnp.mean(recon), jnp.mean(kl_sum), \
            stats[0].inner.z / stats[0].inner.sigma

    noise, train_metrics, test_metrics = [], [], []
    loader = JaxBatchLoader(train_set, 4, shuffle=True, drop_last=True,
                            seed=0)
    for i, batch in enumerate(loader):
        state, recon, kl, eps = step(state, jnp.asarray(batch[-1]),
                                     jax.random.PRNGKey(40 + i))
        train_metrics.append((float(recon), float(kl)))
        noise.append(np.asarray(eps))
    # eval mode treats rows independently: one row per call, one compile
    for i, batch in enumerate(JaxBatchLoader(test_set, 4, shuffle=False,
                                             drop_last=False)):
        rows = [evaluate(state.params, state.batch_stats,
                         jnp.asarray(batch[-1][r:r + 1]),
                         jax.random.PRNGKey(100 * i + r))
                for r in range(len(batch[-1]))]
        test_metrics.append(np.mean([(float(recon), float(kl))
                                     for recon, kl, _ in rows], 0))
        noise.append(np.concatenate([np.asarray(e) for _, _, e in rows],
                                    axis=1))
    assert [len(n[0]) for n in noise] == [4, 4, 4, 4, 4, 2]
    final = {f"{c}/{k}": np.asarray(v) for c, tree in
             (("params", state.params), ("batch_stats", state.batch_stats))
             for k, v in traverse_util.flatten_dict(tree, sep="/").items()}

    log_dir = str(tmp_path_factory.mktemp("logs"))
    model = _port_model(weights)
    experiment = UnsupervisedExperiment(
        model=model, train_dataset=train_set, test_dataset=test_set,
        beta_schedule=ConstantSchedule(1.0), lr=1e-3, clip_grads=1e-5,
        batch_size=4, log=log_dir, seed=0)
    experiment._eps = _Noise(noise, torch.float32)
    experiment.train(0)
    experiment.log.close()
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        logged = {r["tag"]: r for r in map(json.loads, f)}
    return (experiment, logged, np.mean(train_metrics, 0),
            np.mean(test_metrics, 0), state_dict_from_jax(final, model))


def test_epoch_reports_match_jax(epoch):
    experiment, logged, (train_recon, train_kl), (test_recon, test_kl), _ = \
        epoch
    assert not experiment._eps.arrays          # every array handed out
    assert {r["step"] for r in logged.values()} == {3}
    for split, recon, kl in (("train", train_recon, train_kl),
                             ("test", test_recon, test_kl)):
        loss = recon + kl
        assert logged[f"{split}_recon"]["value"] == pytest.approx(recon,
                                                                  rel=1e-5)
        assert logged[f"{split}_loss"]["value"] == pytest.approx(loss,
                                                                 rel=1e-5)
        assert abs(logged[f"{split}_kl"]["value"] - kl) <= 1e-5 * loss
    assert experiment.best_value == logged["test_recon"]["value"]
    assert logged["sigma_max"]["value"] > 0.0


def test_epoch_params_match_jax(epoch):
    experiment, _, _, _, want = epoch
    got = experiment.model.state_dict()
    assert experiment.optimizer.count == 3
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            assert int(got[name]) == 3
            continue
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("steps_per_call,device_data,report_its", [
    (1, False, [1, 2, 3]), (2, True, [2, 3])])
def test_steps_per_call_and_device_data(renders, weights, tmp_path,
                                        steps_per_call, device_data,
                                        report_its):
    """Grouped steps report at group boundaries, as the JAX harness's scan
    does; the steps and the batches (gathered from the cached dataset with
    ``device_data``) are the ungrouped host path's."""
    test_set, train_set = random_split(SphereCubeDataset(renders), [10, 12])
    runs = []
    for run, (K, cached) in enumerate(((1, False),
                                       (steps_per_call, device_data))):
        experiment = UnsupervisedExperiment(
            model=_port_model(weights), train_dataset=train_set,
            test_dataset=test_set, beta_schedule=ConstantSchedule(1.0),
            batch_size=4, report_freq=1, steps_per_call=K,
            device_data=cached, log=str(tmp_path / f"logs{run}"))
        experiment.train(0)
        experiment.log.close()
        runs.append(experiment)
    with open(tmp_path / "logs1" / "metrics.jsonl") as f:
        its = [r["step"] for r in map(json.loads, f)
               if r["tag"] == "train_recon"]
    assert its == report_its
    for a, b in zip(runs[0].model.state_dict().values(),
                    runs[1].model.state_dict().values()):
        assert torch.equal(a, b)


# ------------------------------------------------------ log-likelihood


def _weights_and_noise(module, x, n):
    """``LieVAE.log_weights`` of the JAX package, returning the noise it
    drew as well."""
    x_recon, stats = module(x, n=n, train=False)
    w = -module.recon_loss(x_recon, x) + sum(
        s.log_prior() for s in stats) - sum(s.log_posterior() for s in stats)
    return w, stats[0].inner.z / stats[0].inner.sigma


@pytest.fixture(scope="module")
def jax_log_weights(weights):
    jmodel = JaxLieVAE(**SMALL)
    variables = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64), models_test._unflatten(weights))

    @jax.jit
    def fn(x, key):
        w, eps = jmodel.apply(variables, x.astype(jnp.float64) / 255.0, 6,
                              rngs={"sample": key},
                              method=_weights_and_noise)
        w_ref = jmodel.apply(variables, x.astype(jnp.float64) / 255.0, n=6,
                             method="log_weights", rngs={"sample": key})
        ll = jmodel.apply(variables, x.astype(jnp.float64) / 255.0, n=6,
                          method="log_likelihood", rngs={"sample": key})
        return w, eps, w_ref, ll

    def per_row(x, seed):
        """log-weights (6, B), noise (6, B, 3), JAX's own log_weights and
        the rows' log_likelihood values, one row per call (rows are
        independent in eval mode; one compile)."""
        rows = [[np.asarray(a) for a in fn(jnp.asarray(x[r:r + 1]),
                                           jax.random.PRNGKey(seed + r))]
                for r in range(len(x))]
        return (np.concatenate([r[0] for r in rows], 1),
                np.concatenate([r[1] for r in rows], 1),
                np.concatenate([r[2] for r in rows], 1),
                np.asarray([float(r[3]) for r in rows]))

    return per_row


def test_log_weights_match_jax(renders, weights, jax_log_weights):
    x = SphereCubeDataset(renders).gather(np.arange(3))[-1]
    w, eps, w_ref, ll = jax_log_weights(x, 5)
    np.testing.assert_array_equal(w, w_ref)   # the noise is the model's
    model = _port_model(weights, torch.float64).eval()
    xt = torch.tensor(x, dtype=torch.float64) / 255.0
    with torch.no_grad():
        got = model.log_weights(xt, n=6, eps=torch.tensor(eps))
        got_ll = model.log_likelihood(xt, n=6, eps=torch.tensor(eps))
    np.testing.assert_allclose(got.numpy(), w, rtol=1e-6)
    assert float(got_ll) == pytest.approx(float(ll.mean()), rel=1e-6)


def test_harness_log_likelihood_per_item_matches_jax(renders, weights,
                                                     jax_log_weights):
    """Items in the loader's shuffled order, 3 at a time (7 items: a ragged
    tail of 1), 6 samples in 2 chunks of 3 merged in float64."""
    dataset = SphereCubeDataset(renders)
    items = random_split(dataset, [7, 15])[0]
    noise, want, mean_w = [], [], []
    for i, batch in enumerate(JaxBatchLoader(items, 3, shuffle=True,
                                             drop_last=False)):
        w, eps, _, _ = jax_log_weights(batch[-1], 100 * i)
        noise += [eps[:3], eps[3:]]
        want.append(np.logaddexp.reduce(w, axis=0) - math.log(6))
        mean_w.append(w.mean(0))
    experiment = UnsupervisedExperiment(
        model=_port_model(weights, torch.float64), train_dataset=items,
        test_dataset=items, beta_schedule=ConstantSchedule(1.0))
    experiment._eps = _Noise(noise, torch.float64)
    mean, got = experiment.log_likelihood(items, n=6, batch_size=3,
                                          n_chunk=3, return_items=True)
    assert not experiment._eps.arrays
    np.testing.assert_allclose(got, np.concatenate(want), rtol=1e-6)
    assert mean == pytest.approx(float(np.concatenate(want).mean()),
                                 rel=1e-6)
    np.testing.assert_allclose(experiment.last_ll["mean_log_weights"],
                               np.concatenate(mean_w), rtol=1e-6)
    assert (got >= experiment.last_ll["mean_log_weights"]).all()


# ------------------------------------------------------------ checkpoint


def test_checkpoint_round_trip(renders, weights, tmp_path):
    x = SphereCubeDataset(renders).gather(np.arange(4))[-1]
    model = _port_model(weights)
    opt = make_optimizer(model.named_parameters(), lr=1e-3)
    for i in range(2):
        train_step(model, opt, torch.tensor(x), 1.0,
                   eps=torch.full((1, 4, 3), 0.1 * i))
    path = str(tmp_path / "ckpt" / "checkpoint.pt")
    save_state(path, model, opt)
    fresh = _port_model(models_test._flat_jax_weights(JaxLieVAE(**SMALL)))
    fresh_opt = make_optimizer(fresh.named_parameters(), lr=1e-3)
    assert restore_state(path, fresh, fresh_opt) == 2
    for (name, a), b in zip(model.state_dict().items(),
                            fresh.state_dict().values()):
        assert torch.equal(a, b), name
    assert fresh_opt.count == 2
    for a, b in zip(opt.mu + opt.nu, fresh_opt.mu + fresh_opt.nu):
        assert torch.equal(a, b)
    resumed = UnsupervisedExperiment(
        model=_port_model(weights), train_dataset=[], test_dataset=[],
        beta_schedule=ConstantSchedule(1.0), init_state=load_checkpoint(path))
    assert resumed.optimizer.count == 2
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), resumed.model.state_dict().values()))
    sess = InferenceSession.from_checkpoint(
        path, LieVAE(device="cpu", kernel_impl="pallas", **SMALL),
        batch_size=4, device="cpu")
    poses = np.linalg.qr(np.random.default_rng(0).normal(
        size=(5, 3, 3)))[0].astype(np.float32)
    poses *= np.sign(np.linalg.det(poses))[:, None, None]
    model.eval()
    with torch.no_grad():
        want = model.decode(torch.tensor(poses)[None])[0].numpy()
    np.testing.assert_allclose(sess.decode(poses), want, rtol=0, atol=1e-6)


# ------------------------------------------------------------------- CLI

_TINY = ["--device", "cpu", "--degrees", "2", "--rep_copies", "2",
         "--conv_hidden", "4", "--deconv_hidden", "8"]


def test_cli_runs_end_to_end(tmp_path, monkeypatch, capsys):
    """One epoch over 110 renders (the CLI's batch is 64: one step), a
    checkpoint, a final LL, on the CPU."""
    data = str(tmp_path / "spherecube")
    gen_spherecube.main(["110", data, "--singles"])
    monkeypatch.chdir(tmp_path)
    experiment = cli_main.main(_TINY + [
        "--dataset", "spherecube", "--kernel_impl", "pallas",
        "--data_dir", data, "--epochs", "1",
        "--save_dir", "out", "--log_dir", "logs", "--ll_samples", "4",
        "--ll_max_items", "2", "--profile_dir", "trace",
        "--log_histograms"])
    out = capsys.readouterr().out
    assert "Dataset splits: train=66, valid=22, test=22" in out
    assert "Epoch 0 it 1 train recon" in out
    assert os.path.exists(tmp_path / "out" / cli_main.CHECKPOINT)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert experiment.optimizer.count == 1 + 4      # profile(): 1 + 3 steps
    items = experiment.last_ll["items"]
    assert len(items) == 2 and np.isfinite(items).all()
    assert f"LL: {items.mean():.2f}" in out
    assert (tmp_path / "ll.txt").read_text().startswith("None : ")


@pytest.mark.parametrize("args,world", [
    (["--mesh_data", "2"], 2), (["--mesh_model", "2"], 2),
    (["--mesh_data", "2", "--mesh_model", "2"], 4),
    (["--mesh_data", "3"], 3)])
def test_cli_mesh_needs_its_world_size(args, world, monkeypatch):
    """Without a launcher (or with another world size) the mesh flags raise
    and name the world size they need."""
    monkeypatch.setenv("WORLD_SIZE", "1" if world != 3 else "2")
    with pytest.raises(SystemExit, match=f"needs a world size of {world} "):
        cli_main.main(_TINY + args)


def test_cli_runs_on_the_card_unless_asked(monkeypatch):
    """--device defaults to cuda, and without a card the CLI stops rather
    than falling back to the CPU."""
    assert cli_main.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli_main.main(["--data_dir", "unused"])
