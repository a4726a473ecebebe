"""The port's toy experiment and the CLI's other modes, against the JAX
package's on the CPU at a small size.

- ``ToyDataset.from_poses`` from the JAX package's quaternions and spectrum
  gives the JAX ``ToyDataset.generate``'s x (float32, 1e-5 of the largest
  value: the same chain summed in another order); ``generate`` itself:
  Frobenius norm 10 spectrum, unit quaternions, each item's norm kept by
  the rotation, and the same set from the same seed;
- an ``.npz`` written by either package loads in the other;
- ``cli.toy_generate`` writes the file ``cli.main`` then reads;
- the harness draws the latent's own noise: (n, B, normal_dims) for
  ``normal``, none when ``deterministic``;
- ``InferenceSession`` for a ``normal``/``action`` toy model against the
  JAX package's session on the same weights: decode, reconstruct, the
  posterior means and scales, and the straight-line geodesic (1e-5);
  ``sample`` decodes N(0, I) poses;
- ``cli.main.main --device cpu`` at its defaults but tiny (toy dataset
  generated when missing, one epoch, checkpoint, IW-LL no lower than the
  mean log-weight of each item), with ``--config normal``, with
  ``--compute_dtype bfloat16`` and with ``--fixed_spectrum``; a toy file
  of another spectrum shape is refused.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from lie_vae_tpu import serve as jserve
from lie_vae_tpu.data import ToyDataset as JaxToyDataset
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu_torch.cli import main as cli_main
from lie_vae_tpu_torch.cli import toy_generate
from lie_vae_tpu_torch.compat import state_dict_from_jax
from lie_vae_tpu_torch.data import ToyDataset
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.serve import InferenceSession
from lie_vae_tpu_torch.train import ConstantSchedule, UnsupervisedExperiment

import test_torch_port_modes as modes_test
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)


@pytest.fixture(scope="module")
def jax_toy():
    return JaxToyDataset.generate(n=12, degrees=2, rep_copies=3, seed=1,
                                  batch_size=6)


def test_from_poses_matches_jax_generate(jax_toy):
    got = ToyDataset.from_poses(jax_toy.quaternions, jax_toy.harmonics, 2,
                                batch_size=5, device="cpu")
    np.testing.assert_array_equal(got.quaternions, jax_toy.quaternions)
    np.testing.assert_array_equal(got.harmonics, jax_toy.harmonics)
    assert got.x.shape == jax_toy.x.shape == (12, 9, 3)
    np.testing.assert_allclose(got.x, jax_toy.x, rtol=0,
                               atol=1e-5 * np.abs(jax_toy.x).max())


def test_generate_is_seeded_haar_and_norm_preserving():
    a = ToyDataset.generate(n=20, degrees=2, rep_copies=3, seed=4,
                            batch_size=7, device="cpu")
    b = ToyDataset.generate(n=20, degrees=2, rep_copies=3, seed=4,
                            device="cpu")
    np.testing.assert_allclose(a.x, b.x, rtol=0, atol=1e-6)
    assert a.x.dtype == a.harmonics.dtype == np.float32
    assert np.linalg.norm(a.harmonics) == pytest.approx(10.0, rel=1e-6)
    np.testing.assert_allclose(np.linalg.norm(a.quaternions, axis=1), 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(a.x, axis=(1, 2)), 10.0,
                               rtol=1e-5)
    q, h, x = a.gather([3, 0])
    assert q.shape == (2, 4) and h.shape == (2, 9, 3) and x.shape == (2, 9, 3)
    np.testing.assert_array_equal(x, a.x[[3, 0]])
    assert ToyDataset.prep_batch((q, h, x)) == (q, h, x)


def test_generate_on_the_card_needs_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ToyDataset.generate(n=2, degrees=1, rep_copies=1)


def test_npz_loads_in_both_packages(jax_toy, tmp_path):
    jax_path, port_path = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jax_toy.save(jax_path)
    ours = ToyDataset(path=jax_path)
    for a, b in ((ours.quaternions, jax_toy.quaternions),
                 (ours.harmonics, jax_toy.harmonics), (ours.x, jax_toy.x)):
        np.testing.assert_array_equal(a, b)
    ToyDataset.generate(n=5, degrees=1, rep_copies=2,
                        device="cpu").save(port_path)
    theirs = JaxToyDataset(path=port_path)
    ours = ToyDataset(path=port_path)
    assert len(theirs) == len(ours) == 5
    for i in range(3):
        np.testing.assert_array_equal(theirs[2][i], ours[2][i])


def test_toy_generate_cli(tmp_path, capsys):
    path = str(tmp_path / "toy" / "t.npz")
    toy_generate.main(["7", "1", "2", "--path", path, "--seed", "3",
                       "--device", "cpu"])
    assert "Dataset generated" in capsys.readouterr().out
    data = ToyDataset(path=path)
    assert data.x.shape == (7, 4, 2) and data.harmonics.shape == (4, 2)
    ref = ToyDataset.generate(n=7, degrees=1, rep_copies=2, seed=3,
                              device="cpu")
    np.testing.assert_array_equal(data.x, ref.x)


# -------------------------------------------------------------- harness


class _Model(torch.nn.Module):
    def __init__(self, noise_dims):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))
        self.noise_dims = noise_dims


@pytest.mark.parametrize("dims", [5, None])
def test_harness_draws_the_latents_noise(dims):
    exp = UnsupervisedExperiment(model=_Model(dims), train_dataset=[],
                                 test_dataset=[],
                                 beta_schedule=ConstantSchedule(1.0))
    eps = exp._eps("train", 2, 4)
    assert (eps is None) if dims is None else eps.shape == (2, 4, dims)


# -------------------------------------------------------------- serving

NORMAL = dict(modes_test.CONFIGS["normal_action"])


@pytest.fixture(scope="module")
def sessions():
    jmodel = JaxLieVAE(**NORMAL)
    flat = modes_test._flat_weights(jmodel, seed=2)
    params = traverse_util.unflatten_dict(
        {k[len("params/"):]: jnp.asarray(v) for k, v in flat.items()},
        sep="/")
    jsess = jserve.InferenceSession(jmodel, params, {}, batch_size=4)
    model = LieVAE(device="cpu", **NORMAL)
    sess = InferenceSession(model, state_dict_from_jax(flat, model),
                            batch_size=4, device="cpu")
    x = np.random.default_rng(6).random((6, 9, 3), dtype=np.float32)
    return jsess, sess, x


def test_normal_session_matches_jax(sessions):
    jsess, sess, x = sessions
    want, got = jsess.encode(x), sess.encode(x)
    assert got["pose"].shape == got["sigma"].shape == got["sample"].shape \
        == (6, 3)
    for k in ("pose", "sigma"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    poses = np.random.default_rng(7).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(sess.decode(poses), jsess.decode(poses),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(sess.reconstruct(x), jsess.reconstruct(x),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        sess.geodesic(poses[0], poses[1], steps=5, decode=False),
        jsess.geodesic(poses[0], poses[1], steps=5, decode=False),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        sess.geodesic(poses[0], poses[1], steps=5),
        jsess.geodesic(poses[0], poses[1], steps=5), rtol=0, atol=1e-5)


def test_normal_session_samples_the_gaussian_prior(sessions):
    _, sess, _ = sessions
    out = sess.sample(5, seed=3)
    z = torch.randn((5, 3), generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(out, sess.decode(z.numpy()))
    assert out.shape == (5, 9, 3)
    eps = np.random.default_rng(8).normal(size=(6, 3)).astype(np.float32)
    enc = sess.encode(sessions[2], eps=eps)
    np.testing.assert_allclose(enc["sample"],
                               enc["pose"] + eps * enc["sigma"], atol=1e-6)


# ------------------------------------------------------------------ CLI

_TOY = ["--device", "cpu", "--degrees", "2", "--rep_copies", "2",
        "--epochs", "1", "--ll_samples", "4", "--ll_max_items", "3",
        "--save_dir", "out", "--log_dir", "logs"]


def _run_cli(tmp_path, monkeypatch, args):
    monkeypatch.chdir(tmp_path)
    experiment = cli_main.main(_TOY + args)
    ll = experiment.last_ll
    assert len(ll["items"]) == 3 and np.isfinite(ll["items"]).all()
    assert (ll["items"] >= ll["mean_log_weights"]).all()
    assert os.path.exists(tmp_path / "out" / cli_main.CHECKPOINT)
    return experiment


@pytest.mark.parametrize("args", [[], ["--config", "normal"],
                                  ["--compute_dtype", "bfloat16"]],
                         ids=["defaults", "normal", "bfloat16"])
def test_cli_toy_runs_end_to_end(tmp_path, monkeypatch, capsys, args):
    """The JAX CLI's default dataset: 1000 items generated into
    data/toy.npz, split 200/200/600 (9 steps of 64), one epoch, the
    IW-LL."""
    experiment = _run_cli(tmp_path, monkeypatch, args)
    out = capsys.readouterr().out
    assert "Generating toy dataset at data/toy.npz" in out
    assert "Dataset splits: train=600, valid=200, test=200" in out
    assert "Epoch 0 it 9 train recon" in out
    model = experiment.model
    assert model.encode_mode == model.deconv_mode == "toy"
    assert model.out_shape == (9, 2)
    if args == ["--config", "normal"]:
        assert (model.latent_mode, model.decoder_mode) == ("normal", "mlp")
    if args == ["--compute_dtype", "bfloat16"]:
        assert model.encoder[1][0].compute_dtype == torch.bfloat16


def test_cli_fixed_spectrum_and_shape_check(tmp_path, monkeypatch):
    ToyDataset.generate(n=120, degrees=2, rep_copies=2, seed=5,
                        device="cpu").save(str(tmp_path / "data" / "toy.npz"))
    experiment = _run_cli(tmp_path, monkeypatch, ["--fixed_spectrum"])
    item_rep = experiment.model.decoder.item_rep
    assert "decoder.item_rep" not in dict(
        experiment.model.named_parameters())
    np.testing.assert_array_equal(
        item_rep.numpy(), ToyDataset(path="data/toy.npz").harmonics)
    with pytest.raises(ValueError, match="spectrum shape"):
        cli_main.main(_TOY[:2] + ["--degrees", "3"])
