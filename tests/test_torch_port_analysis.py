"""The port's latent-space analysis held against the JAX package's.

Every ``analysis`` function on the same inputs, the models' weights carried
across by ``compat.state_dict_from_jax``; tolerances, stated per check:

- float64 on both sides where the function allows (the random walk from
  JAX's own normal draws, toy inputs, encodings and reconstruction errors
  of float64 models, the group-matrix charts, ``wigner_d_matrix``, PCA):
  1e-10, relative to the largest reference value where values exceed 1;
- float32 paths: 1e-5 relative to the largest value, for the circle
  trajectory (both packages build it in float32) and the conv model's
  encodings and errors (the JAX ``ConvEncoder`` and ``DeconvNet`` cast
  their outputs to float32 whatever the input's dtype, as
  ``test_torch_port_modes.py`` holds them);
- bytes and indices exact (the discontinuity outlier counts, the renders
  of ``render_encoded_poses``: both packages' native renderers).

Models: the toy encoder and decoder with the ``so3`` (S2xS2 mean),
``vmfq`` and 3-dim ``normal`` latents, and the conv model on images with
``so3``; batches of 3 over 7 items, so the last is ragged. Also: ``utils``;
the model's train/eval mode, ``deterministic`` flags and shell count ``k``
put back after ``encode_dataset``, ``reconstruction_error`` (an exception
inside too) and ``eval_checkpoint``'s loop over shell counts; tiny CPU
runs of ``cli.eval_checkpoint`` and ``cli.analyze_spherecube``.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_port_models as models_test
import test_torch_port_modes as modes_test
from lie_vae_tpu import analysis as janalysis
from lie_vae_tpu import ops as jops
from lie_vae_tpu import utils as jutils
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu_torch import analysis, ops, utils
from lie_vae_tpu_torch.cli import analyze_spherecube, eval_checkpoint
from lie_vae_tpu_torch.cli import gen_spherecube
from lie_vae_tpu_torch.cli import main as cli_main
from lie_vae_tpu_torch.compat import state_dict_from_jax
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.train import make_optimizer
from lie_vae_tpu_torch.train.checkpoint import save_state
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

F64 = 1e-10
F32 = 1e-5
N = 7           # items; batches of 3 leave a ragged last batch of 1


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max()), err


# ---------------------------------------------------------- trajectories

def test_circle_trajectory_matches_jax():
    start = np.asarray(jops.expmap(jnp.asarray([0.3, -0.2, 0.5])),
                       np.float32)
    for kw in ({}, {"axis": (0.3, 0.5, 0.81), "start": start}):
        want = janalysis.circle_trajectory(9, **kw)
        got = analysis.circle_trajectory(9, **kw)
        assert got.dtype == torch.float32 and got.shape == (9, 3, 3)
        _close(got, want, F32)


def test_random_walk_matches_jax_on_its_noise():
    key = jax.random.PRNGKey(7)
    want = janalysis.random_walk_trajectory(key, 12, step=0.08)
    eps = np.array(jax.random.normal(key, (12, 3)))
    assert eps.dtype == np.float64
    got = analysis.random_walk_trajectory(12, step=0.08, eps=eps)
    assert got.dtype == torch.float64
    _close(got, want, F64)
    start = np.asarray(jops.expmap(jnp.asarray([0.1, 0.2, 0.3])))
    _close(analysis.random_walk_trajectory(12, 0.08, start=start, eps=eps),
           janalysis.random_walk_trajectory(key, 12, 0.08, start=start),
           F64)
    walk = analysis.random_walk_trajectory(
        5, generator=torch.Generator().manual_seed(3))
    assert walk.dtype == torch.float32 and walk.shape == (5, 3, 3)
    with pytest.raises(ValueError, match="eps"):
        analysis.random_walk_trajectory(4, eps=eps)


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_toy_inputs_match_jax(impl):
    """On CPU tensors both impls take their kernels' plain versions."""
    traj = np.asarray(jops.random_group_matrices(jax.random.PRNGKey(1), 6,
                                                 dtype=jnp.float64))
    harmonics = np.random.default_rng(0).normal(size=(16, 3))
    want = janalysis.toy_inputs_for_trajectory(traj, harmonics, 3)
    got = analysis.toy_inputs_for_trajectory(traj, harmonics, 3, impl=impl)
    _close(got, want, F64)


# ---------------------------------------------------------------- models

CONFIGS = {
    "so3": dict(modes_test.TOY, mean_mode="s2s2"),
    "vmfq": dict(modes_test.TOY, latent_mode="vmfq"),
    "normal": dict(modes_test.TOY, latent_mode="normal", normal_dims=3),
    "conv_so3": dict(modes_test.CONV, mean_mode="s2s2"),
}
_CACHE = {}


def _pair(name):
    """(JAX model, float64 variables, port model in float64, inputs)."""
    if name not in _CACHE:
        cfg = CONFIGS[name]
        jmodel = JaxLieVAE(**cfg)
        flat = modes_test._flat_weights(jmodel)
        variables = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64),
            {k: v for k, v in models_test._unflatten(flat).items() if v})
        model = LieVAE(device="cpu", **cfg)
        model.load_state_dict(state_dict_from_jax(flat, model), strict=True)
        _CACHE[name] = (jmodel, variables, model.double(),
                        modes_test._inputs(cfg, seed=5, batch=N))
    return _CACHE[name]


def _tol(name):
    return F32 if name.startswith("conv") else F64


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_dataset_matches_jax(name):
    jmodel, variables, model, xs = _pair(name)
    want = janalysis.encode_dataset(jmodel, variables, xs, batch_size=3)
    got = analysis.encode_dataset(model, xs, batch_size=3)
    assert got.shape == want.shape == (N, model.group_dims)
    tol = _tol(name)
    _close(got, want, tol)
    jj, js = janalysis.discontinuity_score(want)
    tj, ts = analysis.discontinuity_score(got)
    _close(tj, jj, tol)
    assert ts["num_outliers"] == js["num_outliers"]
    _close([ts["mean"], ts["max"]], [js["mean"], js["max"]], tol)
    latent = model.latent_mode
    # the charts and PCA of the same encodings: float64 both sides
    _close(analysis.encodings_to_group_matrices(want, latent),
           janalysis.encodings_to_group_matrices(want, latent), F64)
    _close(analysis.pca(want)[0], janalysis.pca(want)[0], F64)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reconstruction_error_matches_jax(name):
    jmodel, variables, model, xs = _pair(name)
    want = janalysis.reconstruction_error(jmodel, variables, xs,
                                          batch_size=3)
    got = analysis.reconstruction_error(model, xs, batch_size=3)
    assert abs(got - want) <= _tol(name) * max(1.0, abs(want))


def test_charts_reject_what_has_no_rotation():
    e = np.random.default_rng(1).normal(size=(4, 4))
    with pytest.raises(ValueError, match="vmfq"):
        analysis.encodings_to_group_matrices(e, "vmf")
    with pytest.raises(ValueError, match="3-dim"):
        analysis.encodings_to_group_matrices(e, "normal")
    with pytest.raises(ValueError, match="unknown"):
        analysis.encodings_to_group_matrices(e, "torus")


def test_render_encoded_poses_matches_jax():
    mats = np.asarray(jops.random_group_matrices(jax.random.PRNGKey(4), 3,
                                                 dtype=jnp.float32))
    align = np.asarray(jops.expmap(jnp.asarray([0.4, 0.1, -0.3],
                                               jnp.float32)))
    for kw in ({}, {"align_to": align, "style": "v2", "size": 32}):
        np.testing.assert_array_equal(
            analysis.render_encoded_poses(mats, **kw),
            janalysis.render_encoded_poses(mats, **kw))


def test_pca_and_discontinuity_on_given_arrays():
    x = np.random.default_rng(2).normal(size=(40, 7))
    for got, want in zip(analysis.pca(x, 3), janalysis.pca(x, 3)):
        _close(got, want, F64)
    smooth = np.cumsum(np.full((50, 3), 0.01), axis=0)
    smooth[30:] += 5.0
    jumps, s = analysis.discontinuity_score(smooth)
    want_jumps, want_s = janalysis.discontinuity_score(smooth)
    np.testing.assert_array_equal(jumps, want_jumps)
    assert s == want_s and s["num_outliers"] == 1


@pytest.mark.parametrize("degree", range(7))
def test_wigner_d_matrix(degree):
    angles = np.random.default_rng(degree).uniform(-3, 3, (2, 4, 3))
    want = jops.wigner_d_matrix(jnp.asarray(angles), degree)
    got = ops.wigner_d_matrix(torch.tensor(angles), degree)
    assert got.shape == (2, 4, 2 * degree + 1, 2 * degree + 1)
    _close(got, want, F64)
    o, d = degree * degree, 2 * degree + 1
    block = ops.block_wigner_matrix(torch.tensor(angles), degree)
    _close(got, block[..., o:o + d, o:o + d], F64)


def test_utils_match_jax():
    x = np.random.default_rng(3).normal(size=(3, 4, 5)) * 30
    for kw in ({}, {"axis": 1}, {"axis": -1, "keepdims": True}):
        _close(utils.logsumexp(torch.tensor(x), **kw),
               jutils.logsumexp(jnp.asarray(x), **kw), F64)
    for n, axis in ((2, 0), (3, 1), (4, -1), (2, 3)):
        got = utils.expand_dim(torch.tensor(x), n, axis)
        want = jutils.expand_dim(jnp.asarray(x), n, axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    it = utils.cycle([1, 2, 3])
    assert [next(it) for _ in range(7)] == [1, 2, 3, 1, 2, 3, 1]


# ------------------------------------------------- the model put back


def _state(model):
    return ([m.training for m in model.modules()],
            [getattr(m, "deterministic", None) for m in model.modules()],
            [getattr(m, "k", None) for m in model.modules()],
            model.density_k)


def _toy_model():
    model = LieVAE(device="cpu", **dict(modes_test.TOY, density_k=4))
    model.decoder.eval()              # a mixed mode must come back mixed
    return model


def test_analysis_puts_the_model_back():
    model = _toy_model()
    before = _state(model)
    xs = modes_test._inputs(CONFIGS["so3"], batch=4)
    analysis.encode_dataset(model, xs)
    analysis.reconstruction_error(model, xs)
    assert _state(model) == before
    seen = []

    def failing_encode(*a, **k):
        seen.append(_state(model))
        raise RuntimeError("boom")

    model.encode = failing_encode
    with pytest.raises(RuntimeError, match="boom"):
        analysis.encode_dataset(model, xs)
    assert _state(model) == before
    # inside: eval mode, every flag set, the model's own k
    assert not any(seen[0][0])
    assert all(f for f in seen[0][1] if f is not None)


def test_eval_checkpoint_k_loop_puts_the_model_back():
    """Each count evaluated at its k on the same items and noise; the
    model's mode, flags and k restored afterwards."""
    from lie_vae_tpu_torch.data import ToyDataset
    from lie_vae_tpu_torch.train import (ConstantSchedule,
                                         UnsupervisedExperiment)
    data = ToyDataset.generate(n=12, degrees=2, rep_copies=3, seed=1,
                               device="cpu")
    model = _toy_model()
    exp = UnsupervisedExperiment(
        model=model, train_dataset=data, test_dataset=data,
        beta_schedule=ConstantSchedule(1.0), batch_size=4)
    before = _state(model)
    seen, noise = [], []
    log_weights = model.log_weights

    def spy(*a, **k):
        seen.append(model.reparameterize[0].k)
        noise.append(k["eps"].clone())
        return log_weights(*a, **k)

    model.log_weights = spy
    out = eval_checkpoint.log_likelihoods(exp, data, density_k=(0, 4, 9),
                                          ll_n=6, max_items=3)
    del model.log_weights
    assert _state(model) == before
    assert seen == [0] * 3 + [4] * 3 + [9] * 3
    for i in range(3):                # every count draws the same noise
        assert torch.equal(noise[i], noise[3 + i])
        assert torch.equal(noise[i], noise[6 + i])
    for k in (0, 4, 9):
        r = out[k]
        assert len(r["items"]) == 3 and np.isfinite(r["ll"])
        assert all(i >= m for i, m in zip(r["items"],
                                          r["mean_log_weights"]))


# ------------------------------------------------------------ the CLIs

_TINY = ["--device", "cpu", "--degrees", "2", "--rep_copies", "2",
         "--conv_hidden", "4", "--deconv_hidden", "8"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """30 renders and a checkpoint.pt of a tiny seeded flagship-shaped
    model, as cli.main saves one."""
    root = tmp_path_factory.mktemp("eval")
    data = str(root / "spherecube")
    gen_spherecube.main(["30", data, "--singles"])
    args = cli_main.parse_args(_TINY + ["--dataset", "spherecube"])
    torch.manual_seed(0)
    model = cli_main.build_model(args, type("D", (), {"rgb": True}), None)
    save_state(str(root / "out" / cli_main.CHECKPOINT), model,
               make_optimizer(model.named_parameters()))
    return data, str(root / "out"), model


def test_cli_eval_checkpoint(checkpoint, capsys):
    data, out_dir, model = checkpoint
    res = eval_checkpoint.main(_TINY + [
        "--dataset", "spherecube", "--data_dir", data, "--save_dir",
        out_dir, "--density_k", "10", "30", "--ll_n", "5", "--max_items",
        "2"])
    printed = capsys.readouterr().out
    assert "IW-LL (n=5, density_k=30)" in printed
    assert res["step"] == 0 and set(res["ll"]) == {10, 30}
    assert set(res["sigma"]) == {"mean", "median", "max", "items"}
    assert res["sigma"]["items"] == 6          # the test split of 30
    for r in res["ll"].values():
        assert np.isfinite(r["ll"]) and len(r["items"]) == 2
        assert all(i >= m for i, m in zip(r["items"],
                                          r["mean_log_weights"]))


def test_cli_analyze_spherecube(checkpoint, tmp_path):
    data, out_dir, model = checkpoint
    out = str(tmp_path / "analysis")
    results, arrays, served = analyze_spherecube.main(_TINY + [
        "--checkpoint", os.path.join(out_dir, cli_main.CHECKPOINT),
        "--n_traj", "12", "--out_dir", out])
    with open(os.path.join(out, "spherecube_results.json")) as f:
        saved = json.load(f)
    assert saved["checkpoint_step"] == 0 and saved["n_traj"] == 12
    assert len(saved["pca_circle"]) == 12
    for name in ("encoded_poses.png", "recon.png", "SPHERECUBE_ANALYSIS.md"):
        assert os.path.getsize(os.path.join(out, name)) > 0
    from lie_vae_tpu_torch.data.png import read_png
    assert read_png(os.path.join(out, "recon.png")).shape == (128, 640, 3)
    # the circle's encodings are encode_dataset's of its renders
    from lie_vae_tpu_torch.data import render_spherecube
    circle = analysis.circle_trajectory(12, axis=(0.3, 0.5, 0.81))
    want = analysis.encode_dataset(model, render_spherecube(circle.numpy()))
    np.testing.assert_array_equal(arrays["encodings_circle"], want)
    _, summary = analysis.discontinuity_score(want)
    assert saved["discontinuity_circle"] == summary
    assert all(m.training for m in served.modules())
