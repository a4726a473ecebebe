"""The port's toy drivers (``cli.analyze_toy``, ``cli.run_degree_sweep``,
``cli._results_table``) held against the JAX package's scripts.

- ``analyze_toy.evaluate_config``, the evaluation half, on a model with
  the JAX model's weights (float64 on both sides), against
  ``lie_vae_tpu.analysis`` applied as ``scripts/analyze_toy.py:66-148``
  applies it: the discontinuity summaries along the circle and the random
  walk (JAX's own normal draws for PRNGKey(7), handed to the port), the
  PCA projections and the pose-error statistics, at 1e-5 relative to the
  largest value (as ``test_torch_port_analysis.py`` holds the toy
  models), the outlier counts exact; four configs of the matrix;
- ``merge_marker_table`` writes the same bytes as the JAX package's
  ``scripts/_results_table.py`` on the same rows, into a new file, over a
  table it wrote before (rows of other configs kept) and into a document
  without the markers;
- ``run_degree_sweep --degrees 2 3`` for one epoch on the CPU: its table
  parses, one row per degree, and ``results.json`` holds both; and
  ``analyze_toy`` end to end on two configs; the default output
  directories are the git-ignored ``outputs/``.
"""
import argparse
import importlib.util
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import test_torch_port_models as models_test
import test_torch_port_modes as modes_test
from lie_vae_tpu import analysis as janalysis
from lie_vae_tpu import ops as jops
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu_torch.cli import _results_table, analyze_toy
from lie_vae_tpu_torch.cli import run_degree_sweep
from lie_vae_tpu_torch.compat import state_dict_from_jax
from lie_vae_tpu_torch.data import ToyDataset
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
ARGS = argparse.Namespace(degrees=2, rep_copies=3, fixed_spectrum=True,
                          kernel_impl="fused", device="cpu")


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (what, err)


@pytest.fixture(scope="module")
def toy():
    ds = ToyDataset.generate(n=96, degrees=2, rep_copies=3, device="cpu")
    return ds, analyze_toy.toy_split(ds, 96)[1]


def _jax_evaluation(jmodel, variables, cfg, ds, valid):
    """scripts/analyze_toy.py:66-148 after training, figures left out."""
    results, arrays = {}, {}
    for traj_name, traj in [
            ("circle", janalysis.circle_trajectory(analyze_toy.N_TRAJ)),
            ("random_walk", janalysis.random_walk_trajectory(
                jax.random.PRNGKey(7), analyze_toy.N_TRAJ, step=0.08))]:
        xs = janalysis.toy_inputs_for_trajectory(traj, ds.harmonics, 2)
        enc = janalysis.encode_dataset(jmodel, variables, np.asarray(xs))
        _, results[f"discontinuity_{traj_name}"] = \
            janalysis.discontinuity_score(enc)
        arrays[f"{traj_name}_pca"] = janalysis.pca(enc)[0]
    if analyze_toy.rotation_latent(cfg):
        q, _, x = valid.gather(np.arange(min(len(valid), 512)))
        enc = janalysis.encode_dataset(jmodel, variables, np.asarray(x))
        r_hat = np.asarray(janalysis.encodings_to_group_matrices(
            enc, cfg["latent_mode"]))
        r_true = np.asarray(jops.quaternions_to_group_matrix(
            jnp.asarray(q)))
        rel_tr = np.einsum("bij,bij->b", r_hat, r_true)
        ang = np.degrees(np.arccos(np.clip((rel_tr - 1.0) / 2.0, -1.0,
                                           1.0)))
        results["pose_err_deg"] = {
            "median": float(np.median(ang)), "mean": float(np.mean(ang)),
            "frac_within_10deg": float(np.mean(ang <= 10.0)),
            "frac_near_flip": float(np.mean(ang >= 170.0))}
    return results, arrays


@pytest.mark.parametrize("name", ["ae-action-s2s2", "vae-action-s2s2",
                                  "ae-action-q", "ae-mlp-normal3"])
def test_evaluation_half_matches_jax_analysis(toy, name):
    ds, valid = toy
    cfg = analyze_toy.CONFIGS[name]
    kw = dict(encode_mode="toy", deconv_mode="toy", degrees=2, rep_copies=3,
              fixed_item_rep=ds.harmonics, **cfg)
    jmodel = JaxLieVAE(**kw)
    flat = modes_test._flat_weights(jmodel, seed=3)
    variables = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64),
        {k: v for k, v in models_test._unflatten(flat).items() if v})
    model = analyze_toy.toy_model(cfg, ds, ARGS)
    model.load_state_dict(state_dict_from_jax(flat, model), strict=True)
    model.double()
    eps = np.array(jax.random.normal(jax.random.PRNGKey(7),
                                     (analyze_toy.N_TRAJ, 3)))
    got, got_arrays = analyze_toy.evaluate_config(cfg, model, ds, valid,
                                                  ARGS, eps=eps)
    want, want_arrays = _jax_evaluation(jmodel, variables, cfg, ds, valid)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if "num_outliers" in w:
            assert g["num_outliers"] == w["num_outliers"], key
        _close([g[k] for k in sorted(w) if k != "num_outliers"],
               [w[k] for k in sorted(w) if k != "num_outliers"], key)
    for key, w in want_arrays.items():
        _close(got_arrays[key], w, key)
    if analyze_toy.rotation_latent(cfg):
        strip = got_arrays["encoded_poses"]
        assert strip.shape == (12, 64, 64, 3) and np.isfinite(strip).all()


# ------------------------------------------------------------ the table

def _jax_results_table():
    spec = importlib.util.spec_from_file_location(
        "_jax_results_table", os.path.join(ROOT, "scripts",
                                           "_results_table.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table_args(results):
    return dict(
        begin="<!-- t:begin -->", end="<!-- t:end -->", caption="Caption.",
        header="| config | a | b |",
        descriptions={"x": "row x", "y": "row y", "z": "row z"},
        results=results,
        format_row=lambda desc, r: f"| {desc} | {r[0]:.3f} | {r[1]} |",
        section_title="Section")


@pytest.mark.parametrize("start", ["", "# Doc\n\ntext\n",
                                   "written by the first call"])
def test_merge_marker_table_writes_the_jax_scripts_bytes(tmp_path, start):
    jax_table = _jax_results_table()
    first = {"x": (1.0, "a"), "y": (2.5, "b")}
    second = {"z": (3.25, "c"), "x": (0.5, "d")}
    outs = []
    for merge, name in ((jax_table.merge_marker_table, "jax.md"),
                        (_results_table.merge_marker_table, "port.md")):
        path = tmp_path / name
        if start == "written by the first call":
            merge(str(path), **_table_args(first))
        elif start:
            path.write_text(start)
        merge(str(path), **_table_args(second))
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]
    if start == "written by the first call":
        assert b"| row y | 2.500 | b |" in outs[1]     # kept from before


# --------------------------------------------------------- end to end

def test_degree_sweep_runs_and_its_table_parses(tmp_path, capsys):
    out_dir = str(tmp_path / "sweep")
    res = run_degree_sweep.main(["--degrees", "2", "3", "--epochs", "1",
                                 "--n_data", "256", "--device", "cpu",
                                 "--out_dir", out_dir])
    assert set(res) == {("ae-action-s2s2", 2), ("ae-action-s2s2", 3)}
    with open(os.path.join(out_dir, "results.json")) as f:
        assert set(json.load(f)) == {"ae-action-s2s2-L2",
                                     "ae-action-s2s2-L3"}
    text = open(os.path.join(out_dir, "TOY_RESULTS.md")).read()
    table = text.split(run_degree_sweep.BEGIN)[1].split(
        run_degree_sweep.END)[0]
    rows = [r for r in table.splitlines() if r.startswith("| L=")]
    assert [r.split("|")[1].strip() for r in rows] == ["L=2 (9)",
                                                      "L=3 (16)"]
    for r in rows:
        cells = [c.strip() for c in r.strip("|").split("|")]
        assert len(cells) == 6 and np.isfinite(float(cells[1]))
        assert cells[2].endswith("%") and float(cells[5]) >= 0


def test_analyze_toy_end_to_end(tmp_path):
    out_dir = str(tmp_path / "toy")
    res = analyze_toy.main(["--configs", "ae-action-s2s2", "vae-mlp-vmf",
                            "--epochs", "1", "--n_data", "128",
                            "--device", "cpu", "--out_dir", out_dir])
    assert list(res) == ["ae-action-s2s2", "vae-mlp-vmf"]
    assert "pose_err_deg" in res["ae-action-s2s2"]
    assert "pose_err_deg" not in res["vae-mlp-vmf"]
    with np.load(os.path.join(out_dir, "arrays.npz")) as z:
        assert z["ae-action-s2s2/circle_pca"].shape == (200, 2)
        assert z["ae-action-s2s2/encoded_poses"].shape == (12, 64, 64, 3)
        assert "vae-mlp-vmf/encoded_poses" not in z.files
    md = open(os.path.join(out_dir, "TOY_RESULTS.md")).read()
    assert "| ae-action-s2s2 |" in md and "| vae-mlp-vmf |" in md


def test_default_outputs_are_git_ignored():
    ignored = open(os.path.join(ROOT, ".gitignore")).read().splitlines()
    assert "/outputs/" in ignored
    assert analyze_toy.parse_args([]).out_dir.startswith("outputs" + os.sep)
    args = run_degree_sweep.parse_args([])
    assert args.out == os.path.join("outputs", "degree-sweep",
                                    "TOY_RESULTS.md")
    assert args.degrees == [2, 4, 6, 8, 10] and args.epochs == 600
