"""The experiment CLI over a process mesh on the CPU, the way a user runs
it: ``python -m torch.distributed.run --standalone --nproc_per_node N -m
lie_vae_tpu_torch.cli.main --mesh_data D --mesh_model M``, held against
the single-process CLI with the same flags.

Two launches over gloo, each rank with one thread, under a hard time limit
(the launch's ``timeout=``; the whole process group is killed past it):

- 4 ranks, ``--mesh_data 2 --mesh_model 2``: a small flagship-shaped conv
  model with BatchNorm (L = 3, 3 copies, conv width 4, deconv width 8, RGB;
  its big conv split over ``model``) on 320 sphere-cube renders (the numpy
  ray-caster): one epoch of 3 steps at the CLI's batch of 64, from weights
  that ``--torch_checkpoint`` hands in (loaded after the split), the
  epoch's report and its ``test()``, the checkpoint that rank 0 writes
  (split tensors gathered) and the IW-LL of 2 items in ``ll.txt``;
- 2 ranks, ``--mesh_data 2``: the toy experiment (the CLI's default
  dataset), whose missing toy set rank 0 generates while the other rank
  waits, one epoch of 9 steps.

The same CLI runs here in one process, with one thread as a rank has, in
float32 and, as the exact run, in float64 (torch's default dtype float64
around the call: the weights come from the same file and the harness draws
its noise in float32 whatever the default). Each tensor of the mesh's
checkpoint (model, Adam's mu and nu) is held against the exact run's within
1e-5 of its scale plus twice the single-process float32 run's own distance
from the exact run (the allowance ``chip_smoke.py`` calls C3: Adam divides
gradients of order 1e-10, after the clip to 1e-5, by their own root mean
square, and a bias before BatchNorm has a gradient of rounding alone). A
parameter's or statistic's scale is its exact tensor's largest magnitude;
a moment's is the largest magnitude of that moment over all parameters.
The IW-LL in ``ll.txt`` is held the same way. Only rank 0 prints the epoch
line and writes ``ll.txt``.
"""
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from lie_vae_tpu_torch.cli import gen_spherecube
from lie_vae_tpu_torch.cli import main as cli_main
from lie_vae_tpu_torch.compat import save_torch
from lie_vae_tpu_torch.data import ToyDataset
from lie_vae_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_S = 120
TOL, ARBITER = 1e-5, 2.0
COMMON = ["--device", "cpu", "--epochs", "1", "--ll_samples", "4",
          "--ll_max_items", "2"]
RUNS = {
    "conv": dict(ranks=4, mesh=["--mesh_data", "2", "--mesh_model", "2"],
                 rgb=True, steps=3,
                 flags=["--dataset", "spherecube", "--degrees", "3",
                        "--rep_copies", "3", "--conv_hidden", "4",
                        "--deconv_hidden", "8"]),
    "toy": dict(ranks=2, mesh=["--mesh_data", "2"], rgb=False, steps=9,
                flags=["--degrees", "2", "--rep_copies", "3"]),
}


def _launch(n, argv, cwd):
    """``n`` ranks of the CLI under torch.distributed.run, in a process
    group of their own."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    log = open(os.path.join(cwd, "log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), "-m", "lie_vae_tpu_torch.cli.main",
         *argv], cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)
    return proc, log


def _stop(proc):
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _single(argv, cwd, dtype):
    """The CLI in this process, one thread, with torch's default dtype
    ``dtype``; ``ll.txt`` lands in ``cwd``."""
    here, threads = os.getcwd(), torch.get_num_threads()
    os.makedirs(cwd)
    os.chdir(cwd)
    torch.set_num_threads(1)
    torch.set_default_dtype(dtype)
    try:
        cli_main.main(argv)
    finally:
        torch.set_default_dtype(torch.float32)
        torch.set_num_threads(threads)
        os.chdir(here)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    data = str(root / "sc" / "spherecube")
    gen_spherecube.generate(320, data, backend="numpy")
    argv = {}
    for name, run in RUNS.items():
        flags = run["flags"] + COMMON
        if name == "conv":
            flags += ["--data_dir", data]
        model = cli_main.build_model(cli_main.parse_args(flags),
                                     types.SimpleNamespace(rgb=run["rgb"]),
                                     None)
        init = str(root / f"{name}_init.pt")
        save_torch(init, model.state_dict())
        argv[name] = flags + ["--torch_checkpoint", init]
    launches = {}
    try:
        for name, run in RUNS.items():
            cwd = root / f"{name}_mesh"
            cwd.mkdir()
            launches[name] = _launch(
                run["ranks"], argv[name] + run["mesh"] + [
                    "--save_dir", str(cwd / "out"),
                    "--toy_path", str(cwd / "toy.npz")], str(cwd))
        for name in RUNS:
            for tag, dtype in (("f32", torch.float32),
                               ("f64", torch.float64)):
                # the float64 run reads the float32 run's toy set
                _single(argv[name] + [
                    "--save_dir", str(root / f"{name}_{tag}" / "out"),
                    "--toy_path", str(root / f"{name}_f32" / "toy.npz")],
                    str(root / f"{name}_{tag}"), dtype)
        for name, (proc, log) in launches.items():
            try:
                rc = proc.wait(timeout=LAUNCH_S)
            except subprocess.TimeoutExpired:
                _stop(proc)
                rc = "a timeout"
            if rc != 0:
                with open(root / f"{name}_mesh" / "log") as f:
                    pytest.fail(f"the {name} launch ended with {rc}:\n"
                                f"{f.read()[-4000:]}")
    finally:                     # no launch outlives the module's fixture
        for proc, log in launches.values():
            _stop(proc)
            log.close()
    return root


def _moments(ckpt):
    """A checkpoint's tensors by kind: ``model``, ``mu``, ``nu``."""
    names = [k for k in ckpt["model"]
             if not k.endswith("num_batches_tracked")]
    opt = ckpt["optimizer"]
    return {"model": {k: ckpt["model"][k].double() for k in names},
            "mu": dict(enumerate(t.double() for t in opt["mu"])),
            "nu": dict(enumerate(t.double() for t in opt["nu"]))}


def _read(root, name, tag):
    out = "mesh" if tag == "mesh" else tag
    return load_checkpoint(str(root / f"{name}_{out}" / "out" /
                               cli_main.CHECKPOINT))


@pytest.mark.parametrize("kind", ["model", "mu", "nu"])
@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_checkpoint_matches_the_single_process_cli(runs, name, kind):
    got, f32, exact = (_moments(_read(runs, name, tag))[kind]
                       for tag in ("mesh", "f32", "f64"))
    assert got.keys() == exact.keys() and len(got) > 0
    top = max(t.abs().max().item() for t in exact.values())
    for k, want in exact.items():
        scale = want.abs().max().item() if kind == "model" else top
        own = (f32[k] - want).abs().max().item()
        err = (got[k] - want).abs().max().item()
        assert err <= TOL * scale + ARBITER * own, (kind, k, err, own, scale)


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_checkpoint_is_the_single_process_format(runs, name):
    """Rank 0 wrote full tensors after every step of the epoch: the same
    keys, shapes and dtypes, step and Adam count as one process's."""
    got, want = _read(runs, name, "mesh"), _read(runs, name, "f32")
    assert got["step"] == want["step"] == RUNS[name]["steps"]
    assert got["optimizer"]["count"] == want["optimizer"]["count"]
    assert {k: (v.shape, v.dtype) for k, v in got["model"].items()} == {
        k: (v.shape, v.dtype) for k, v in want["model"].items()}
    for k, v in got["model"].items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(want["model"][k]) == RUNS[name]["steps"]


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_iwll_and_only_rank_0_writes(runs, name):
    def ll(tag):
        with open(runs / f"{name}_{tag}" / "ll.txt") as f:
            lines = f.read().splitlines()
        assert len(lines) == 1, lines
        return float(lines[0].split(":")[1])

    got, f32, exact = ll("mesh"), ll("f32"), ll("f64")
    assert abs(got - exact) <= TOL * abs(exact) + ARBITER * abs(f32 - exact)
    with open(runs / f"{name}_mesh" / "log") as f:
        log = f.read()
    steps = RUNS[name]["steps"]
    assert log.count(f"Epoch 0 it {steps} train recon") == 1
    assert log.count("LL: ") == 1
    assert log.count("backend gloo on cpu") == RUNS[name]["ranks"]


def test_rank_0_generates_the_toy_set_once(runs):
    """The toy set the mesh's rank 0 generated is the one a single process
    generates (the same seeded draws)."""
    got = ToyDataset(path=str(runs / "toy_mesh" / "toy.npz"))
    want = ToyDataset(path=str(runs / "toy_f32" / "toy.npz"))
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.quaternions, want.quaternions)
    assert not (runs / "conv_mesh" / "toy.npz").exists()
