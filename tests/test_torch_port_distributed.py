"""The port's data- and model-parallel training over CPU processes, held
against the JAX package's float64 single-device step and the port's own
single-process step.

Two launches of ``python -m torch.distributed.run --standalone`` run
``lie_vae_tpu_torch.parallel.run_steps`` over gloo, each rank with one
thread, reading its inputs from an ``.npz`` this module writes, under a
hard time limit (the launch's ``timeout=``, the collectives' 60 s):

- 4 ranks, the mesh 2 x 2 (data x model): a small flagship-shaped conv
  model with BatchNorm (L = 3, 3 copies, conv width 4, deconv width 8, RGB;
  the big convs split over ``model``), three steps at a global batch of 32
  with 'fused' and with 'pallas', in float64; then ``test()`` on a ragged
  evaluation set of 70 at batch 32 (32, 32, 6: the tail padded to the data
  size and masked), the IW-LL at batch 1 on 3 items, and a checkpoint that
  rank 0 writes;
- 2 ranks, the mesh 2 x 1: the toy model of
  ``tests/test_parallel.py:64-92`` (so3, s2s2, L = 2, 3 copies, learned
  spectrum) for an epoch of 128 items at batch 64, in float32, with its
  ``test()``; and the same with the ``vmfq`` latent and ``device_data``
  (every rank holds the set and gathers its rows of each index batch). The
  toy models' noise is the harness's own streams', so their launch runs
  beside the JAX references.

The JAX references draw the noise (the train steps', every evaluation
row's, every IW-LL item's) and the port is handed it, as the
single-process harness tests do (ROADMAP.md: noise is an input; the JAX
step runs in float64, never compared in another dtype, C2). The JAX
float64 step, ``test()`` and the IW-LL are computed once here, jitted.
Tolerances: against the JAX float64 step each parameter and statistic
within 1e-6 of its tensor's largest magnitude (the port's single-process
float64 step sits 5.5e-8 from JAX's there: Adam divides gradients of
order 1e-8, after the clip to 1e-5, by their own root mean square), the
loss, ``test()`` and the IW-LL at 1e-9 relative; against the port's
single-process run in the same dtype, 1e-12 of the largest magnitude in
float64 and 1e-5 in float32 (the toy). The 2 x 2 checkpoint holds full
tensors, loads in one process and goes to the JAX package's flat paths
(float32) and back within float32 rounding.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import test_torch_port_models as models_test
import test_torch_port_modes as modes_test
from lie_vae_tpu.data.loader import BatchLoader as JaxBatchLoader
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu.train import state as jstate
from lie_vae_tpu_torch.compat import state_dict_from_jax, state_dict_to_jax
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.parallel import run_steps
from lie_vae_tpu_torch.train import make_optimizer
from lie_vae_tpu_torch.train.checkpoint import apply_state, load_checkpoint
from test_torch_port_train import SMALL
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = dict(latent_mode="so3", decoder_mode="action", encode_mode="toy",
           deconv_mode="toy", mean_mode="s2s2", degrees=2, rep_copies=3)
BATCH, STEPS, N_TRAIN, N_TEST, LL = 32, 3, 64, 70, (4, 3)
LAUNCH_S = 120
STATE_TOL, JAX_TOL, SAME_TOL = 1e-6, 1e-9, 1e-12


class _Items:
    def __init__(self, x):
        self.x = x

    def __len__(self):
        return len(self.x)

    def gather(self, idx):
        return (self.x[np.asarray(idx)],)


def _jax_reference(flat, train_x, test_x):
    """The JAX float64 steps, test() and IW-LL at batch 1: the states after
    each step, the losses, test()'s means and the items' LLs, and the noise
    each drew, in the order the port's harness draws it."""
    jmodel = JaxLieVAE(**SMALL)
    variables = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64), models_test._unflatten(flat))
    state = jstate.TrainState.create(
        params=variables["params"], batch_stats=variables["batch_stats"],
        tx=jstate.make_optimizer(lr=1e-3, clip_grads=1e-5))

    @jax.jit
    def step(state, x, rng):
        def loss_fn(params):
            (recon, kl_sum, _, stats), mut = jmodel.apply(
                {"params": params, "batch_stats": state.batch_stats},
                x.astype(jnp.float64) / 255.0, n=1, train=True,
                method="elbo", rngs={"sample": rng}, mutable=["batch_stats"])
            return jnp.mean(recon) + jnp.mean(kl_sum), (
                mut["batch_stats"], stats[0].inner.z / stats[0].inner.sigma)

        (loss, (bs, eps)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        return state.apply_gradients(grads, new_batch_stats=bs), loss, eps

    @jax.jit
    def evaluate(params, batch_stats, x, rng):
        recon, kl_sum, _, stats = jmodel.apply(
            {"params": params, "batch_stats": batch_stats},
            x.astype(jnp.float64) / 255.0, n=1, train=False, method="elbo",
            rngs={"sample": rng})
        return recon[0], kl_sum, stats[0].inner.z / stats[0].inner.sigma

    @jax.jit
    def log_weights(params, batch_stats, x, rng):
        def fn(module, x):
            x_recon, stats = module(x, n=LL[0], train=False)
            w = -module.recon_loss(x_recon, x) + sum(
                s.log_prior() for s in stats) - sum(
                s.log_posterior() for s in stats)
            return w, stats[0].inner.z / stats[0].inner.sigma
        return jmodel.apply({"params": params, "batch_stats": batch_stats},
                            x.astype(jnp.float64) / 255.0,
                            rngs={"sample": rng}, method=fn)

    noise, states, losses = {}, [], []
    loader = JaxBatchLoader(_Items(train_x), BATCH, shuffle=True,
                            drop_last=True, seed=0)
    i = 0
    while i < STEPS:
        for (x,) in loader:
            if i == STEPS:
                break
            state, loss, eps = step(state, jnp.asarray(x),
                                    jax.random.PRNGKey(50 + i))
            noise[f"noise/train/{i}"] = np.asarray(eps)
            losses.append(float(loss))
            states.append({f"{c}/{k}": np.asarray(v) for c, tree in
                           (("params", state.params),
                            ("batch_stats", state.batch_stats))
                           for k, v in traverse_util.flatten_dict(
                               tree, sep="/").items()})
            i += 1
    # eval mode treats rows independently: one row per call, one compile
    means = []
    for j, (x,) in enumerate(JaxBatchLoader(_Items(test_x), BATCH,
                                            shuffle=False, drop_last=False)):
        rows = [evaluate(state.params, state.batch_stats,
                         jnp.asarray(x[r:r + 1]),
                         jax.random.PRNGKey(1000 * j + r))
                for r in range(len(x))]
        means.append([np.mean([float(r[0][0]) for r in rows]),
                      np.mean([float(r[1][0]) for r in rows])])
        noise[f"noise/eval/{j}"] = np.concatenate(
            [np.asarray(r[2]) for r in rows], axis=1)
    items = []
    for j, (x,) in enumerate(JaxBatchLoader(_Items(test_x), 1, shuffle=True,
                                            drop_last=False)):
        if j == LL[1]:
            break
        w, eps = log_weights(state.params, state.batch_stats, jnp.asarray(x),
                             jax.random.PRNGKey(7000 + j))
        noise[f"noise/ll/{j}"] = np.asarray(eps)
        items.append(float(np.logaddexp.reduce(np.asarray(w)[:, 0])
                           - np.log(LL[0])))
    means = np.asarray(means).mean(0)
    return dict(noise=noise, states=states, losses=np.asarray(losses),
                test=np.asarray([means[0], means[1], means[1]]),
                ll=np.asarray(items))


def _launch(n, specs, out):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    log = open(out + ".log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), "-m",
         "lie_vae_tpu_torch.parallel.run_steps", *specs, out],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def _wait(proc, log, out):
    try:
        rc = proc.wait(timeout=LAUNCH_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    if rc != 0:
        with open(out + ".log") as f:
            pytest.fail(f"the launch ended with {rc}:\n{f.read()[-4000:]}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(5)
    flat = modes_test._flat_weights(JaxLieVAE(**SMALL), seed=2)
    model = LieVAE(device="cpu", **SMALL)
    weights = {f"w/{k}": v.numpy() for k, v in
               state_dict_from_jax(flat, model).items()}
    train_x = rng.integers(0, 256, (N_TRAIN, 64, 64, 3), dtype=np.uint8)
    test_x = rng.integers(0, 256, (N_TEST, 64, 64, 3), dtype=np.uint8)
    torch.manual_seed(3)
    toy_model = LieVAE(device="cpu", **TOY)
    toy_data = rng.normal(size=(128 + 70, 9, 3)).astype(np.float32)
    toy = dict(model=TOY, dtype="float32", device="cpu", batch_size=64,
               seed=0, lr=1e-3, clip_grads=None, beta=1.0, steps=2,
               threads=1, timeout_s=60, test=True, kernel_impls=["fused"],
               mesh=[2, 1])
    toy_arrays = dict({f"w/{k}": v.numpy() for k, v in
                       toy_model.state_dict().items()},
                      train_x=toy_data[:128], test_x=toy_data[128:])
    torch.manual_seed(4)
    vmfq = dict(toy, model=dict(TOY, latent_mode="vmfq"), device_data=True)
    vmfq_arrays = dict(train_x=toy_data[:128], test_x=toy_data[128:], **{
        f"w/{k}": v.numpy() for k, v in LieVAE(
            device="cpu", **vmfq["model"]).state_dict().items()})
    paths = {}
    for name, spec, arrays in (("toy", toy, toy_arrays),
                               ("vmfq", vmfq, vmfq_arrays)):
        paths[name] = str(root / f"{name}.npz")
        run_steps.write_spec(paths[name], spec, arrays)
    # the toy models' launch draws its own noise: it runs beside the JAX
    # references, which the conv model's launch waits for
    launches = {"2x1": _launch(2, [paths["toy"], paths["vmfq"]],
                               str(root / "out2"))}
    try:
        return _finish(root, flat, model, weights, train_x, test_x, toy,
                       toy_arrays, vmfq, vmfq_arrays, paths, launches)
    finally:                     # no launch outlives the module's fixture
        for proc, log in launches.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def _finish(root, flat, model, weights, train_x, test_x, toy, toy_arrays,
            vmfq, vmfq_arrays, paths, launches):
    ref = _jax_reference(flat, train_x, test_x)
    conv = dict(model=SMALL, dtype="float64", device="cpu", batch_size=BATCH,
                seed=0, lr=1e-3, clip_grads=1e-5, beta=1.0, steps=STEPS,
                threads=1, timeout_s=60, test=True, ll=list(LL))
    conv_arrays = dict(weights, train_x=train_x, test_x=test_x,
                       **ref["noise"])
    paths["2x2"] = str(root / "2x2.npz")
    run_steps.write_spec(paths["2x2"], dict(
        conv, kernel_impls=["fused", "pallas"], mesh=[2, 2],
        checkpoint=str(root / "ck")), conv_arrays)
    launches["2x2"] = _launch(4, [paths["2x2"]], str(root / "out4"))
    torch.set_num_threads(2)
    single = {"conv": run_steps.run(dict(conv, kernel_impls=["fused",
                                                              "pallas"]),
                                    conv_arrays),
              "toy": run_steps.run(toy, toy_arrays),
              "vmfq": run_steps.run(vmfq, vmfq_arrays)}
    for name, out in (("2x2", "out4"), ("2x1", "out2")):
        _wait(*launches[name], str(root / out))
    ranks = {"2x2": [dict(np.load(root / "out4" / f"rank{r}_0.npz"))
                     for r in range(4)],
             "toy": [dict(np.load(root / "out2" / f"rank{r}_0.npz"))
                     for r in range(2)],
             "vmfq": [dict(np.load(root / "out2" / f"rank{r}_1.npz"))
                      for r in range(2)]}
    return dict(ref=ref, single=single, ranks=ranks, model=model,
                checkpoint=str(root / "ck_fused.pt"))


def _close(got, want, tol, what):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(w), what + k
            continue
        err = np.abs(np.asarray(got[k], np.float64) - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-300), (what, k, err)


def _state(out, impl, step):
    head = f"{impl}/state{step}/"
    return {k[len(head):]: v for k, v in out.items() if k.startswith(head)}


@pytest.mark.parametrize("mesh,impl", [("2x2", "fused"), ("2x2", "pallas")])
@pytest.mark.parametrize("step", [0, STEPS - 1])
def test_steps_match_the_jax_float64_step(runs, mesh, impl, step):
    """After one and after three steps, every rank's parameters and
    BatchNorm statistics, and the losses, against JAX's float64 step."""
    want = state_dict_from_jax(runs["ref"]["states"][step], runs["model"])
    want = {k: v.double().numpy() for k, v in want.items()
            if not k.endswith("num_batches_tracked")}
    for r, out in enumerate(runs["ranks"][mesh]):
        got = _state(out, impl, step)
        _close(got, want, STATE_TOL, f"rank {r} ")
        assert int(got["encoder.1.num_batches_tracked"]) == step + 1
        np.testing.assert_allclose(out[f"{impl}/loss"][:step + 1],
                                   runs["ref"]["losses"][:step + 1],
                                   rtol=JAX_TOL)


@pytest.mark.parametrize("mesh,impl", [("2x2", "fused"), ("2x2", "pallas")])
def test_steps_match_the_single_process_step(runs, mesh, impl):
    single = runs["single"]["conv"]
    for out in runs["ranks"][mesh]:
        for step in range(STEPS):
            _close(_state(out, impl, step), _state(single, impl, step),
                   SAME_TOL, f"step {step} ")
        np.testing.assert_allclose(out[f"{impl}/loss"],
                                   single[f"{impl}/loss"], rtol=SAME_TOL)


@pytest.mark.parametrize("mesh,impl", [("2x2", "fused"), ("2x2", "pallas")])
def test_ragged_test_set_keeps_the_uniform_mean_over_batches(runs, mesh,
                                                             impl):
    """test() on 70 items at batch 32: the padded, masked, all-reduced
    means equal one process's and JAX's (recon, KL, the one latent's KL)."""
    single = runs["single"]["conv"][f"{impl}/test"]
    np.testing.assert_allclose(single, runs["ref"]["test"], rtol=JAX_TOL)
    for out in runs["ranks"][mesh]:
        np.testing.assert_allclose(out[f"{impl}/test"], single,
                                   rtol=SAME_TOL)


@pytest.mark.parametrize("mesh,impl", [("2x2", "fused"), ("2x2", "pallas")])
def test_iwll_at_batch_1_runs_replicated(runs, mesh, impl):
    single = runs["single"]["conv"][f"{impl}/ll"]
    np.testing.assert_allclose(single, runs["ref"]["ll"], rtol=JAX_TOL)
    for out in runs["ranks"][mesh]:
        np.testing.assert_allclose(out[f"{impl}/ll"], single, rtol=SAME_TOL)


@pytest.mark.parametrize("name", ["toy", "vmfq"])
def test_toy_epoch_matches_the_single_process_epoch(runs, name):
    """tests/test_parallel.py:64-92's check: a data-parallel epoch of the
    toy model from the same state equals the single-process one; with the
    vMF latent too, whose sampler's draws every rank makes for the whole
    batch."""
    single = runs["single"][name]
    for out in runs["ranks"][name]:
        for step in range(2):
            _close(_state(out, "fused", step), _state(single, "fused", step),
                   1e-5, f"step {step} ")
        np.testing.assert_allclose(out["fused/loss"], single["fused/loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(out["fused/test"], single["fused/test"],
                                   rtol=1e-5)


def test_a_2x2_checkpoint_loads_in_one_process(runs):
    """Rank 0 wrote full tensors in the single-process format: they load
    strictly into an unsplit model and optimizer, and equal the state the
    ranks reached."""
    ckpt = load_checkpoint(runs["checkpoint"])
    model = LieVAE(device="cpu", **SMALL).double()
    opt = make_optimizer(model.named_parameters())
    assert apply_state(ckpt, model, opt) == STEPS and opt.count == STEPS
    final = _state(runs["ranks"]["2x2"][1], "fused", STEPS - 1)
    _close({k: v.numpy() for k, v in model.state_dict().items()}, final,
           0.0, "checkpoint ")
    assert ckpt["model"]["encoder.9.weight"].shape == (32, 16, 4, 4)
    # to the JAX package's flat '/' paths (an .npz artifact's, float32)
    # and back, within float32 rounding
    back = state_dict_from_jax(state_dict_to_jax(ckpt["model"], model),
                               model)
    _close({k: v.numpy() for k, v in back.items()},
           {k: v.numpy() for k, v in ckpt["model"].items()}, 2.0 ** -23,
           "npz ")
