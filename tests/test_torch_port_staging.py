"""The training step's host inputs reach the device without a wait.

``utils.onto`` copies a CPU tensor to a card through pinned memory,
non_blocking, and returns any other tensor as it is; the training harness
(``UnsupervisedExperiment``) sends every per-step input through it (the
batch's indices into the device cache, the posterior noise, the rotation
angles and the second encoder pass's noise) and counts those copies in
``staged``.

- On the CPU the helper returns the tensor itself, and ``staged`` stays
  empty.
- Three steps of ``train()`` over a device cache give losses and
  parameters identical to a run with the helper replaced by a plain
  ``.to``, for a flagship-shaped model and a regularised one.
- The benchmark's ``Noise`` keeps, in order, exactly the noise the steps
  consumed.
- On a card (``cuda``): after one warm-up step, three steps of each under
  ``torch.cuda.set_sync_debug_mode("error")`` raise nothing, ``staged``
  counts one copy per input per step, and losses and parameters equal the
  blocking route's bit for bit.

The file imports neither JAX nor the JAX package, so the card's tests run
on a machine without them: ``python -m pytest --noconftest
tests/test_torch_port_staging.py``.
"""
import contextlib

import numpy as np
import pytest
import torch

from lie_vae_tpu_torch.models import LieVAE, flagship_model
from lie_vae_tpu_torch.train import (ConstantSchedule, UnsupervisedExperiment,
                                     get_beta_schedule)
from lie_vae_tpu_torch.train import loop
from lie_vae_tpu_torch.utils import onto
from port_bench.harness.inputs import Noise, PoolDataset

# the flagship's shape (SO(3), S2xS2 mean, conv encoder, deconv decoder,
# RGB, BatchNorm) at small widths
SMALL = dict(latent_mode="so3", mean_mode="s2s2", encode_mode="conv",
             deconv_mode="deconv", degrees=2, rep_copies=2, conv_hidden=4,
             deconv_hidden=6, rgb=True, batch_norm=True)
REGULARIZED = dict(equivariance_lamb=ConstantSchedule(100.0),
                   encoder_continuity_lamb=ConstantSchedule(3000.0),
                   equivariance_rotate="shear")
INPUTS = {False: ("indices", "eps"),
          True: ("indices", "eps", "theta", "eq_eps")}


def _plain_to(t, device, dtype=None):
    return t.to(device, dtype)


def _experiment(regularized, model, images=24, batch=8, noise=None):
    """``train()`` over a device cache of ``images`` seeded renders-like
    uint8 images, ``batch`` images a step (pairs with the regularizers)."""
    per = 2 if regularized else 1
    rng = np.random.default_rng(0)
    data = PoolDataset(
        np.zeros((images // per, per, 3, 3), np.float32),
        rng.integers(0, 256, (images // per, per, 64, 64, 3), np.uint8))
    return UnsupervisedExperiment(
        model=model, train_dataset=data, test_dataset=data,
        beta_schedule=get_beta_schedule(None, 1.0), report_freq=None,
        batch_size=batch // per, device_data=True, seed=0, noise=noise,
        **(REGULARIZED if regularized else {}))


def _run(regularized, make_model, steps=3, warm=0, during=None):
    """(losses, parameters, staged) of ``warm`` steps and then ``steps``
    steps of ``train()`` from the same seeded model, the ``steps`` inside
    the context ``during()`` when given."""
    torch.manual_seed(0)
    exp = _experiment(regularized, make_model())
    losses = []
    if warm:
        exp.train(0, max_steps=warm)
    start = dict(exp.staged)
    with (during or contextlib.nullcontext)():
        exp.train(1, max_steps=steps,
                  on_step=lambda m: losses.append(m["loss"]))
    params = {k: p.detach().clone() for k, p in exp.model.named_parameters()}
    staged = {k: v - start.get(k, 0) for k, v in exp.staged.items()}
    return torch.stack(losses), params, staged


def _assert_identical(a, b):
    losses_a, params_a, _ = a
    losses_b, params_b, _ = b
    assert torch.equal(losses_a, losses_b)
    assert params_a.keys() == params_b.keys()
    for k in params_a:
        assert torch.equal(params_a[k], params_b[k]), k


@pytest.mark.parametrize("t", [
    torch.arange(6), torch.zeros((2, 3), dtype=torch.uint8),
    torch.randn(4, 3).t()], ids=["int64", "uint8", "strided"])
@pytest.mark.parametrize("dtype", [None, "same"])
def test_onto_returns_the_tensor_itself_on_the_cpu(t, dtype):
    assert onto(t, "cpu", t.dtype if dtype else None) is t
    assert onto(t, torch.device("cpu")) is t


@pytest.mark.parametrize("regularized", [False, True],
                         ids=["flagship", "regularised"])
def test_train_matches_the_blocking_route(regularized, monkeypatch):
    make = lambda: LieVAE(**SMALL, device="cpu")  # noqa: E731
    staged = _run(regularized, make)
    monkeypatch.setattr(loop, "onto", _plain_to)
    _assert_identical(staged, _run(regularized, make))


@pytest.mark.parametrize("regularized", [False, True],
                         ids=["flagship", "regularised"])
def test_noise_kept_is_the_noise_consumed(regularized, monkeypatch):
    consumed = []
    real = loop.train_step

    def recording(*args, **kw):
        consumed.append(kw["eps"])
        if regularized:
            consumed.append(kw["eq_eps"])
        return real(*args, **kw)

    monkeypatch.setattr(loop, "train_step", recording)
    torch.manual_seed(0)
    noise = Noise(7)
    exp = _experiment(regularized, LieVAE(**SMALL, device="cpu"),
                      noise=noise)
    exp.train(0, max_steps=3)
    assert len(consumed) == len(noise.kept) == 3 * (2 if regularized else 1)
    for kept, used in zip(noise.kept, consumed):
        assert torch.equal(kept, used.cpu())


@pytest.mark.parametrize("regularized", [False, True],
                         ids=["flagship", "regularised"])
def test_staged_stays_empty_on_the_cpu(regularized):
    _, _, staged = _run(regularized, lambda: LieVAE(**SMALL, device="cpu"),
                        warm=1)
    assert staged == {}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the sync check reads the CUDA "
                    "stream)")
    return torch.device("cuda")


@contextlib.contextmanager
def _syncs_raise():
    """``torch.cuda.set_sync_debug_mode("error")`` inside, on a drained
    card."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("regularized", [False, True],
                         ids=["flagship", "regularised"])
def test_steps_make_no_synchronising_call_on_the_card(cuda_device,
                                                      regularized,
                                                      monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    make = lambda: flagship_model(device=cuda_device)  # noqa: E731
    staged_run = _run(regularized, make, warm=1, during=_syncs_raise)
    assert staged_run[2] == {k: 3 for k in INPUTS[regularized]}
    monkeypatch.setattr(loop, "onto", _plain_to)
    _assert_identical(staged_run, _run(regularized, make, warm=1))
