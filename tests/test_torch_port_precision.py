"""The port's one float32 precision (``precision.ieee_float32``), on the CPU.

torch runs float32 cuDNN convolutions in TF32 unless told otherwise. The
helper sets IEEE float32 for cuDNN convolutions and cuBLAS matmuls inside
and restores the caller's settings after; every entry point of the port
(``InferenceSession``'s public methods, ``train_step``,
``UnsupervisedExperiment``'s training, ``test()`` and IW-LL, ``cli.main``
and ``cli.serve``) runs its model calls inside it. A probe on
``LieVAE.encode`` and ``LieVAE.decode`` records the settings each call
sees, with the process's settings put to TF32 before each entry point.
Importing the port sets nothing.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lie_vae_tpu_torch import precision
from lie_vae_tpu_torch.cli import main as cli_main
from lie_vae_tpu_torch.cli import serve as cli_serve
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.serve import InferenceSession
from lie_vae_tpu_torch.train import (ConstantSchedule, UnsupervisedExperiment,
                                     make_optimizer, train_step)
from lie_vae_tpu_torch.train.checkpoint import save_state
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IEEE = ("ieee", "ieee")
TF32 = ("tf32", "tf32")
TOY = dict(encode_mode="toy", deconv_mode="toy", degrees=2, rep_copies=2,
           device="cpu")


def _set(values):
    (torch.backends.cudnn.conv.fp32_precision,
     torch.backends.cuda.matmul.fp32_precision) = values


@pytest.fixture
def tf32():
    """The process at TF32 for both (torch's default for cuDNN), put back
    as it was after the test."""
    saved = precision.flags()
    _set(TF32)
    yield
    _set(saved)


@pytest.fixture
def seen(monkeypatch, tf32):
    """The settings every LieVAE.encode / decode call sees."""
    calls = []
    encode, decode = LieVAE.encode, LieVAE.decode

    def probe(fn):
        def wrapped(self, *a, **k):
            calls.append(precision.flags())
            return fn(self, *a, **k)
        return wrapped

    monkeypatch.setattr(LieVAE, "encode", probe(encode))
    monkeypatch.setattr(LieVAE, "decode", probe(decode))
    return calls


def _check(calls):
    assert calls and set(calls) == {IEEE}, calls
    assert precision.flags() == TF32           # restored after the call
    calls.clear()


def test_helper_sets_and_restores(tf32):
    with precision.ieee_float32():
        assert precision.flags() == IEEE
        with precision.ieee_float32():
            assert precision.flags() == IEEE
        assert precision.flags() == IEEE
    assert precision.flags() == TF32
    with pytest.raises(RuntimeError):
        with precision.ieee_float32():
            raise RuntimeError
    assert precision.flags() == TF32

    @precision.ieee_float32()
    def inside():
        return precision.flags()

    assert inside() == IEEE and inside() == IEEE
    assert precision.flags() == TF32


def test_importing_the_port_sets_nothing():
    code = ("import torch\nbefore = (torch.backends.cudnn.conv.fp32_precision,"
            " torch.backends.cuda.matmul.fp32_precision)\n"
            "import lie_vae_tpu_torch.serve, lie_vae_tpu_torch.serve_http, "
            "lie_vae_tpu_torch.train, lie_vae_tpu_torch.cli.main, "
            "lie_vae_tpu_torch.cli.serve\n"
            "from lie_vae_tpu_torch.precision import flags\n"
            "assert flags() == before, (flags(), before)\nprint(before)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_session_runs_in_ieee_float32(seen):
    model = LieVAE(**TOY)
    sess = InferenceSession(model, model.state_dict(), batch_size=4,
                            device="cpu")
    x = np.random.default_rng(0).random((3, 9, 2), np.float32)
    for call in (sess.warmup, lambda: sess.encode(x), lambda: sess.decode(
            sess.encode(x)["pose"]), lambda: sess.reconstruct(x),
            lambda: sess.sample(2), lambda: sess.geodesic(
                np.eye(3), np.eye(3), steps=3)):
        call()
        _check(seen)


def test_training_runs_in_ieee_float32(seen):
    torch.manual_seed(0)
    model = LieVAE(**TOY)
    opt = make_optimizer(model.named_parameters())
    x = np.random.default_rng(1).random((4, 9, 2), np.float32)
    train_step(model, opt, x, 1.0, generator=torch.Generator().manual_seed(0))
    _check(seen)
    data = [(x[i],) for i in range(4)]

    class Data(list):
        rgb = False

        def gather(self, idx):
            return [np.stack([self[i][0] for i in idx])]

        def prep_batch(self, batch):
            return batch

    exp = UnsupervisedExperiment(
        model=model, train_dataset=Data(data), test_dataset=Data(data),
        beta_schedule=ConstantSchedule(1.0), batch_size=2, report_freq=100)
    exp.train(0)
    _check(seen)
    exp.test()
    _check(seen)
    exp.log_likelihood(Data(data), n=2, max_items=1)
    _check(seen)


def test_clis_run_in_ieee_float32(seen, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    flags = ["--device", "cpu", "--degrees", "2", "--rep_copies", "2"]
    cli_main.main(flags + ["--epochs", "1", "--ll_samples", "2",
                           "--ll_max_items", "1", "--save_dir", "out",
                           "--log_dir", "logs"])
    _check(seen)
    model = cli_serve._build_model(cli_main.parse_args(flags))
    save_state(tmp_path / "ckpt.pt", model,
               make_optimizer(model.named_parameters()))
    cli_serve.main(["sample", "--checkpoint", "ckpt.pt", "-n", "2"] + flags)
    _check(seen)
