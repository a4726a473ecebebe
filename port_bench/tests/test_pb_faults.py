"""The rest of a run, past the look for a card, with the timed path
broken underneath: ``correct`` comes out false for each fault a cell can
have. A training step that returns its state unchanged; a step that
leaves half of the batch out and takes the mean over the rest; an answer
altered where the session produces it. (No cell spans chips, so none can
leave an exchange between chips out.) The CPU at a tiny size in float64,
where sound runs agree with the reference to rounding, and the cells'
own limits."""
import numpy as np
import pytest
import torch

from port_bench.harness import check, serve, train
from port_bench.harness.spec import Bench

TRAIN_CELLS = ["flagship-train", "scpairs_reg-train"]


def _correct(bench, workload, runner):
    _, _, numbers = runner.run(bench, bench.cell(workload), 77, 0.1, False,
                               device="cpu", workers=1)
    return check.judge(numbers, bench.limits(workload))


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_sound_training_is_correct(tiny_root, workload, float64):
    assert _correct(Bench(tiny_root), workload, train)[0]


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_state_left_unchanged(tiny_root, workload, float64, monkeypatch):
    from lie_vae_tpu_torch.train import state
    monkeypatch.setattr(state.Optimizer, "step", lambda self: None)
    ok, checks = _correct(Bench(tiny_root), workload, train)
    assert not ok
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_half_batch_left_out(tiny_root, workload, float64, monkeypatch):
    from lie_vae_tpu_torch.train import loop
    step = loop.train_step

    def half(model, optimizer, x, beta, eps=None, theta=None, eq_eps=None,
             **kw):
        h = x.shape[0] // 2
        return step(model, optimizer, x[:h], beta,
                    eps=None if eps is None else eps[:, :h],
                    theta=None if theta is None else theta[:h],
                    eq_eps=None if eq_eps is None else eq_eps[:, :h], **kw)

    monkeypatch.setattr(loop, "train_step", half)
    ok, checks = _correct(Bench(tiny_root), workload, train)
    assert not ok, checks


def test_sound_serving_is_correct(tiny_root, float64):
    assert _correct(Bench(tiny_root), "flagship-serve_peak", serve)[0]


def test_answer_altered(tiny_root, float64, monkeypatch):
    from lie_vae_tpu_torch.serve import AotSession
    real = AotSession.reconstruct

    def altered(self, images):
        out = np.array(real(self, images))
        out[0] += 0.1
        return out

    monkeypatch.setattr(AotSession, "reconstruct", altered)
    ok, checks = _correct(Bench(tiny_root), "flagship-serve_peak", serve)
    assert not ok, checks
