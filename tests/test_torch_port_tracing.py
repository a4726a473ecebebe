"""The port's spans (``lie_vae_tpu_torch.tracing``) and the benchmark's
metrics that read them, on the CPU at a small size.

- With no profiler a span is one shared no-op: ``train()`` and a session
  call record nothing and open no ``record_function``.
- Under a CPU ``torch.profiler`` two steps of a small flagship-shaped
  model record one ``train.step`` a step, its children (``train.forward``,
  ``train.losses`` only with a regularizer, ``train.backward``,
  ``train.optimizer``) under it with its id, the global step, and
  ``train.batch`` and ``train.inputs`` beside it; an ``AotSession``
  reconstruct records one ``session.request`` whose children share its id.
- Every recorded span is among the profiler's events under its name,
  starting within 1 ms of the record (one clock).
- The four readers (``port_bench/metrics``) give, on a
  ``record.Context`` of such a trace, the numbers recomputed here, and
  None in cells outside their ``workloads`` and on a trace without the
  program's spans (a program before them).
"""
import sys

import numpy as np
import pytest
import torch

from lie_vae_tpu_torch import tracing
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.serve import AotSession, export_aot_from_torch
from lie_vae_tpu_torch.train import (LinearSchedule, UnsupervisedExperiment,
                                     get_beta_schedule)
from port_bench.harness import record, trace
from port_bench.harness.inputs import PoolDataset
from port_bench.harness.spec import Bench
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

# the flagship's shape (SO(3), S2xS2 mean, conv encoder, deconv decoder,
# RGB, BatchNorm) at small widths
SMALL = dict(latent_mode="so3", mean_mode="s2s2", encode_mode="conv",
             deconv_mode="deconv", degrees=2, rep_copies=2, conv_hidden=4,
             deconv_hidden=6, rgb=True, batch_norm=True)
STEP_CHILDREN = ("train.forward", "train.losses", "train.backward",
                 "train.optimizer")
SESSION_CHILDREN = ("session.normalize", "session.chunk", "session.copy_in",
                    "session.replay", "session.copy_out", "session.gather")
READERS = ("inputs_idle_pct.train", "optimizer_host_ms_per_step.train",
           "losses_fwd_extent_ms_per_step.train",
           "session_host_ms_per_request.serve")


def _experiment(regularized):
    """A small experiment over 8 images in the device cache: 2 steps an
    epoch of 4 images (pairs of consecutive poses with the regularizers)."""
    torch.manual_seed(0)
    model = LieVAE(**SMALL, device="cpu")
    per = 2 if regularized else 1
    rng = np.random.default_rng(0)
    data = PoolDataset(
        np.zeros((8 // per, per, 3, 3), np.float32),
        rng.integers(0, 256, (8 // per, per, 64, 64, 3), np.uint8))
    reg = {}
    if regularized:
        reg = {"equivariance_lamb": LinearSchedule(0, 100.0, 0, 10),
               "encoder_continuity_lamb": LinearSchedule(0, 3000.0, 0, 10)}
    return UnsupervisedExperiment(
        model=model, train_dataset=data, test_dataset=data,
        beta_schedule=get_beta_schedule(None, 1.0), report_freq=None,
        batch_size=4 // per, device_data=True, seed=0, **reg)


def _session(tmp_path):
    torch.manual_seed(1)
    model = LieVAE(**SMALL, device="cpu")
    weights = tmp_path / "best.pt"
    torch.save(model.state_dict(), weights)
    path = str(tmp_path / "artifact_aot.npz")
    export_aot_from_torch(str(weights), model, path, batch_size=4)
    return AotSession(path, device="cpu")


def _images(n):
    return np.random.default_rng(2).integers(0, 256, (n, 64, 64, 3),
                                             np.uint8)


def _profiled(run, take=True):
    """``run()`` under a CPU profiler inside the benchmark's ``window``
    span: (profiler, the program's spans recorded, or None with
    ``take=False``, which leaves them in the record)."""
    tracing.take()
    with trace.profiler() as prof:
        win = trace.Span("window")
        run()
        win.close()
    return prof, tracing.take() if take else None


@pytest.fixture(scope="module")
def train_runs():
    """Two steps of each experiment, profiled: {regularized: (profiler,
    spans)}."""
    out = {}
    for regularized in (False, True):
        exp = _experiment(regularized)
        exp.train(0, max_steps=1)
        out[regularized] = _profiled(lambda: exp.train(1, max_steps=2))
    return out


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    """One reconstruct of 6 images (two chunks of 4) by a CPU AotSession,
    profiled: (profiler, spans, session)."""
    sess = _session(tmp_path_factory.mktemp("aot"))
    sess.reconstruct(_images(4))
    prof, spans = _profiled(lambda: sess.reconstruct(_images(6)))
    return prof, spans, sess


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_span_is_off_without_a_profiler(tmp_path, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counted(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    assert tracing.span("a") is tracing.span("b", 3, device=True)
    tracing.take()
    exp = _experiment(True)
    exp.train(0, max_steps=2)
    sess = _session(tmp_path)
    sess.reconstruct(_images(4))
    sess.sample(2)
    assert tracing.take() == []
    assert opened == []


@pytest.mark.parametrize("regularized", [False, True])
def test_training_spans(train_runs, regularized):
    _, spans = train_runs[regularized]
    steps = _by_name(spans, "train.step")
    # epoch 1 of 2 steps: global steps 3 and 4
    assert [s.id for s in steps] == [3, 4]
    assert all(s.parent_id is None for s in steps)
    for name in ("train.batch", "train.inputs"):
        got = _by_name(spans, name)
        assert [s.id for s in got] == [3, 4]
        assert all(s.parent_id is None for s in got)
    want = [n for n in STEP_CHILDREN
            if regularized or n != "train.losses"]
    for step in steps:
        children = [s for s in spans if s.parent_id == step.span_id]
        assert [s.name for s in children] == want
        for s in children:
            assert s.id == step.id
            assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
            assert s.device_ms is None          # no card
    assert len(spans) == 2 * (3 + len(want))


def test_session_spans(serve_run):
    _, spans, sess = serve_run
    requests = _by_name(spans, "session.request")
    assert len(requests) == 1 and requests[0].parent_id is None
    assert requests[0].id == sess._requests
    req = requests[0]
    children = [s for s in spans if s.parent_id == req.span_id]
    # two chunks: each cut, copied in, run and copied out; one gather
    assert [s.name for s in children] == [
        "session.normalize", "session.chunk", "session.copy_in",
        "session.replay", "session.copy_out", "session.chunk",
        "session.copy_in", "session.replay", "session.copy_out",
        "session.gather"]
    assert {s.name for s in children} == set(SESSION_CHILDREN)
    assert all(s.id == req.id for s in children)
    assert len(spans) == 1 + len(children)


def test_recorded_spans_are_in_the_profiler_trace(train_runs, serve_run):
    runs = [train_runs[False], train_runs[True], serve_run[:2]]
    for prof, spans in runs:
        events = {}
        for e in prof.profiler.kineto_results.events():
            events.setdefault(e.name(), []).append(e.start_ns())
        assert spans
        for s in spans:
            near = min(abs(t - s.start_ns) for t in events[s.name])
            assert near < 1_000_000, (s.name, near)


def _train_ctx(run, workload):
    prof, spans = run
    return record.Context(kind="train", cell={"name": workload},
                          trace=trace.Trace(prof), program_spans=spans,
                          traced_steps=2)


def _read(name, ctx):
    return Bench().reader(name).read(ctx)


def test_readers_recompute(train_runs, serve_run):
    reg = _train_ctx(train_runs[True], "scpairs_reg-train")
    tr, spans = reg.trace, reg.program_spans
    # no device on the CPU: the whole window is one gap
    inputs = [(lo, hi) for name, lo, hi in tr.host
              if name in ("train.batch", "train.inputs")]
    assert len(inputs) == 4
    want = 100.0 * sum(hi - lo for lo, hi in inputs) / (tr.t1 - tr.t0)
    assert _read("inputs_idle_pct.train", reg) == pytest.approx(want)
    opt = _by_name(spans, "train.optimizer")
    assert _read("optimizer_host_ms_per_step.train", reg) == pytest.approx(
        sum(s.end_ns - s.start_ns for s in opt) / 1e6 / 2)
    # the extent of train.losses: None without a card, else summed
    assert _read("losses_fwd_extent_ms_per_step.train", reg) is None
    reg.program_spans = [s._replace(device_ms=1.5 + s.id)
                         if s.name == "train.losses" else s for s in spans]
    assert _read("losses_fwd_extent_ms_per_step.train",
                 reg) == pytest.approx((4.5 + 5.5) / 2)

    # the serving reader takes the record itself, once a run
    sess = serve_run[2]
    prof, _ = _profiled(lambda: sess.reconstruct(_images(6)), take=False)
    serve = record.Context(kind="serve", cell={"name": "flagship-serve_peak"},
                           trace=trace.Trace(prof), traced_requests=1)
    got = _read("session_host_ms_per_request.serve", serve)
    assert tracing.take() == []
    spans = serve.program_spans
    assert len(_by_name(spans, "session.request")) == 1
    host = [s for s in spans if s.name in ("session.normalize",
                                           "session.chunk", "session.gather")]
    assert len(host) == 4
    assert got == pytest.approx(
        sum(s.end_ns - s.start_ns for s in host) / 1e6)

    # outside their workloads
    flagship = _train_ctx(train_runs[False], "flagship-train")
    assert _read("losses_fwd_extent_ms_per_step.train", flagship) is None
    assert _read("optimizer_host_ms_per_step.train", flagship) > 0
    for name in READERS[:3]:
        assert _read(name, serve) is None
    assert _read("session_host_ms_per_request.serve", reg) is None


def test_readers_without_program_spans(monkeypatch):
    """A program before the spans: the readers give None, raising
    nothing."""
    exp = _experiment(True)
    exp.train(0, max_steps=1)
    monkeypatch.setattr(tracing, "span", lambda *a, **k: tracing._OFF)
    prof, spans = _profiled(lambda: exp.train(1, max_steps=2))
    assert spans == []
    monkeypatch.setitem(sys.modules,
                        "lie_vae_tpu_torch.tracing", None)
    for kind in ("train", "serve"):
        ctx = record.Context(kind=kind, cell={"name": "x"},
                             trace=trace.Trace(prof))
        for name in READERS:
            assert _read(name, ctx) is None
