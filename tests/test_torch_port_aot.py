"""The port's ahead-of-time serving (``serve.export_aot``, ``AotSession``,
``cli.serve --aot``, ``bench_serve_load``) held against the JAX package's,
on the CPU at a small size.

- ``export_aot``: the JAX package's layout (flat ``params/...`` and
  ``batch_stats/...`` paths, ``__step__``, which its ``load_npz`` reads)
  and ``__aot_meta__`` with the JAX keys, ``platforms: ["cuda"]``, the
  torch version and the ``LieVAE`` keywords; from a port checkpoint and
  from a reference state_dict;
- ``AotSession(path, device="cpu")`` rebuilds the model from the artifact
  alone and answers as ``InferenceSession`` on the same weights and seed,
  bit for bit, to float32 and to uint8 requests (SO(3), Gaussian and vMF
  latents: the vMF encode draws the sampler's proposals from the session's
  generator and picks against kappa, a given accepted draw as the first
  proposal); against the JAX
  package's ``AotSession`` over its own ``export_aot`` artifact of the same
  weights (a conv + BatchNorm model, exported from an orbax checkpoint as
  ``tests/test_serve.py`` does): decode, encode with the JAX session's noise
  handed over, and reconstruct within 1e-4, the serving tolerance;
- a JAX AOT artifact given to the port raises, naming the missing
  ``model`` keywords; a plain ``.npz`` raises too;
- ``cli.serve export --aot``, ``sample --aot`` and ``http --aot`` with no
  model flags; an artifact exported over two data devices served by two
  CPU replicas as one device serves it (API and CLI); the HTTP server over an AotSession answers as over an
  InferenceSession; ``bench_serve_load`` against it;
- a read-only request array (as an HTTP body's) is copied, not aliased;
- on a card (``cuda``-marked): the graphed session against the eager one,
  its replays counted.
"""
import io
import json
import threading
import urllib.request
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import traverse_util

import test_torch_port_modes as modes_test
from lie_vae_tpu import serve as jserve
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu.train.checkpoint import save_state as jax_save_state
from lie_vae_tpu.train.state import TrainState
from lie_vae_tpu.train.state import make_optimizer as jax_optimizer
from lie_vae_tpu_torch import bench_serve_load, compat, serve_http
from lie_vae_tpu_torch import serve as tserve
from lie_vae_tpu_torch.cli import main as cli_main
from lie_vae_tpu_torch.cli import serve as cli_serve
from lie_vae_tpu_torch.compat import state_dict_from_jax
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.train import make_optimizer
from lie_vae_tpu_torch.train.checkpoint import save_state
from test_torch_port_serve_http import _handed_over_noise
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

CONV = dict(modes_test.CONV, mean_mode="s2s2")
CONFIGS = {"so3": CONV, "normal": dict(modes_test.TOY, latent_mode="normal"),
           "vmfq": dict(modes_test.TOY, latent_mode="vmfq")}
TOL = 1e-4


def _tree(flat, coll):
    return traverse_util.unflatten_dict(
        {k[len(coll) + 1:]: jnp.asarray(v) for k, v in flat.items()
         if k.startswith(coll + "/")}, sep="/")


def _inputs(model, n, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    shape = (n,) + tuple(model.out_shape)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape).astype(np.float32)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Per latent: the weights, the port model, its checkpoint.pt and its
    export_aot artifact at batch 4."""
    root = tmp_path_factory.mktemp("aot")
    out = {}
    for mode, cfg in CONFIGS.items():
        flat = modes_test._flat_weights(JaxLieVAE(**cfg), seed=4)
        model = LieVAE(device="cpu", **cfg)
        model.load_state_dict(state_dict_from_jax(flat, model))
        opt = make_optimizer(model.named_parameters())
        opt.count = 5
        ckpt = str(root / f"{mode}.pt")
        save_state(ckpt, model, opt)
        art = tserve.export_aot(ckpt, model, str(root / f"{mode}_aot.npz"),
                                batch_size=4)
        out[mode] = dict(flat=flat, model=model, ckpt=ckpt, art=art)
    return out


def test_export_aot_layout_and_meta(artifacts):
    a = artifacts["so3"]
    with np.load(a["art"]) as z:
        files = dict((k, z[k]) for k in z.files)
    meta = json.loads(bytes(files.pop("__aot_meta__")).decode())
    assert int(files.pop("__step__")) == 5
    assert not any(k.startswith("__aot_") for k in files)   # no programs
    assert meta["platforms"] == ["cuda"] and meta["data_devices"] == 1
    assert meta["latent_mode"] == "so3" and meta["batch_size"] == 4
    assert tuple(meta["out_shape"]) == a["model"].out_shape
    assert meta["torch_version"] == torch.__version__
    assert meta["model"] == a["model"].config
    assert sorted(files) == sorted(a["flat"])
    for k, v in a["flat"].items():
        np.testing.assert_array_equal(files[k], v, err_msg=k)
    params, stats, step = jserve.load_npz(a["art"])   # the JAX reader
    assert step == 5 and "encoder" in params and stats


def test_export_aot_from_a_reference_state_dict(artifacts, tmp_path):
    a = artifacts["normal"]
    ref = compat.save_torch(tmp_path / "ref.pt", a["model"].state_dict())
    art = tserve.export_aot_from_torch(ref, a["model"], str(tmp_path / "r.npz"))
    sess = tserve.AotSession(art, device="cpu")
    assert sess.batch_size == 64 and int(np.load(art)["__step__"]) == 0
    z = np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        sess.decode(z), tserve.AotSession(a["art"], device="cpu").decode(z))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("mode", list(CONFIGS))
def test_aot_session_answers_as_the_inference_session(artifacts, mode,
                                                      dtype):
    """No model flags: the model comes from the artifact, and every surface
    answers as an InferenceSession of the same weights and seed, for
    float32 requests and uint8 ones (scaled on the device)."""
    a = artifacts[mode]
    aot = tserve.AotSession(a["art"], seed=3, device="cpu")
    live = tserve.InferenceSession(a["model"], a["model"].state_dict(),
                                   batch_size=4, seed=3, device="cpu")
    assert aot.model.config == a["model"].config
    assert aot.batch_size == 4
    x = _inputs(aot.model, 6, 1, dtype)       # a full and a padded chunk
    for _ in range(2):                        # the generators advance alike
        got, want = aot.encode(x), live.encode(x)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(aot.decode(want["pose"]),
                                  live.decode(want["pose"]))
    np.testing.assert_array_equal(aot.reconstruct(x), live.reconstruct(x))
    np.testing.assert_array_equal(aot.sample(5), live.sample(5))
    np.testing.assert_array_equal(
        aot.geodesic(want["pose"][0], want["pose"][1], steps=4),
        live.geodesic(want["pose"][0], want["pose"][1], steps=4))
    if mode == "vmfq":                        # a given accepted draw
        rng = np.random.default_rng(2)
        eps = (rng.uniform(0.1, 0.9, 6).astype(np.float32),
               rng.normal(size=(6, 4)).astype(np.float32))
        got, want = aot.encode(x, eps=eps), live.encode(x, eps=eps)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert aot.replays == {"encode": 0, "decode": 0, "reconstruct": 0}


@pytest.fixture(scope="module")
def jax_aot(artifacts, tmp_path_factory):
    """The JAX package's export_aot artifact of the so3 weights, from an
    orbax checkpoint, and its AotSession."""
    root = tmp_path_factory.mktemp("jax_aot")
    flat = artifacts["so3"]["flat"]
    state = TrainState.create(_tree(flat, "params"),
                              _tree(flat, "batch_stats"), jax_optimizer())
    ckpt = str(root / "checkpoint")
    jax_save_state(ckpt, state)
    art = str(root / "jax_aot.npz")
    jserve.export_aot(ckpt, JaxLieVAE(**CONV), art, batch_size=4,
                      platforms=("cpu",))
    return art, jserve.AotSession(art, seed=1)


def test_aot_session_matches_the_jax_aot_session(artifacts, jax_aot):
    _, jsess = jax_aot
    tsess = tserve.AotSession(artifacts["so3"]["art"], seed=1, device="cpu")
    x = _inputs(tsess.model, 6, 5)
    want = jsess.encode(x)
    got = tsess.encode(x, eps=_handed_over_noise("so3", want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                   err_msg=k)
    np.testing.assert_allclose(tsess.decode(want["pose"]),
                               jsess.decode(want["pose"]), rtol=0, atol=TOL)
    np.testing.assert_allclose(tsess.reconstruct(x), jsess.reconstruct(x),
                               rtol=0, atol=TOL)


def test_a_jax_aot_artifact_raises(jax_aot, artifacts, tmp_path):
    art, _ = jax_aot
    with pytest.raises(ValueError, match="no 'model' entry"):
        tserve.AotSession(art, device="cpu")
    plain = tserve.export_npz(artifacts["so3"]["ckpt"], str(tmp_path /
                                                            "p.npz"),
                              artifacts["so3"]["model"])
    with pytest.raises(ValueError, match="not an ahead-of-time artifact"):
        tserve.AotSession(plain, device="cpu")


@pytest.mark.parametrize("kind", ["eager", "aot"])
def test_bench_device_calls_answer_as_the_session(artifacts, kind):
    """``cli.serve bench``'s device-time calls (inputs already in the
    replicas' buffers, no host work) each run once and answer as the
    session's own encode and reconstruct of the batch."""
    a = artifacts["so3"]
    sess = (tserve.AotSession(a["art"], seed=3, device="cpu")
            if kind == "aot" else
            tserve.InferenceSession(a["model"], a["model"].state_dict(),
                                    batch_size=4, seed=3, device="cpu"))
    x = _inputs(sess.model, 4, 1)
    want = sess.encode(x)                         # its noise stays
    calls = cli_serve._device_calls(sess, x)
    assert sorted(calls) == ["encode", "reconstruct"]
    with torch.inference_mode():
        got = {name: fn() for name, fn in calls.items()}
    for k, outs in zip(("pose", "sigma", "sample"), zip(*got["encode"])):
        np.testing.assert_array_equal(torch.cat(outs).numpy(), want[k],
                                      err_msg=k)
    np.testing.assert_array_equal(torch.cat(got["reconstruct"]).numpy(),
                                  sess.reconstruct(x))


def test_read_only_requests_are_copied(artifacts):
    a = artifacts["normal"]
    sess = tserve.InferenceSession(a["model"], a["model"].state_dict(),
                                   batch_size=4, device="cpu")
    z = np.random.default_rng(1).normal(size=(8, 3)).astype(np.float32)
    want = sess.decode(z)
    z.setflags(write=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.testing.assert_array_equal(sess.decode(z), want)


# ------------------------------------------------------------------ CLI

_FLAGS = ["--device", "cpu", "--degrees", "2", "--rep_copies", "3",
          "--latent_mode", "vmfq"]


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    torch.manual_seed(0)
    model = cli_serve._build_model(cli_main.parse_args(_FLAGS))
    save_state(tmp_path / "out" / "checkpoint.pt", model,
               make_optimizer(model.named_parameters()))
    return tmp_path, model


def test_cli_export_aot_then_sample_and_http(run_dir, monkeypatch):
    tmp, model = run_dir
    art = cli_serve.main(["export", "--aot", "--aot_batch", "8",
                          "--checkpoint", "out/checkpoint.pt"] + _FLAGS)
    assert art == "out/artifact_aot.npz"
    out = cli_serve.main(["sample", "--aot", art, "-n", "5", "--seed", "3",
                          "--out", "s.npz", "--device", "cpu"])
    live = tserve.InferenceSession(model, model.state_dict(), batch_size=8,
                                   device="cpu")
    with np.load(out) as z:
        np.testing.assert_array_equal(z["images"], live.sample(5, seed=3))
    served = {}
    monkeypatch.setattr(serve_http, "serve",
                        lambda sess, **kw: served.update(sess=sess, **kw))
    cli_serve.main(["http", "--aot", art, "--device", "cpu", "--port", "0"])
    assert isinstance(served["sess"], tserve.AotSession)
    assert served["sess"].batch_size == 8 and served["port"] == 0
    with pytest.raises(SystemExit, match="no model flags"):
        cli_serve.main(["sample", "--aot", art, "--device", "cpu",
                        "--degrees", "2"])


@pytest.mark.parametrize("mode", list(CONFIGS))
def test_aot_session_over_two_data_devices(artifacts, tmp_path, mode,
                                           monkeypatch):
    """An artifact exported over a 2-device mesh records it, and its
    session (two CPU replicas, each chunk split in halves) answers as the
    single-device InferenceSession of the same weights and seed."""
    from lie_vae_tpu_torch.parallel import make_mesh
    a = artifacts[mode]
    art = tserve.export_aot(a["ckpt"], a["model"], str(tmp_path / "m.npz"),
                            batch_size=4,
                            mesh=make_mesh(2, devices=["cpu", "cpu"]))
    aot = tserve.AotSession(art, seed=3, device="cpu")
    ran, run = [], tserve._Replica.run
    monkeypatch.setattr(tserve._Replica, "run",
                        lambda r, surface: ran.append(r.rows) or run(
                            r, surface))
    aot.reconstruct(_inputs(aot.model, 4, 0))     # one chunk, two replicas
    assert aot.meta["data_devices"] == 2
    assert ran == [slice(0, 2), slice(2, 4)]
    live = tserve.InferenceSession(a["model"], a["model"].state_dict(),
                                   batch_size=4, seed=3, device="cpu")
    x = _inputs(aot.model, 6, 1)
    for _ in range(2):
        got, want = aot.encode(x), live.encode(x)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    np.testing.assert_allclose(aot.decode(want["pose"]),
                               live.decode(want["pose"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(aot.reconstruct(x), live.reconstruct(x),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="multiple of the mesh's data size"):
        tserve.export_aot(a["ckpt"], a["model"], str(tmp_path / "n.npz"),
                          batch_size=5,
                          mesh=make_mesh(2, devices=["cpu", "cpu"]))


def test_cli_aot_over_a_mesh(run_dir):
    """export --aot --aot_data_devices 2, then sample and http from it on two
    CPU replicas; a --data_devices that disagrees with the artifact, or a
    card count below it, raises with the counts."""
    tmp, model = run_dir
    art = cli_serve.main(["export", "--aot", "--aot_batch", "8",
                          "--aot_data_devices", "2", "--checkpoint",
                          "out/checkpoint.pt", "--out", "mesh.npz"] + _FLAGS)
    out = cli_serve.main(["sample", "--aot", art, "-n", "5", "--seed", "3",
                          "--out", "s.npz", "--device", "cpu",
                          "--data_devices", "2"])
    live = tserve.InferenceSession(model, model.state_dict(), batch_size=8,
                                   device="cpu")
    with np.load(out) as z:
        np.testing.assert_allclose(z["images"], live.sample(5, seed=3),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(SystemExit, match="exported for 2 device"):
        cli_serve.main(["sample", "--aot", art, "--data_devices", "3",
                        "--device", "cpu"])


def _post(url, route, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(
        f"{url}/v1/{route}", data=buf.getvalue(),
        headers={"Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=60) as r:
        with np.load(io.BytesIO(r.read())) as z:
            return {k: z[k] for k in z.files}


@pytest.fixture
def aot_server(artifacts):
    """An HTTP server over an AotSession and one over an InferenceSession
    of the same weights and seed, each in a thread; shut down after."""
    a = artifacts["so3"]
    sessions = (tserve.AotSession(a["art"], seed=2, device="cpu"),
                tserve.InferenceSession(a["model"], a["model"].state_dict(),
                                        batch_size=4, seed=2, device="cpu"))
    servers, urls, threads = [], [], []
    for sess in sessions:
        srv = serve_http.make_server(sess)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        servers.append(srv)
        threads.append(t)
        urls.append(f"http://127.0.0.1:{srv.server_address[1]}")
    yield sessions, urls
    for srv, t in zip(servers, threads):
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
        assert not t.is_alive()


def test_http_serves_an_aot_session_as_an_inference_session(aot_server):
    (aot, _), (aurl, lurl) = aot_server
    x = _inputs(aot.model, 6, 3)
    for route, body in (("encode", {"images": x}),
                        ("reconstruct", {"images": x}),
                        ("sample", {"n": np.asarray(5)})):
        got, want = _post(aurl, route, body), _post(lurl, route, body)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=route)


def test_bench_serve_load_over_an_aot_session(artifacts, tmp_path):
    out = tmp_path / "rows.json"
    rows = bench_serve_load.main([
        "--aot", artifacts["normal"]["art"], "--device", "cpu",
        "--clients", "1", "2", "--routes", "encode", "--duration", "0.3",
        "--req_batch", "4", "--out", str(out)])
    assert [r["clients"] for r in rows] == [1, 2]
    for r in rows:
        assert r["requests"] > 0 and r["req_s"] > 0
        assert r["images_s"] == pytest.approx(4 * r["req_s"])
        assert 0 < r["p50_ms"] <= r["p95_ms"]
    saved = json.loads(out.read_text())
    assert saved["session"] == "AotSession" and saved["rows"] == rows


# ----------------------------------------------------------------- card

@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(CONFIGS))
def test_graphed_session_matches_the_eager_one_on_the_card(artifacts, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the session captures CUDA graphs")
    a = artifacts[mode]
    aot = tserve.AotSession(a["art"], seed=3)
    live = tserve.InferenceSession(
        LieVAE(device="cuda", **CONFIGS[mode]), a["model"].state_dict(),
        batch_size=4, seed=3)
    x = _inputs(aot.model, 6, 1)
    got, want = aot.encode(x), live.encode(x)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    np.testing.assert_allclose(aot.decode(want["pose"]),
                               live.decode(want["pose"]), rtol=0, atol=1e-6)
    assert aot.replays == {"encode": 2, "decode": 2, "reconstruct": 0}
    aot.close()
