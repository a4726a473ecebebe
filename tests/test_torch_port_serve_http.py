"""The port's serving front end (``serve_http``, ``cli.serve``, the ``.npz``
artifacts) held against the JAX package's, on the CPU at a small size.

- the port's HTTP server and the JAX package's, each over a session of the
  same weights (carried by ``compat``), started on ephemeral ports: every
  route in both body formats gives the same answer (1e-5: float32 sums in
  other orders), the encode sample with the JAX server's noise handed over
  to the port's session, the prior samples by decoding the JAX server's
  Haar poses; SO(3), Gaussian and ``vmfq`` (quaternion) latents;
- the error contract: the same status and message for a bad route, a
  missing field, a body that is neither .npz nor JSON, a body above the
  cap, an unknown path;
- the JAX package's client (``lie_vae_tpu/serve_client.py``) drives the
  port's server unchanged; concurrent requests run one at a time behind
  the lock and answer as serial ones;
- ``serve.export_npz`` read by the JAX package's ``serve.load_npz`` and
  served there, and the JAX package's ``export_npz_from_torch`` artifact
  served by the port, each answering as the session it came from;
- ``cli.serve`` ``export`` (to .npz, from a reference state_dict, back to
  a reference state_dict), ``sample``, ``trajectory`` and ``bench`` with
  ``--device cpu``; ``--data_devices 2`` over two CPU replicas answering
  as one device, and the device counts it cannot have raising (``--aot``
  itself: ``test_torch_port_aot.py``);
- each latent's ``sample`` (the prior the session's generator draws) and
  ``geodesic`` (SO(3)'s exp map, the Gaussian's line, the quaternions'
  slerp on the shorter arc and its constant case) against the JAX
  session's poses.
"""
import argparse
import http.client
import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import test_torch_port_modes as modes_test
from lie_vae_tpu import serve as jserve
from lie_vae_tpu import serve_http as jserve_http
from lie_vae_tpu import ops as jops
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu.serve_client import ServingClient, ServingClientError
from lie_vae_tpu_torch import compat, ops, serve_http
from lie_vae_tpu_torch import serve as tserve
from lie_vae_tpu_torch.cli import main as cli_main
from lie_vae_tpu_torch.cli import serve as cli_serve
from lie_vae_tpu_torch.compat import state_dict_from_jax
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.train import make_optimizer
from lie_vae_tpu_torch.train.checkpoint import save_state
from test_torch_port_vmf import _recover_noise
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

CONFIGS = {"so3": dict(modes_test.TOY, mean_mode="s2s2"),
           "normal": dict(modes_test.TOY, latent_mode="normal"),
           "vmfq": dict(modes_test.TOY, latent_mode="vmfq")}
TOL = 1e-5


def _tree(flat, coll):
    return traverse_util.unflatten_dict(
        {k[len(coll) + 1:]: jnp.asarray(v) for k, v in flat.items()
         if k.startswith(coll + "/")}, sep="/")


def _start(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def stacks():
    """Per latent: the JAX and the port session over the same weights, and
    a running HTTP server over each."""
    out, servers = {}, []
    for mode, cfg in CONFIGS.items():
        flat = modes_test._flat_weights(JaxLieVAE(**cfg), seed=3)
        jsess = jserve.InferenceSession(
            JaxLieVAE(**cfg), _tree(flat, "params"), {}, batch_size=4, seed=1)
        model = LieVAE(device="cpu", **cfg)
        tsess = tserve.InferenceSession(model, state_dict_from_jax(
            flat, model), batch_size=4, seed=1, device="cpu")
        jsrv = jserve_http.make_server(jsess)
        tsrv = serve_http.make_server(tsess)
        servers += [jsrv, tsrv]
        out[mode] = dict(flat=flat, jsess=jsess, tsess=tsess,
                         jurl=_start(jsrv), turl=_start(tsrv))
    yield out
    for s in servers:
        s.shutdown()
        s.server_close()


def _x(n, seed):
    return np.random.default_rng(seed).random((n, 9, 3)).astype(np.float32)


def _post(url, route, arrays, fmt):
    """POST {name: array} as .npz or JSON; returns the decoded answer."""
    if fmt == "npz":
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        body, ctype = buf.getvalue(), "application/x-npz"
    else:
        body = json.dumps({k: np.asarray(v).tolist()
                           for k, v in arrays.items()}).encode()
        ctype = "application/json"
    req = urllib.request.Request(f"{url}/v1/{route}", data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        data, got_type = r.read(), r.headers.get("Content-Type")
    if fmt == "npz":
        assert got_type == "application/x-npz"
        with np.load(io.BytesIO(data)) as z:
            return {k: z[k] for k in z.files}
    assert got_type == "application/json"
    return {k: np.asarray(v, np.float32)
            for k, v in json.loads(data).items()}


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _handed_over_noise(mode, enc):
    """The noise under the JAX server's encode sample, for the port's
    session: so(3) algebra / sigma, (z - mu) / sigma, or vMF's pair."""
    pose, spread, sample = (np.asarray(enc[k], np.float64)
                            for k in ("pose", "sigma", "sample"))
    if mode == "so3":
        rel = torch.tensor(np.swapaxes(pose, -1, -2) @ sample)
        return (ops.vee(ops.logmap(rel)).numpy() / spread).astype(np.float32)
    if mode == "normal":
        return ((sample - pose) / spread).astype(np.float32)
    eps, tangent = _recover_noise(pose, spread, sample[None])
    return eps[0].astype(np.float32), tangent[0].astype(np.float32)


@pytest.mark.parametrize("fmt", ["npz", "json"])
@pytest.mark.parametrize("mode", list(CONFIGS))
def test_every_route_answers_as_the_jax_server(stacks, mode, fmt,
                                               monkeypatch):
    st = stacks[mode]
    x = _x(6, 0)                     # a full and a padded chunk
    want = _post(st["jurl"], "encode", {"images": x}, fmt)
    eps = _handed_over_noise(mode, want)
    encode = st["tsess"].encode
    monkeypatch.setattr(st["tsess"], "encode",
                        lambda images: encode(images, eps=eps))
    got = _post(st["turl"], "encode", {"images": x}, fmt)
    monkeypatch.undo()
    assert set(got) == set(want) == {"pose", "sigma", "sample"}
    for k in got:
        _close(got[k], want[k], f"encode {k}", 1e-4)
    poses = want["pose"]
    for route, req, key in (
            ("decode", {"poses": poses}, "images"),
            ("reconstruct", {"images": x}, "images"),
            ("geodesic", {"pose_a": poses[0], "pose_b": poses[3],
                          "steps": 5}, "frames")):
        _close(_post(st["turl"], route, req, fmt)[key],
               _post(st["jurl"], route, req, fmt)[key], route)
    # the prior: the JAX server's Haar poses decoded by the port's session,
    # and the port's server's draws decoded in process
    jz = {"so3": jops.random_group_matrices, "vmfq": jops.random_quaternions,
          "normal": lambda k, n: jax.random.normal(k, (n, 3))}[mode](
              jax.random.PRNGKey(9), 5)
    _close(st["tsess"].decode(np.asarray(jz)),
           _post(st["jurl"], "sample", {"n": 5, "seed": 9}, fmt)["images"],
           "sample")
    np.testing.assert_array_equal(
        _post(st["turl"], "sample", {"n": 5, "seed": 9}, fmt)["images"],
        st["tsess"].sample(5, seed=9))


def _raw(url, method, path, body=b"", headers=None):
    """(status, Content-Type, body) of one raw HTTP request."""
    host, port = url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    conn.putrequest(method, path)
    for k, v in (headers or {}).items():
        conn.putheader(k, v)
    if "Content-Length" not in (headers or {}):
        conn.putheader("Content-Length", str(len(body)))
    conn.endheaders()
    if body:
        conn.send(body)
    r = conn.getresponse()
    out = r.status, r.getheader("Content-Type"), r.read()
    conn.close()
    return out


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


@pytest.mark.parametrize("case", [
    ("POST", "/v1/nope", _npz(images=np.zeros((1, 9, 3))), {}, 400),
    ("POST", "/v1/decode", _npz(images=np.zeros((1, 9, 3))), {}, 400),
    ("POST", "/v1/encode", b"not a body", {"Content-Type": "text/plain"},
     400),
    ("POST", "/v1/encode", b"{]", {"Content-Type": "application/json"}, 400),
    ("POST", "/v1/sample", b'{"n": 0}',
     {"Content-Type": "application/json"}, 400),
    ("POST", "/v1/geodesic", _npz(pose_a=np.eye(3), pose_b=np.eye(3),
                                  steps=np.asarray(1)), {}, 400),
    ("POST", "/v1/encode", b"",
     {"Content-Length": str((1 << 30) + 1)}, 413),
    ("POST", "/encode", b"", {}, 404),
    ("GET", "/nope", b"", {}, 404)],
    ids=["route", "field", "type", "json", "n", "steps", "cap", "path",
         "get"])
def test_error_contract_is_the_jax_servers(stacks, case):
    method, path, body, headers, status = case
    st = stacks["so3"]
    got = _raw(st["turl"], method, path, body, headers)
    want = _raw(st["jurl"], method, path, body, headers)
    assert got[0] == want[0] == status
    assert got[1] == want[1] == "application/json"
    assert json.loads(got[2]) == json.loads(want[2])


def test_health_is_the_jax_servers(stacks):
    for mode, st in stacks.items():
        got = json.loads(_raw(st["turl"], "GET", "/healthz")[2])
        want = json.loads(_raw(st["jurl"], "GET", "/healthz")[2])
        assert got == want and got["latent_mode"] == mode


def test_jax_client_drives_the_port_server(stacks):
    st = stacks["so3"]
    client = ServingClient(st["turl"])
    tsess = st["tsess"]
    assert client.health()["routes"] == sorted(serve_http.ServingApp.ROUTES)
    x = _x(5, 1)
    enc = client.encode(x)
    assert enc["pose"].shape == enc["sample"].shape == (5, 3, 3)
    np.testing.assert_array_equal(client.decode(enc["pose"]),
                                  tsess.decode(enc["pose"]))
    np.testing.assert_array_equal(client.reconstruct(x),
                                  tsess.reconstruct(x))
    np.testing.assert_array_equal(client.sample(3, seed=2),
                                  tsess.sample(3, seed=2))
    np.testing.assert_array_equal(
        client.geodesic(enc["pose"][0], enc["pose"][1], steps=4),
        tsess.geodesic(enc["pose"][0], enc["pose"][1], steps=4))
    with pytest.raises(ServingClientError, match="missing field"):
        client._post("decode", {"images": x})


def test_concurrent_requests_run_one_at_a_time(stacks, monkeypatch):
    st = stacks["so3"]
    tsess = st["tsess"]
    poses = [ops.random_group_matrices(
        3, torch.Generator().manual_seed(i), device="cpu").numpy()
        for i in range(8)]
    want = [tsess.decode(p) for p in poses]
    inside, most = [0], [0]
    decode = tsess.decode

    def probe(p):
        inside[0] += 1
        most[0] = max(most[0], inside[0])
        time.sleep(0.01)
        try:
            return decode(p)
        finally:
            inside[0] -= 1

    monkeypatch.setattr(tsess, "decode", probe)
    got = [None] * len(poses)

    def worker(i):
        got[i] = ServingClient(st["turl"]).decode(poses[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(poses))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "a client's request did not finish"
    assert most[0] == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_npz_artifacts_round_trip_both_ways(stacks, tmp_path):
    """A port checkpoint -> export_npz -> the JAX package's load_npz and
    session; a reference state_dict -> the JAX package's
    export_npz_from_torch -> the port's session."""
    st = stacks["vmfq"]
    cfg = CONFIGS["vmfq"]
    model = LieVAE(device="cpu", **cfg)
    model.load_state_dict(st["tsess"].model.state_dict())
    opt = make_optimizer(model.named_parameters())
    opt.count = 7
    save_state(tmp_path / "checkpoint.pt", model, opt)
    art = tserve.export_npz(tmp_path / "checkpoint.pt",
                            str(tmp_path / "artifact.npz"), model)
    params, stats, step = jserve.load_npz(art)
    assert step == 7 and not stats
    jsess = jserve.InferenceSession(JaxLieVAE(**cfg), params, stats,
                                    batch_size=4)
    poses = ops.random_quaternions(
        6, torch.Generator().manual_seed(3), device="cpu").numpy()
    _close(jsess.decode(poses), st["tsess"].decode(poses), "JAX from port")

    ref = compat.save_torch(tmp_path / "ref.pt", model.state_dict())
    state = torch.load(ref, weights_only=True)
    assert any(k.startswith("rep_group.") for k in state)
    jart = jserve.export_npz_from_torch(str(ref), JaxLieVAE(**cfg),
                                        str(tmp_path / "from_torch.npz"))
    sess = tserve.InferenceSession.from_npz(jart, LieVAE(device="cpu", **cfg),
                                            batch_size=4, device="cpu")
    np.testing.assert_array_equal(sess.decode(poses),
                                  st["tsess"].decode(poses))
    port_art = tserve.export_npz_from_torch(
        ref, model, str(tmp_path / "port_from_torch.npz"))
    with np.load(port_art) as a, np.load(jart) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------------ CLI

_FLAGS = ["--device", "cpu", "--degrees", "2", "--rep_copies", "3",
          "--latent_mode", "vmfq"]


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """A port checkpoint of the CLI's toy model with ``_FLAGS``."""
    monkeypatch.chdir(tmp_path)
    torch.manual_seed(0)
    model = cli_serve._build_model(cli_main.parse_args(_FLAGS))
    opt = make_optimizer(model.named_parameters())
    save_state(tmp_path / "out" / "checkpoint.pt", model, opt)
    return tmp_path, model


def test_cli_export_sample_trajectory_bench(run_dir, capsys):
    tmp, model = run_dir
    ckpt = str(tmp / "out" / "checkpoint.pt")
    art = cli_serve.main(["export", "--checkpoint", ckpt] + _FLAGS)
    assert art == str(tmp / "out" / "artifact.npz")
    params, _, step = jserve.load_npz(art)
    assert step == 0 and "rep_group" in params
    ref = cli_serve.main(["export", "--checkpoint", ckpt, "--to_torch",
                          "ref.pt"] + _FLAGS)
    back = cli_serve.main(["export", "--torch", ref, "--out", "back.npz"]
                          + _FLAGS)
    with np.load(art) as a, np.load(back) as b:
        assert [k for k in a.files if k != "__step__"] == [
            k for k in b.files if k != "__step__"]
        for k in a.files:
            if k != "__step__":
                np.testing.assert_array_equal(a[k], b[k])

    sess = tserve.InferenceSession(model, model.state_dict(), batch_size=64,
                                   device="cpu")
    out = cli_serve.main(["sample", "--artifact", art, "-n", "5", "--seed",
                          "3", "--out", "s.npz"] + _FLAGS)
    with np.load(out) as z:
        np.testing.assert_array_equal(z["images"], sess.sample(5, seed=3))
    out = cli_serve.main(["trajectory", "--checkpoint", ckpt, "--steps", "4",
                          "--seed", "2", "--out", "t.npz"] + _FLAGS)
    with np.load(out) as z:
        assert z["frames"].shape == (4, 9, 3)
        a, b = ops.random_quaternions(
            2, torch.Generator().manual_seed(2), device="cpu").numpy()
        np.testing.assert_array_equal(z["pose_a"], a)
        np.testing.assert_array_equal(z["frames"],
                                      sess.geodesic(a, b, steps=4))
    capsys.readouterr()
    res = cli_serve.main(["bench", "--checkpoint", ckpt, "--iters", "2",
                          "--stream_chunks", "2", "--batch_size", "4"]
                         + _FLAGS)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and res["device"] == "cpu"
    assert res["encode"]["ms_per_batch"] > 0
    assert "device_ms_per_batch" not in res["encode"]     # no card


@pytest.mark.parametrize("command", ["sample", "trajectory", "encode"])
def test_cli_serve_over_two_data_devices(run_dir, command):
    """--data_devices 2 --device cpu: two CPU replicas, each chunk split in
    halves, answer as one device does."""
    tmp, model = run_dir
    ckpt = str(tmp / "out" / "checkpoint.pt")
    one = tserve.InferenceSession(model, model.state_dict(), batch_size=8,
                                  device="cpu", seed=3)
    if command == "encode":
        from lie_vae_tpu_torch.parallel import make_mesh
        two = cli_serve._session(argparse.Namespace(
            aot=None, artifact=None, torch=None, checkpoint=ckpt,
            batch_size=8, seed=3, data_devices=2), _FLAGS)
        assert two.mesh.shape == make_mesh(2, devices=["cpu"] * 2).shape
        x = _x(11, 5)
        got, want = two.encode(x), one.encode(x)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        return
    argv = [command, "--checkpoint", ckpt, "--seed", "3", "--batch_size",
            "8", "--data_devices", "2", "--out", "o.npz"] + _FLAGS
    out = cli_serve.main(argv + (["-n", "5"] if command == "sample"
                                 else ["--steps", "4"]))
    with np.load(out) as z:
        if command == "sample":
            np.testing.assert_allclose(z["images"], one.sample(5, seed=3),
                                       rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(
                z["frames"], one.geodesic(z["pose_a"], z["pose_b"], steps=4),
                rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("argv", [
    ["sample", "--data_devices", "2", "--checkpoint", "out/checkpoint.pt"],
    ["export", "--aot_data_devices", "2", "--checkpoint",
     "out/checkpoint.pt"],
    ["sample", "--data_devices", "3", "--checkpoint", "out/checkpoint.pt",
     "--batch_size", "8"]])
def test_cli_serve_data_devices_it_cannot_have_raise(run_dir, monkeypatch,
                                                     argv):
    """Two cards asked of a machine with one: the counts named, no quiet
    replay on fewer; --aot_data_devices without --aot; a batch the devices
    do not divide."""
    flags = list(_FLAGS)
    if argv[1] == "--data_devices" and argv[2] == "2":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        flags[1] = "cuda"
        match = "2 data devices needs 2 cards, this machine has 1 card"
    elif argv[0] == "export":
        match = "an --aot flag"
    else:
        match = "multiple of the mesh's data size 3"
    with pytest.raises((SystemExit, ValueError), match=match):
        cli_serve.main(argv + flags)


def test_cli_serve_runs_on_the_card_unless_asked(run_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli_serve.main(["sample", "--checkpoint", "out/checkpoint.pt",
                        "--degrees", "2", "--rep_copies", "3"])


# ------------------------------------------------- sample and geodesic

@pytest.mark.parametrize("mode", list(CONFIGS))
def test_sample_draws_the_prior_of_each_latent(stacks, mode):
    tsess = stacks[mode]["tsess"]
    gen = torch.Generator().manual_seed(4)
    z = {"so3": lambda: ops.random_group_matrices(4, gen, device="cpu"),
         "vmfq": lambda: ops.random_quaternions(4, gen, device="cpu"),
         "normal": lambda: torch.randn((4, 3), generator=gen)}[mode]()
    np.testing.assert_array_equal(tsess.sample(4, seed=4),
                                  tsess.decode(z.numpy()))


@pytest.mark.parametrize("case", ["so3", "normal", "vmfq", "vmfq_far",
                                  "vmfq_same"])
def test_geodesic_poses_match_jax(stacks, case):
    mode = case.split("_")[0]
    st = stacks[mode]
    gen = torch.Generator().manual_seed(5)
    if mode == "so3":
        a, b = ops.random_group_matrices(2, gen, device="cpu").numpy()
    elif mode == "normal":
        a, b = torch.randn((2, 3), generator=gen).numpy()
    else:
        a = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
        b = {"vmfq": np.array([0.9, 0.1, 0.3, 0.3], np.float32),
             # a . b < 0: the shorter arc runs to -b
             "vmfq_far": np.array([-0.6, -0.2, -0.7, 0.1], np.float32),
             # omega below 1e-6: every pose is a
             "vmfq_same": a * 2.0}[case]
    got = st["tsess"].geodesic(a, b, steps=6, decode=False)
    want = st["jsess"].geodesic(a, b, steps=6, decode=False)
    _close(got, want, case, 1e-6)
    if mode == "vmfq":
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-6)
        assert (got @ got[0] > 0).all()          # one hemisphere: shorter
    if case == "vmfq_same":
        np.testing.assert_array_equal(got, np.repeat(a[None], 6, 0))
    _close(st["tsess"].geodesic(a, b, steps=6),
           st["jsess"].geodesic(a, b, steps=6), f"{case} decoded")
