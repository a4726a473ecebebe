"""HTTP front end over :class:`lie_vae_tpu_torch.serve.InferenceSession`.

Counterpart of the JAX package's ``serve_http.py``, with its wire format
and error contract, so its numpy + urllib client (``serve_client.py``)
talks to this server unchanged:

- stdlib only (``http.server``), a thread per connection;
- two body formats, chosen by the request's Content-Type: ``.npz`` (numpy's
  zip of arrays) for programs, JSON (nested lists) for curl;
  a response comes in the request's format;
- device work is serialised behind one lock (one card, one session; the
  session's chunking still runs a large request at the fixed batch);
- a request of any size is padded to the session's fixed batch, so no new
  shape reaches the card;
- errors are JSON ``{"error": message}``: 400 for a bad route, field or
  body, 404 for an unknown path, 413 for a body above 1 GiB, 500 for a
  fault of the server.

Endpoints (POST unless noted)::

  GET  /healthz         liveness and model metadata
  POST /v1/encode       {images}                  -> {pose, sigma, sample}
  POST /v1/decode       {poses}                   -> {images}
  POST /v1/reconstruct  {images}                  -> {images}
  POST /v1/sample       {n, seed?}                -> {images}
  POST /v1/geodesic     {pose_a, pose_b, steps?}  -> {frames}

Start it with ``python -m lie_vae_tpu_torch.cli.serve http --checkpoint
<checkpoint.pt> <model flags> --port 8310``, or embed :class:`ServingApp`
and :func:`make_server` in another process.
"""
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

# 1 GiB: a request of 4096 float32 64x64 RGB images is 201 MB
MAX_BODY = 1 << 30


class ServingError(ValueError):
    """A client error (HTTP 400): bad route, missing field, bad body."""


class ServingApp:
    """The route table over one session. Thread-safe: concurrent HTTP
    workers serialise device work behind one lock (the session's generator
    and the card are shared)."""

    def __init__(self, session):
        self.session = session
        self._lock = threading.Lock()

    # every handler: dict of numpy arrays / scalars -> dict of numpy arrays
    def _encode(self, req):
        out = self.session.encode(_require(req, "images"))
        return {"pose": out["pose"], "sigma": out["sigma"],
                "sample": out["sample"]}

    def _decode(self, req):
        return {"images": self.session.decode(_require(req, "poses"))}

    def _reconstruct(self, req):
        return {"images": self.session.reconstruct(_require(req, "images"))}

    def _sample(self, req):
        n = int(np.asarray(req.get("n", 16)))
        if not 1 <= n <= 65536:
            raise ServingError(f"n={n} out of range [1, 65536]")
        seed = req.get("seed")
        seed = int(np.asarray(seed)) if seed is not None else None
        return {"images": self.session.sample(n, seed=seed)}

    def _geodesic(self, req):
        steps = int(np.asarray(req.get("steps", 16)))
        if not 2 <= steps <= 4096:
            raise ServingError(f"steps={steps} out of range [2, 4096]")
        return {"frames": self.session.geodesic(
            _require(req, "pose_a"), _require(req, "pose_b"), steps=steps)}

    ROUTES = {"encode": _encode, "decode": _decode,
              "reconstruct": _reconstruct, "sample": _sample,
              "geodesic": _geodesic}

    def handle(self, route, req):
        fn = self.ROUTES.get(route)
        if fn is None:
            raise ServingError(
                f"unknown route {route!r}; have {sorted(self.ROUTES)}")
        with self._lock:
            return fn(self, req)

    def health(self):
        m = self.session.model
        return {"status": "ok", "latent_mode": m.latent_mode,
                "out_shape": list(m.out_shape),
                "batch_size": self.session.batch_size,
                "routes": sorted(self.ROUTES)}


def _require(req, key):
    if key not in req:
        raise ServingError(f"missing field {key!r} (have {sorted(req)})")
    return np.asarray(req[key])


def _parse_body(content_type, body):
    """An ``.npz`` or JSON body -> ({name: numpy array or scalar}, format)."""
    if "json" in (content_type or ""):
        try:
            obj = json.loads(body.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ServingError(f"bad JSON body: {e}")
        if not isinstance(obj, dict):
            raise ServingError("JSON body must be an object")
        return {k: (np.asarray(v, np.float32) if isinstance(v, list) else v)
                for k, v in obj.items()}, "json"
    try:
        with np.load(io.BytesIO(body)) as z:
            return {k: z[k] for k in z.files}, "npz"
    except Exception as e:
        raise ServingError(
            f"body is neither .npz nor JSON (Content-Type "
            f"{content_type!r}): {e}")


def _pack_response(out, fmt):
    """({name: array}, format) -> (body bytes, Content-Type)."""
    if fmt == "json":
        payload = {k: np.asarray(v).tolist() for k, v in out.items()}
        return json.dumps(payload).encode(), "application/json"
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in out.items()})
    return buf.getvalue(), "application/x-npz"


def _make_handler(app):
    class Handler(BaseHTTPRequestHandler):
        # no line per request: errors reach the client in the response
        def log_message(self, fmt, *args):
            pass

        def _reply(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_error(self, code, message):
            self._reply(code, json.dumps({"error": message}).encode(),
                        "application/json")

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/healthz"):
                self._reply(200, json.dumps(app.health()).encode(),
                            "application/json")
            else:
                self._reply_error(404, f"unknown path {self.path!r}")

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY:
                    return self._reply_error(
                        413, f"body {length} B exceeds {MAX_BODY} B")
                body = self.rfile.read(length)
                if not self.path.startswith("/v1/"):
                    return self._reply_error(
                        404, f"unknown path {self.path!r} (use /v1/<route>)")
                route = self.path[len("/v1/"):].strip("/")
                req, fmt = _parse_body(self.headers.get("Content-Type"),
                                       body)
                out = app.handle(route, req)
                self._reply(200, *_pack_response(out, fmt))
            except ServingError as e:
                self._reply_error(400, str(e))
            except BrokenPipeError:
                pass                      # the client went away
            except Exception as e:        # noqa: BLE001: a serving loop
                self._reply_error(500, f"{type(e).__name__}: {e}")

    return Handler


def make_server(session, host="127.0.0.1", port=0):
    """A threaded HTTP server over ``session``, built but not started; its
    bound port is ``server.server_address[1]`` (useful with ``port=0``),
    its app ``server.app``. Call ``serve_forever()`` or drive it from a
    thread, and ``shutdown()`` / ``server_close()`` to stop it."""
    app = ServingApp(session)
    server = ThreadingHTTPServer((host, port), _make_handler(app))
    server.app = app
    return server


def serve(session, host="127.0.0.1", port=8310, warmup=True):
    """Warm the session, print the bound address and serve until
    interrupted."""
    if warmup:
        session.warmup()
    server = make_server(session, host=host, port=port)
    bound = server.server_address
    print(f"serving on http://{bound[0]}:{bound[1]} "
          f"(batch_size={session.batch_size}, "
          f"latent_mode={session.model.latent_mode})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return server
