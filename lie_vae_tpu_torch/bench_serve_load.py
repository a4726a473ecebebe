"""Concurrent-client load test of the port's HTTP serving front end.

    python -m lie_vae_tpu_torch.bench_serve_load [--aot artifact_aot.npz]
        [--clients 1 2 4] [--duration 8] [--req_batch 64] [--out rows.json]

The port's copy of the JAX package's ``scripts/bench_serve_load.py``: the
real ``serve_http`` stack (``ThreadingHTTPServer``, ``.npz`` bodies) in a
thread of this process, over an ``InferenceSession`` of the flagship
(``models.flagship_model``, the converged weights of
``converged_state/torch_clean/best.pt`` unless ``--torch`` names another
state_dict) or, with ``--aot``, over the graphed ``AotSession`` of an
``export --aot`` artifact. N client threads post one request of
``--req_batch`` images to each route in ``--routes`` in a loop for
``--duration`` seconds. Per route and client count it prints one JSON row:
requests/s, images/s, p50/p95 latency of a whole request (serialise, HTTP
over loopback, the padded session call, the answer), and the requests
counted. It writes nothing unless ``--out`` names a JSON file for the rows.
"""
import argparse
import io
import json
import os
import statistics
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "converged_state", "torch_clean", "best.pt")


def build_session(args):
    """The session the server fronts: an AotSession of ``--aot``, else the
    flagship from ``--torch``."""
    from lie_vae_tpu_torch.models import flagship_model
    from lie_vae_tpu_torch.serve import AotSession, InferenceSession
    if args.aot:
        return AotSession(args.aot, device=args.device)
    return InferenceSession.from_torch(args.torch, flagship_model(
        args.device), batch_size=args.batch_size, device=args.device)


def _post_npz(base, route, body):
    req = urllib.request.Request(
        f"{base}/v1/{route}", data=body,
        headers={"Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=120) as r:
        r.read()


def run_window(base, route, body, n_clients, duration):
    """N client threads loop the request for ``duration`` s; returns
    (requests/s, p50 ms, p95 ms, requests)."""
    latencies, stop = [], threading.Event()
    lock = threading.Lock()

    def client():
        local = []
        while not stop.is_set():
            t0 = time.perf_counter()
            _post_npz(base, route, body)
            local.append(time.perf_counter() - t0)
        with lock:
            latencies.extend(local)

    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(duration)
    stop.set()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise RuntimeError("a client did not finish its request "
                               "within 300 s")
    wall = time.perf_counter() - t0
    lat_ms = sorted(x * 1e3 for x in latencies)
    p50 = statistics.median(lat_ms)
    p95 = lat_ms[int(0.95 * (len(lat_ms) - 1))]
    return len(lat_ms) / wall, p50, p95, len(lat_ms)


def run(sess, clients=(1, 2, 4), routes=("encode", "reconstruct"),
        duration=8.0, req_batch=64):
    """The load test over ``sess`` behind a server on an ephemeral port;
    returns the rows. The server is shut down and closed after it."""
    from lie_vae_tpu_torch import serve_http
    srv = serve_http.make_server(sess, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    rows = []
    try:
        x = np.random.default_rng(0).random(
            (req_batch,) + tuple(sess.model.out_shape), np.float32)
        buf = io.BytesIO()
        np.savez(buf, images=x)
        body = buf.getvalue()
        for route in routes:              # warm each route's path
            _post_npz(base, route, body)
            _post_npz(base, route, body)
        for route in routes:
            for n in clients:
                rps, p50, p95, count = run_window(base, route, body, n,
                                                  duration)
                row = {"route": route, "clients": n, "req_s": rps,
                       "images_s": rps * req_batch, "p50_ms": p50,
                       "p95_ms": p95, "requests": count}
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--clients", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--routes", nargs="+", default=["encode", "reconstruct"])
    p.add_argument("--duration", type=float, default=8.0)
    p.add_argument("--req_batch", type=int, default=64,
                   help="images per request")
    p.add_argument("--batch_size", type=int, default=64,
                   help="the session's fixed batch (an --aot artifact "
                        "carries its own)")
    p.add_argument("--aot", default=None,
                   help="serve this export --aot artifact's graphed "
                        "session")
    p.add_argument("--torch", default=CHECKPOINT,
                   help="the flagship's reference state_dict to serve")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write the rows here (JSON)")
    args = p.parse_args(argv)
    from lie_vae_tpu_torch.precision import ieee_float32
    with ieee_float32():
        sess = build_session(args)
        sess.warmup()
    rows = run(sess, args.clients, args.routes, args.duration,
               args.req_batch)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"session": type(sess).__name__,
                       "req_batch": args.req_batch, "rows": rows}, f)
    return rows


if __name__ == "__main__":
    main()
