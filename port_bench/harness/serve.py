"""The serving traffic's runner: the program's graphed session
(``serve.AotSession``), built as a service builds it (``serve.
export_aot_from_torch`` of the configuration's ``serve_weights`` at the
traffic's batch, into ``TMPDIR``), called with numpy uint8 images and
answering numpy float32 images.

Traffic parameters (``traffic/<name>.json``, ``kind`` "serve"):
``surface`` (the session's method: "reconstruct"), ``images_per_request``
and ``artifact_batch``, ``pool_images`` (the renders requests draw from)
and ``distinct_requests`` (request arrays built in set-up, each
``images_per_request`` images drawn from the pool by the seed, the array
of each arrival drawn by the seed too), ``arrivals`` ("poisson" or
"uniform" at ``rate_per_s``, or "closed": one client sending its next
request when the last is answered), ``arrival_seed`` (the Poisson gaps are
the traffic's own, the same for every run seed), ``window_closes``
("answered": every request due inside ``--seconds`` is answered before
the window closes, for a load below the knee; "at_seconds": no request
starts after ``--seconds``, for a load above it, whose queue grows all
through the window), ``sample_requests`` (how many answered requests the
comparison samples) and ``trace_requests``.

The loop is one server: a request due while the last is being answered
waits for it, and its latency counts from when it was due.
"""
import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from port_bench.harness import check, inputs, trace as tracing


def arrival_times(traffic, count):
    """``count`` arrival offsets (s) from the start of the window."""
    kind = traffic["arrivals"]
    if kind == "closed":
        return None
    rate = traffic["rate_per_s"]
    if kind == "uniform":
        return np.arange(count) / rate
    if kind == "poisson":
        gaps = np.random.default_rng(traffic["arrival_seed"]).exponential(
            1.0 / rate, count)
        return np.concatenate([[0.0], np.cumsum(gaps[1:])])
    raise ValueError(f"unknown arrivals {kind!r}")


def replay_segments(trace):
    """The number of kernels between each host-to-device copy and the
    device-to-host copy after it: one count a request."""
    counts, open_ = [], None
    for name, _, _, kind in trace.device:
        if kind == "copy" and "HtoD" in name:
            open_ = 0
        elif kind == "kernel" and open_ is not None:
            open_ += 1
        elif kind == "copy" and "DtoH" in name and open_ is not None:
            counts.append(open_)
            open_ = None
    return counts


class ServeRun:
    def __init__(self, root, config, traffic, seed, device, workers=None):
        from lie_vae_tpu_torch.models import LieVAE
        from lie_vae_tpu_torch.serve import AotSession, export_aot_from_torch
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        t = time.perf_counter()
        self.workers = workers
        self._at_seconds = traffic.get("window_closes") == "at_seconds"
        self.load_requests(seed)
        self.seconds = {"render": time.perf_counter() - t}
        t = time.perf_counter()
        self.weights = os.path.join(root, config["serve_weights"])
        self.tmp = tempfile.mkdtemp(prefix="port_bench_")
        path = os.path.join(self.tmp, "artifact_aot.npz")
        export_aot_from_torch(self.weights,
                              LieVAE(**config["model"], device="cpu"), path,
                              batch_size=traffic["artifact_batch"])
        self.session = AotSession(path, device=device)
        self.seconds["export_and_capture"] = time.perf_counter() - t
        t = time.perf_counter()
        self.call = getattr(self.session, traffic["surface"])
        for req in self.requests[:2]:
            self.call(req)
        self.seconds["warm_requests"] = time.perf_counter() - t

    def load_requests(self, seed):
        """The seed's pool and request arrays, and its streams of which
        array each arrival takes and of the sample."""
        data, traffic = self.config["data"], self.traffic
        _, images = inputs.render_pool(seed, traffic["pool_images"], 1,
                                       data["image_size"], data["style"],
                                       self.workers)
        pool = images[:, 0]
        self.rng = inputs.stream(seed, inputs.REQUESTS)
        n = traffic["images_per_request"]
        self.requests = [pool[self.rng.choice(len(pool), n, replace=False)]
                         for _ in range(traffic["distinct_requests"])]
        self.sample = []
        self._seen = 0
        self._sample_rng = inputs.stream(seed, inputs.SAMPLE)

    def _keep(self, req, out):
        """A reservoir of ``sample_requests`` answered requests, drawn by
        the seed among all the window's."""
        k = self.traffic["sample_requests"]
        self._seen += 1
        if len(self.sample) < k:
            self.sample.append((req, out))
            return
        j = int(self._sample_rng.integers(self._seen))
        if j < k:
            self.sample[j] = (req, out)

    def _loop(self, seconds=None, count=None, spans=False):
        """Serve until the next arrival is ``seconds`` past the start (or
        ``count`` requests): (window s, latencies s, service s)."""
        est = int((seconds or 0) * self.traffic.get("rate_per_s", 1000)
                  * 1.5) + (count or 0) + 64
        due_at = arrival_times(self.traffic, est)
        which = self.rng.integers(len(self.requests), size=est)
        lat, service = [], []
        t0 = finish = time.perf_counter()
        for i in range(est):
            due = finish if due_at is None else t0 + due_at[i]
            if count is not None and i == count:
                break
            if seconds is not None and (
                    due - t0 >= seconds or self._at_seconds
                    and time.perf_counter() - t0 >= seconds):
                break
            now = time.perf_counter()
            if now < due:
                wait = tracing.Span("arrival") if spans else None
                time.sleep(due - now)
                if wait:
                    wait.close()
            start = time.perf_counter()
            span = tracing.Span("request") if spans else None
            out = self.call(self.requests[which[i]])
            if span:
                span.close()
            finish = time.perf_counter()
            lat.append(finish - due)
            service.append(finish - start)
            if not spans:
                self._keep(int(which[i]), out)
        return finish - t0, lat, service

    def window(self, seconds):
        return self._loop(seconds=seconds)

    def traced(self, attempts=3):
        """``trace_requests`` requests under the profiler; traced again
        (``attempts`` at most) while a request's graph replay left no
        kernels, or under half of another's, in the trace."""
        n = self.traffic["trace_requests"]
        for _ in range(attempts):
            torch.cuda.synchronize()
            with tracing.profiler() as prof:
                win = tracing.Span("window")
                self._loop(count=n, spans=True)
                torch.cuda.synchronize()
                win.close()
            tr = tracing.Trace(prof)
            segs = replay_segments(tr)
            if len(segs) >= n and min(segs) > 0 \
                    and 2 * min(segs) >= max(segs):
                return tr, n, True
        return tr, n, False

    def free(self):
        self.session.close()
        self.session = self.call = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def reference(self, module, mode="ieee"):
        """The reference's answers to the sampled requests, its float32 in
        ``mode``."""
        weights = module.load_checkpoint(self.weights, self.device)
        outs = []
        with module.precision(mode):
            for req, _ in self.sample:
                x = torch.as_tensor(self.requests[req], device=self.device)
                outs.append(module.reconstruct(weights, x,
                                               self.config["model"])
                            .cpu().numpy())
        return outs


def run(bench, cell, seed, seconds, trace, device="cuda", workers=None):
    """One run of a serving cell: (result fields, context, numbers)."""
    from port_bench.harness import record
    started = record.process_age_s()
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    r = ServeRun(bench.root, config, traffic, seed, device, workers)
    try:
        if r.device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = record.process_age_s()
        window_s, lat, service = r.window(seconds)
        memory = (torch.cuda.max_memory_allocated()
                  if r.device.type == "cuda" else 0)
        n = traffic["images_per_request"]
        ctx = record.Context(kind="serve", cell=cell, config=config,
                             traffic=traffic, setup_s=setup_s,
                             window_s=window_s, requests=len(lat),
                             images=len(lat) * n, latencies_s=lat,
                             service_s=service, rows=n)
        if trace:
            ctx.trace, ctx.traced_requests, ctx.trace_complete = r.traced()
    finally:
        r.free()
    refs = r.reference(bench.reference(config["reference"]))
    numbers = check.serve_numbers([o for _, o in r.sample], refs)
    fields = {"attempted": len(lat), "failed": 0, "memory": memory,
              "setup_phases": dict(to_runner=started, **r.seconds)}
    return fields, ctx, numbers
