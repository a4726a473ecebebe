"""The training traffic's runner: one ``UnsupervisedExperiment`` of the
program, the users' entry, trained over the benchmark's pool held in the
harness's device cache, with the noise and the regularizers' schedules of
the harness in every step.

Traffic parameters (``traffic/<name>.json``, ``kind`` "train"):
``images_per_step`` (the batch, counted in images; a pair is two),
``pool_images`` (the pool the epochs shuffle over), ``setup_steps`` (the
steps set-up drives, which the reference follows), ``trace_steps`` (the
steps of the traced window).

Set-up renders the pool, builds the model from the configuration's
``model`` keywords, loads the benchmark's seeded weights, builds the
experiment and drives its first ``setup_steps`` steps through
``train()`` itself, keeping each step's loss, the Adam state after the
first and the parameters after the last. The window then calls
``train()`` epoch after epoch, reporting nothing, from a synchronize
before the first step to one after the last epoch that ends past
``--seconds``.
"""
import gc
import math
import time

import numpy as np
import torch

from port_bench.harness import check, inputs, trace as tracing


def schedule_weight(spec, step):
    """A regularizer's weight at a global step: the configuration's linear
    ramp from 0 at ``start_step`` to ``weight`` at ``end_step``, clamped."""
    if spec is None:
        return None
    lo, hi, w = spec["start_step"], spec["end_step"], spec["weight"]
    return float(np.clip((step - lo) * w / (hi - lo), min(0, w), max(0, w)))


def readings(out, init):
    """The reference's readings from ``train_steps``' output: the losses,
    the first step's KL, the first gradients and the change from
    ``init``."""
    return {"losses": out["losses"], "kl1": out["parts"][0]["kl"],
            "grads": out["grads"],
            "change": {k: v - init[k] for k, v in out["params"].items()},
            "parts": out["parts"]}


class TrainRun:
    def __init__(self, config, traffic, seed, device, workers=None):
        from lie_vae_tpu_torch.models import LieVAE
        from lie_vae_tpu_torch.train import (LinearSchedule,
                                             UnsupervisedExperiment,
                                             get_beta_schedule)
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.phases = {"imports": time.perf_counter()}
        data, train = config["data"], config["train"]
        self.per_item = data["images_per_item"]
        self.rows = traffic["images_per_step"]
        items = self.rows // self.per_item
        self.poses, self.images = inputs.render_pool(
            seed, traffic["pool_images"] // self.per_item, self.per_item,
            data["image_size"], data["style"], workers)
        self._phase("render")
        self.model = LieVAE(**config["model"], device=self.device)
        shapes = {k: (v.shape, v.dtype)
                  for k, v in self.model.state_dict().items()}
        self.init = inputs.make_weights(shapes, seed, self.device)
        self.model.load_state_dict(self.init, strict=True)
        self.noise = inputs.Noise(seed)

        def ramp(spec):
            return None if spec is None else LinearSchedule(
                0, spec["weight"], spec["start_step"], spec["end_step"])

        dataset = inputs.PoolDataset(self.poses, self.images)
        self.exp = UnsupervisedExperiment(
            model=self.model, train_dataset=dataset, test_dataset=dataset,
            beta_schedule=get_beta_schedule(None, train["beta"]),
            lr=train["lr"], weight_decay=train["weight_decay"],
            elbo_samples=train["elbo_samples"], report_freq=None,
            clip_grads=train["clip_grads"], batch_size=items,
            equivariance_lamb=ramp(train["equivariance"]),
            encoder_continuity_lamb=ramp(train["encoder_continuity"]),
            equivariance_rotate=train["equivariance_rotate"],
            seed=seed, device_data=True, noise=self.noise)
        self.steps_per_epoch = len(self.exp.train_loader)
        self.epoch = train["start_step"] // self.steps_per_epoch
        self.start_epoch = self.epoch
        self._phase("model")

    def _phase(self, name):
        """Seconds of set-up's phases, for its lines on standard error."""
        now = time.perf_counter()
        last = max(self.phases.values())
        self.phases[name] = now
        self.seconds = getattr(self, "seconds", {})
        self.seconds[name] = now - last

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def first_steps(self):
        """Drive the first ``setup_steps`` steps through ``train()``;
        returns the program's readings for the comparison (the Adam state
        and the KL are the program's own: ``optimizer.mu``, the step's
        ``kl`` metric)."""
        n = self.traffic["setup_steps"]
        losses, kept = [], {}
        opt = self.exp.optimizer

        def on_step(metrics):
            losses.append(metrics["loss"])
            if len(losses) == 1:
                kept["kl1"] = metrics["kl"]
                kept["mu"] = [m.detach().clone() for m in opt.mu]
            if len(losses) == n:
                kept["params"] = {k: p.detach().clone() for k, p in
                                  self.model.named_parameters()}

        self.exp.train(self.epoch, max_steps=n, on_step=on_step)
        self.epoch += 1
        self.noise.keep = False
        self._sync()
        self._phase("first_steps")
        b1 = self.config["train"]["adam_b1"]
        return {"losses": [float(v) for v in losses],
                "kl1": float(kept["kl1"]),
                "grads": {k: m / (1 - b1) for k, m in zip(opt.names,
                                                          kept["mu"])},
                "change": {k: p - self.init[k]
                           for k, p in kept["params"].items()}}

    def window(self, seconds):
        """Epochs of ``train()`` until ``seconds`` have passed: (host
        seconds from a synchronize before to one after, steps)."""
        self._sync()
        t0 = time.perf_counter()
        steps = 0
        while True:
            self.exp.train(self.epoch)
            self.epoch += 1
            steps += self.steps_per_epoch
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        return time.perf_counter() - t0, steps

    def traced(self):
        """``trace_steps`` steps under the profiler, each in a ``step``
        span, inside a ``window`` span opened and closed on an idle card."""
        n = self.traffic["trace_steps"]
        self._sync()
        with tracing.profiler() as prof:
            win = tracing.Span("window")
            span = [tracing.Span("step")]

            def on_step(_):
                span[0].close()
                span[0] = tracing.Span("step")

            done = 0
            while done < n:
                self.exp.train(self.epoch, max_steps=n - done,
                               on_step=on_step)
                done += min(n - done, self.steps_per_epoch)
                self.epoch += 1
            self._sync()
            span[0].close()
            win.close()
        return tracing.Trace(prof), n

    def free(self):
        """Drop the program's state (its model, optimizer and device
        cache) before the reference runs."""
        self.exp = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_inputs(self):
        """The first steps' batches and inputs as the reference takes
        them, worked out again: the loader's first shuffled epoch
        (``numpy.random.default_rng(seed)``'s permutation of the items, in
        consecutive slices), the noise the benchmark handed the program,
        in the order the harness asks for it (the posterior's, then the
        second encoder pass's), the rotation angles of the harness's
        training stream (a CPU torch Generator seeded from
        ``SeedSequence([seed, 0])``, uniform times 2 pi), and the
        regularizers' weights at each global step."""
        n = self.traffic["setup_steps"]
        items = self.rows // self.per_item
        order = np.random.default_rng(self.seed).permutation(
            len(self.images))
        train = self.config["train"]
        eq = train["equivariance"]
        gen = torch.Generator().manual_seed(int(
            np.random.SeedSequence([self.seed, 0]).generate_state(1)[0]))
        per_step = 2 if eq is not None else 1
        batches, steps = [], []
        for j in range(n):
            idx = order[j * items:(j + 1) * items]
            x = self.images[idx].reshape((-1,) + self.images.shape[2:])
            batches.append(torch.as_tensor(x, device=self.device))
            global_step = self.start_epoch * self.steps_per_epoch + j + 1
            step = {"eps": self.noise.kept[per_step * j].to(self.device),
                    "equivariance": schedule_weight(eq, global_step),
                    "encoder_continuity": schedule_weight(
                        train["encoder_continuity"], global_step)}
            if eq is not None:
                theta = torch.rand((self.rows,), generator=gen) \
                    * (2.0 * math.pi)
                step["theta"] = theta.to(self.device)
                step["eq_eps"] = self.noise.kept[per_step * j + 1].to(
                    self.device)
            steps.append(step)
        return batches, steps

    def reference(self, module, mode="ieee"):
        """The reference's readings over the same first steps, its float32
        in ``mode``."""
        batches, steps = self.reference_inputs()
        with module.precision(mode):
            out = module.train_steps(self.init, batches, steps,
                                     self.config["model"],
                                     self.config["train"])
        return readings(out, self.init)


def run(bench, cell, seed, seconds, trace, device="cuda", workers=None):
    """One run of a training cell: (result fields, context, numbers)."""
    from port_bench.harness import record
    started = record.process_age_s()
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    r = TrainRun(config, traffic, seed, device, workers)
    program = r.first_steps()
    setup_s = record.process_age_s()
    window_s, steps = r.window(seconds)
    memory = (torch.cuda.max_memory_allocated()
              if r.device.type == "cuda" else 0)
    ctx = record.Context(kind="train", cell=cell, config=config,
                         traffic=traffic, setup_s=setup_s,
                         window_s=window_s, steps=steps,
                         images=steps * r.rows, rows=r.rows)
    if trace:
        ctx.trace, ctx.traced_steps = r.traced()
    r.free()
    numbers = check.train_numbers(
        program, r.reference(bench.reference(config["reference"])))
    fields = {"attempted": steps, "failed": 0, "memory": memory,
              "setup_phases": dict(to_runner=started, **r.seconds)}
    return fields, ctx, numbers
