"""Training harness: one train step of the ELBO, and the experiment that
runs epochs of it with evaluation, reports and the importance-weighted
log-likelihood.

:func:`train_step` is the counterpart of
``UnsupervisedExperiment._build_train_step`` in the JAX package's
``train/loop.py`` (and of ``bench.py``'s step): uint8 images are scaled to
[0, 1] on the device; the model runs in train mode (BatchNorm on batch
statistics, running statistics updated); the loss is the mean
reconstruction error plus beta times the mean KL, or one of the ``control``
forms; the optimizer (``train/state.py``) applies the gradients. At
beta == 0 the KL is not computed at all, as the reference's Python branch
skips it: a zero weight on a NaN KL would still put NaN into the shared
gradients. The paper's regularizers add to either branch: the equivariance
loss (a second encoder pass over rotated images, in train mode after the
main pass, so BatchNorm's running statistics advance twice) and the encoder
continuity loss over consecutive-pose pairs.

:class:`UnsupervisedExperiment` is the counterpart of the JAX class of the
same name (reference: ``lie_vae/experiments/unsupervised.py:11-156``), with
its constructor's keywords, its per-step beta schedule, its report cadence,
tags and printed line, its sigma-max monitor, its ``test()`` and its
``log_likelihood``. PyTorch runs eagerly, so there is nothing to compile
and no padding: a ragged evaluation batch is evaluated as it is.

Both run their device work in IEEE float32 (``precision.ieee_float32``: no
TF32 convolutions or matmuls), the caller's settings restored after.

Over a process mesh (``parallel``) a step computes what the single-process
step computes on the global batch: each rank takes its contiguous rows of
the batch and of the noise drawn for all of it, BatchNorm takes the global
batch's statistics, the gradients are averaged over the ``data`` group
before the clip, and the metrics are the global batch's.
"""
import math
import os
import time

import numpy as np
import torch

from lie_vae_tpu_torch.data.loader import BatchLoader
from lie_vae_tpu_torch.distributions.vmf import NUM_PROPOSALS, draw_proposals
from lie_vae_tpu_torch.losses import (encoder_continuity_loss,
                                      equivariance_loss)
from lie_vae_tpu_torch.precision import ieee_float32
from lie_vae_tpu_torch.train.checkpoint import apply_state
from lie_vae_tpu_torch.train.logging import MetricWriter
from lie_vae_tpu_torch.train.state import make_optimizer


def _normalize(x, dtype=torch.float32):
    """uint8 images to [0, 1] in ``dtype`` (the model's); others (the toy
    spectra) as they are."""
    return x.to(dtype) / 255.0 if x.dtype == torch.uint8 else x


@ieee_float32()
def train_step(model, optimizer, x, beta, eps=None, generator=None,
               elbo_samples=1, control=None, control_p=1,
               monitor_sigma=False, equivariance_lamb=None,
               encoder_continuity_lamb=None, equivariance_rotate="shear",
               theta=None, eq_eps=None, mesh=None):
    """One optimizer step on the batch ``x`` (NHWC images, uint8 or float,
    or toy spectra; moved to the model's device, uint8 scaled to [0, 1] in
    the model's dtype). ``eps`` (elbo_samples, B, model.noise_dims) fixes
    the posterior noise (for vMF the pair of ``LieVAE.encode``); otherwise
    ``generator`` draws it; a deterministic model takes none. ``beta`` is a
    Python number. Returns the metrics as detached 0-dim tensors:
    ``recon``, ``kl``, ``kls`` (a list, one per
    latent), ``loss`` and, with ``monitor_sigma``, ``sigma_max``. After
    the step each parameter's ``.grad`` holds its gradient of the loss,
    unclipped.

    ``equivariance_lamb`` and ``encoder_continuity_lamb`` (numbers; None
    leaves the loss out, 0 computes it with weight 0) add the two
    regularizers on the first sample of the first latent, with the metrics
    ``equivariance`` and ``encoder_continuity``. The equivariance loss
    rotates the batch by ``theta`` (B,) with ``equivariance_rotate``
    ('shear' or 'gather') and encodes it again in train mode with the noise
    ``eq_eps`` (1, B, noise_dims), or the vMF pair; each is drawn from
    ``generator`` when not given (theta uniform in [0, 2 pi)). The
    continuity loss pairs rows (2i, 2i + 1).

    Over a process ``mesh`` (``parallel.make_mesh`` after
    ``parallel.shard_state`` of the model) ``x``, ``eps``, ``theta`` and
    ``eq_eps`` are this rank's rows of the global batch's: the gradients
    are averaged over the ``data`` group before the optimizer's step, and
    the metrics are the global batch's (``sigma_max`` its maximum)."""
    if control is not None and control_p not in (1, 2):
        raise ValueError("Wrong control p")
    param = next(model.parameters())
    device = param.device
    x = _normalize(torch.as_tensor(x, device=device), param.dtype)
    model.train()
    optimizer.zero_grad()
    x_recon, stats = model(x, n=elbo_samples, eps=eps, generator=generator)
    mean_recon = torch.mean(model.recon_loss(x_recon, x))
    if beta != 0.0:
        kls = model.kl(stats)
        kl_sum = sum(kls)
        if control is None:
            loss = mean_recon + beta * torch.mean(kl_sum)
        elif control_p == 1:
            loss = mean_recon + control * torch.mean(torch.abs(beta - kl_sum))
        else:
            loss = mean_recon + control * torch.mean((beta - kl_sum) ** 2)
        mean_kl = torch.mean(kl_sum).detach()
        kls_mean = [torch.mean(k).detach() for k in kls]
    else:
        loss = mean_recon
        mean_kl = torch.zeros((), device=device)
        kls_mean = [mean_kl for _ in stats]
    metrics = {"recon": mean_recon.detach(), "kl": mean_kl, "kls": kls_mean}
    encoding = stats[0].z[0]
    if equivariance_lamb is not None:
        b = x.shape[0]
        draw = generator.device if generator is not None else device
        if theta is None:
            theta = torch.rand((b,), generator=generator, dtype=x.dtype,
                               device=draw) * (2.0 * math.pi)
        if eq_eps is None and model.noise_dims is not None \
                and not model.is_vmf:
            eq_eps = torch.randn((1, b, model.noise_dims),
                                 generator=generator, dtype=x.dtype,
                                 device=draw)

        def encode_fn(img):
            # train mode, after the main pass: BatchNorm's running
            # statistics advance a second time, as the reference's do
            return model.encode(img, n=1, eps=eq_eps,
                                generator=generator)[0].z[0]

        if not isinstance(theta, torch.Tensor):
            theta = torch.tensor(np.asarray(theta))
        eq, _ = equivariance_loss(encode_fn, x, encoding, theta.to(device),
                                  rotate_impl=equivariance_rotate)
        loss = loss + equivariance_lamb * eq
        metrics["equivariance"] = eq.detach()
    if encoder_continuity_lamb is not None:
        cont, _ = encoder_continuity_loss(encoding)
        loss = loss + encoder_continuity_lamb * cont
        metrics["encoder_continuity"] = cont.detach()
    loss.backward()
    if mesh is not None:
        mesh.average_gradients(model.parameters())
    optimizer.step()
    metrics["loss"] = loss.detach()
    if monitor_sigma:
        metrics["sigma_max"] = torch.max(stats[0].inner.sigma).detach()
    if mesh is not None and mesh.shape["data"] > 1:
        _global_metrics(metrics, mesh)
    return metrics


def _global_metrics(metrics, mesh):
    """The ranks' metrics, means over equal row blocks, as the global
    batch's: averaged over the ``data`` group, ``sigma_max`` its maximum."""
    names = [k for k in metrics if k not in ("kls", "sigma_max")]
    vec = torch.stack([metrics[k] for k in names] + list(metrics["kls"]))
    vec = mesh.all_reduce_(vec.clone(), "data") / mesh.shape["data"]
    metrics.update(zip(names, vec[:len(names)].unbind()))
    metrics["kls"] = list(vec[len(names):].unbind())
    if "sigma_max" in metrics:
        metrics["sigma_max"] = mesh.all_gather(
            metrics["sigma_max"].reshape(1), "data").max()


class UnsupervisedExperiment:
    """Epochs of :func:`train_step` over ``train_dataset``, evaluated on
    ``test_dataset``. Reference constructor surface: unsupervised.py:18-56,
    the JAX class's keywords.

    The model is trained as it is passed in (its weights are the start;
    ``init_state``, a ``train.checkpoint.load_checkpoint`` dict, replaces
    them and the optimizer's state), on its own device. The posterior noise
    of training, evaluation and the IW-LL comes from three CPU
    ``torch.Generator``s seeded from ``seed`` (so a run on the card and one
    on the CPU with the same seed draw the same numbers), the training
    order from ``BatchLoader`` with ``seed`` as the JAX harness's. A vMF
    model takes its stream's generator itself: its accept/reject needs the
    posterior's kappa, so the sampler draws the proposals and picks on the
    device.

    ``steps_per_call`` groups steps as the JAX harness scans them (reports
    land on the first group boundary at or after ``report_freq``); the steps
    of a group run one at a time, each with its own beta, as in the scan.
    ``device_data`` keeps each dataset's inputs on the model's device
    and gathers batches there (a paired dataset's two rows an item).
    ``equivariance_lamb`` and ``encoder_continuity_lamb`` are schedules of
    the global step (the CLI's ``LinearSchedule``s), each loss computed on
    every step once its schedule is given; the rotation angles and the
    second encoder pass's noise come from the training stream after the
    step's posterior noise.

    ``mesh`` (``parallel.make_mesh`` over a process group) trains data- and
    model-parallel: the model is placed by ``parallel.shard_state`` (weights
    broadcast from rank 0, the big layers split over ``model``, BatchNorm
    over the ``data`` group) and ``init_state``'s full tensors are cut to
    it; ``batch_size`` is the global batch, and each rank loads its rows of
    it (``BatchLoader(num_shards, shard_index)``; with ``device_data`` it
    holds the whole set and gathers its rows of the global index batch);
    every rank draws the noise of the whole batch from the same streams and
    keeps its rows, so a step equals the single-process one. ``test()``
    pads each evaluation batch to the ``data`` size, masks the padding and
    all-reduces the sums, the same uniform mean over batches; the IW-LL
    runs replicated. Only rank 0 logs and prints.

    ``noise``, a callable ``(stream, shape)`` returning standard normals on
    the CPU, stands in for the streams' generators wherever they draw
    posterior noise (a reference that draws its own noise hands it over
    so; a vMF sampler still draws from its stream). ``report_freq=None``
    makes ``train()`` report never, nor run the ``test()`` of a report.
    """

    def __init__(self, *, model, train_dataset, test_dataset, beta_schedule,
                 lr=1e-3, weight_decay=0.0, elbo_samples=1, report_freq=1250,
                 clip_grads=1e-5, selective_clip=False, batch_size=64,
                 equivariance_lamb=None, encoder_continuity_lamb=None,
                 control=None, control_p=1, log=None, seed=0, mesh=None,
                 log_histograms=False, init_state=None, steps_per_call=1,
                 device_data=False, equivariance_rotate="shear",
                 noise=None):
        if mesh is not None:
            if not mesh.distributed:
                raise ValueError("training takes a process mesh "
                                 "(parallel.make_mesh after "
                                 "initialize_distributed)")
            if batch_size % mesh.shape["data"]:
                raise ValueError(f"the global batch of {batch_size} does "
                                 f"not split over the data axis of size "
                                 f"{mesh.shape['data']}")
            from lie_vae_tpu_torch.parallel import shard_state
            shard_state(model, mesh)
        self.mesh = mesh
        self._is_main = mesh is None or mesh.is_main
        if equivariance_rotate not in ("shear", "gather"):
            raise ValueError(f"unknown equivariance_rotate "
                             f"{equivariance_rotate!r}")
        if control is not None and control_p not in (1, 2):
            raise ValueError("Wrong control p")
        self.model = model
        self.device = next(model.parameters()).device
        self.dtype = next(model.parameters()).dtype
        self.control = control
        self.control_p = control_p
        self.beta_schedule = beta_schedule
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        self.elbo_samples = elbo_samples
        self.report_freq = report_freq
        self.equivariance_lamb = equivariance_lamb
        self.encoder_continuity_lamb = encoder_continuity_lamb
        self.equivariance_rotate = equivariance_rotate
        self.log = log if isinstance(log, MetricWriter) else MetricWriter(log)
        if not self._is_main:
            self.log = MetricWriter(None)
        self.log_histograms = log_histograms
        self.best_value = np.inf
        self.steps_per_call = max(1, int(steps_per_call))
        self.optimizer = make_optimizer(
            model.named_parameters(), lr=lr, weight_decay=weight_decay,
            clip_grads=clip_grads, selective_clip=selective_clip)
        if init_state is not None:
            apply_state(init_state, model, self.optimizer)
        shards = ({} if mesh is None else
                  {"num_shards": mesh.shape["data"],
                   "shard_index": mesh.data_index})
        self.train_loader = BatchLoader(train_dataset, batch_size,
                                        shuffle=True, drop_last=True,
                                        seed=seed, **shards)
        self.test_loader = BatchLoader(test_dataset, batch_size,
                                       shuffle=False, drop_last=False)
        self._gens = {
            stream: torch.Generator().manual_seed(int(
                np.random.SeedSequence([seed, i]).generate_state(1)[0]))
            for i, stream in enumerate(("train", "eval", "ll"))}
        # SO(3) posterior-drift monitor: the k-shell wrapped density is only
        # valid while sigma stays below about pi * k / 2 (JAX harness,
        # train/loop.py): past it the MC KL and the IW-LL are biased
        self._monitor_sigma = getattr(model, "latent_mode", None) == "so3"
        self._sigma_valid_bound = (
            math.pi * getattr(model, "density_k", 10) / 2.0)
        self._window = []
        self._device_train = self._device_test = None
        if device_data:
            self._device_train = self._cache_device(train_dataset)
            self._device_test = (self._device_train
                                 if test_dataset is train_dataset
                                 else self._cache_device(test_dataset))
        self._noise_fn = noise
        self.last_ll = None
        self.last_metrics = None

    def _cache_device(self, dataset):
        """The dataset's inputs, all of them, on the model's device (uint8
        images, or the toy spectra as they are), and the rows an item
        (2 for a paired dataset, whose ``prep_batch`` flattens the pairs).
        An image dataset decodes every file first through its
        ``warm_cache`` (one bulk read of its disk cache after the first
        decode); over a mesh rank 0 writes that cache before the others
        read it."""
        warm = getattr(dataset, "warm_cache", None)
        if warm is not None:
            if self._is_main:
                warm()
            if self.mesh is not None:
                self.mesh.barrier()
                if not self._is_main:
                    warm()
        images = dataset.prep_batch(dataset.gather(np.arange(len(dataset))))
        rows = torch.as_tensor(np.asarray(images[-1]), device=self.device)
        return rows, rows.shape[0] // len(dataset)

    def _eps(self, stream, n, batch):
        """Standard normal posterior noise (n, batch, model.noise_dims) from
        the stream's generator, on the model's device in its dtype; None for
        a deterministic model, which draws none. Over a mesh ``batch`` is
        this rank's rows: the noise of the global batch is drawn and the
        rank's rows kept."""
        dims = self.model.noise_dims
        if dims is None:
            return None
        eps = self._randn(stream, (n, self._global(batch), dims))
        return self._local(eps, batch, 1).to(self.device, self.dtype)

    def _randn(self, stream, shape):
        """Standard normals of ``shape`` from the stream's generator, on
        the CPU in float32 whatever torch's default dtype (or from
        ``noise``): every posterior noise but vMF's is drawn here."""
        if self._noise_fn is not None:
            return self._noise_fn(stream, shape)
        return torch.randn(shape, generator=self._gens[stream],
                           dtype=torch.float32)

    def _global(self, rows):
        return rows if self.mesh is None else rows * self.mesh.shape["data"]

    def _local(self, t, rows, dim):
        """This rank's ``rows`` of a global tensor along ``dim`` (all of it
        without a mesh)."""
        if self.mesh is None:
            return t
        return t.narrow(dim, self.mesh.data_index * rows, rows)

    def _vmf_eps(self, stream, n, rows):
        """vMF's noise for n samples of the global batch as the sampler
        draws it from the stream (its proposals and uniforms
        (NUM_PROPOSALS, n, rows), then the tangent normal (n, rows, p)),
        all of it on the CPU."""
        gen, p = self._gens[stream], self.model.noise_dims
        props = draw_proposals((NUM_PROPOSALS, n, rows), p, gen,
                               dtype=self.dtype)
        return props + (torch.randn((n, rows, p), generator=gen,
                                    dtype=self.dtype),)

    def _noise(self, stream, n, batch, local=True):
        """The posterior noise keywords of n samples of ``batch`` items from
        the stream: ``eps`` (:meth:`_eps`); for a vMF model the stream's
        ``generator`` itself, or over a mesh the sampler's draws for the
        global batch, this rank's rows of them; nothing for a deterministic
        model."""
        if self.model.noise_dims is not None \
                and getattr(self.model, "is_vmf", False):
            if self.mesh is None or not local:
                return {"generator": self._gens[stream]}
            props, u, v = self._vmf_eps(stream, n, self._global(batch))
            return {"eps": (self._local(props, batch, 2).to(self.device),
                            self._local(u, batch, 2).to(self.device),
                            self._local(v, batch, 1).to(self.device))}
        dims = self.model.noise_dims
        if local or self.mesh is None:
            eps = self._eps(stream, n, batch)
        elif dims is not None:       # the replicated IW-LL: every row
            eps = self._randn(stream, (n, batch, dims)).to(self.device,
                                                           self.dtype)
        else:
            eps = None
        return {} if eps is None else {"eps": eps}

    def _step_inputs(self, global_it, batch):
        """A train step's noise and regularizer keywords for ``batch`` rows,
        drawn in the order the single-process step draws them (a vMF model
        draws its posterior noise inside the step, after the rotation
        angles, and then the second pass's)."""
        if self.mesh is None or not getattr(self.model, "is_vmf", False) \
                or self.model.noise_dims is None:
            return (self._noise("train", self.elbo_samples, batch),
                    self._regularizers(global_it, batch))
        reg = self._regularizers(global_it, batch)
        noise = self._noise("train", self.elbo_samples, batch)
        if self.equivariance_lamb is not None:
            reg["eq_eps"] = self._noise("train", 1, batch)["eps"]
        return noise, reg

    def _batches(self, loader, cached):
        """The loader's batches of inputs: host arrays, or device tensors
        gathered from the cached dataset by the same indices."""
        if cached is None:
            return (np.asarray(b[-1]) for b in loader)
        rows, factor = cached
        batches = loader._index_batches()
        loader.epoch += 1
        return (rows[(torch.as_tensor(idx, device=self.device)[:, None]
                      * factor + torch.arange(factor, device=self.device)
                      ).reshape(-1)]
                for idx in batches)

    def _regularizers(self, global_it, batch):
        """The train step's regularizer keywords at ``global_it``: each
        configured loss's weight and, for the equivariance loss, the
        rotation angles (B,) and the second pass's noise from the training
        stream (a vMF model draws that noise from the stream itself)."""
        kw = {}
        if self.encoder_continuity_lamb is not None:
            kw["encoder_continuity_lamb"] = self.encoder_continuity_lamb(
                global_it)
        if self.equivariance_lamb is not None:
            gen = self._gens["train"]
            theta = torch.rand((self._global(batch),), generator=gen)
            kw.update(equivariance_lamb=self.equivariance_lamb(global_it),
                      equivariance_rotate=self.equivariance_rotate,
                      theta=self._local(theta, batch, 0) * (2.0 * math.pi))
            if not getattr(self.model, "is_vmf", False):
                kw["eq_eps"] = self._eps("train", 1, batch)
        return kw

    # -------------------------------------------------------------- eval

    @torch.no_grad()
    @ieee_float32()
    def test(self):
        """Full pass over the evaluation loader in eval mode; returns the
        (recon, kl, *kls) means as float64 numpy: per batch the mean over
        its rows, then uniform over batches, the ragged tail included (the
        reference's semantics, unsupervised.py:58-67). Over a mesh every
        rank evaluates its rows of each batch (:meth:`_test_mesh`)."""
        if self.mesh is not None:
            return self._test_mesh()
        self.model.eval()
        vals = []
        for x in self._batches(self.test_loader, self._device_test):
            x = _normalize(torch.as_tensor(x, device=self.device),
                           self.dtype)
            recon, kl_sum, kls, _ = self.model.elbo(
                x, n=self.elbo_samples,
                **self._noise("eval", self.elbo_samples, x.shape[0]))
            vals.append(torch.stack([torch.mean(recon), torch.mean(kl_sum)]
                                    + [torch.mean(k) for k in kls]))
        self.model.train()
        return self._mean_over_batches(vals)

    @staticmethod
    def _mean_over_batches(vals):
        if not vals:
            raise RuntimeError(
                "test(): evaluation loader produced no batches - test "
                "metrics and best_value would silently become NaN. Check "
                "the validation split size.")
        return torch.stack(vals).double().mean(0).cpu().numpy()

    def _test_mesh(self):
        """test() over the mesh: each global batch of b items padded to a
        multiple of the ``data`` size by repeating its last item, this
        rank's contiguous items of it evaluated with its rows of the noise
        drawn for the b items, the padding masked out of the sums, the sums
        all-reduced over ``data`` and divided by the batch's rows; then the
        uniform mean over batches."""
        mesh, k = self.mesh, self.mesh.shape["data"]
        dataset = self.test_dataset
        prep = getattr(dataset, "prep_batch", lambda b: b)
        loader = self.test_loader
        batches = loader._index_batches()
        loader.epoch += 1
        self.model.eval()
        vals = []
        for idx in batches:
            b = len(idx)
            padded = np.concatenate([idx, np.repeat(idx[-1:], (-b) % k)])
            sl = mesh.rows(len(padded))
            local = padded[sl]
            valid = max(0, min(b - sl.start, len(local)))
            if self._device_test is None:
                x = torch.as_tensor(
                    np.asarray(prep(dataset.gather(local))[-1]),
                    device=self.device)
            else:
                rows, factor = self._device_test
                x = rows[(torch.as_tensor(local, device=self.device)[:, None]
                          * factor + torch.arange(factor, device=self.device)
                          ).reshape(-1)]
            factor = x.shape[0] // len(local)
            x = _normalize(x, self.dtype)
            # the noise of the batch's b items, as one process draws it;
            # the padding's rows take the last row's
            take = torch.arange(factor * sl.start, factor * sl.stop).clamp(
                max=factor * b - 1)
            noise = self._eval_noise(factor * b, take)
            recon, kl_sum, kls, _ = self.model.elbo(
                x, n=self.elbo_samples, **noise)
            mask = (torch.arange(x.shape[0], device=self.device)
                    < factor * valid).to(recon.dtype)
            sums = torch.stack([torch.sum(v * mask) for v in
                                [torch.mean(recon, 0), kl_sum] + list(kls)])
            vals.append(mesh.all_reduce_(sums, "data") / (factor * b))
        self.model.train()
        return self._mean_over_batches(vals)

    def _eval_noise(self, rows, take):
        """The evaluation stream's noise keywords for ``rows`` global rows,
        the rows ``take`` of it."""
        dims, n = self.model.noise_dims, self.elbo_samples
        if dims is None:
            return {}
        if getattr(self.model, "is_vmf", False):
            props, u, v = self._vmf_eps("eval", n, rows)
            return {"eps": (props[:, :, take].to(self.device),
                            u[:, :, take].to(self.device),
                            v[:, take].to(self.device))}
        eps = self._randn("eval", (n, rows, dims))
        return {"eps": eps[:, take].to(self.device, self.dtype)}

    # ------------------------------------------------------------- train

    @ieee_float32()
    def train(self, epoch, max_steps=None, on_step=None):
        """One epoch. Reference: unsupervised.py:69-156 (same reporting
        cadence, tags and printed line). ``max_steps`` ends the epoch after
        that many steps (a report comes then only if one is due);
        ``on_step(metrics)`` is called after each step."""
        num_batches = len(self.train_loader)
        n = num_batches if max_steps is None else min(num_batches, max_steps)
        K = self.steps_per_call
        steps_since_report = 0
        start = time.time()
        group = []
        batches = self._batches(self.train_loader, self._device_train)
        for it, x in enumerate(batches):
            if it == n:
                break
            group.append((epoch * num_batches + it + 1, x))
            if len(group) < K and it + 1 < n:
                continue
            for global_it, xb in group:
                beta = self.beta_schedule(global_it)
                noise, reg = self._step_inputs(global_it, xb.shape[0])
                metrics = train_step(
                    self.model, self.optimizer, xb, beta, **noise, **reg,
                    elbo_samples=self.elbo_samples, control=self.control,
                    control_p=self.control_p,
                    monitor_sigma=self._monitor_sigma, mesh=self.mesh)
                if self.report_freq is not None:
                    self._window.append(metrics)
                self.last_metrics = metrics
                if on_step is not None:
                    on_step(metrics)
            steps_since_report += len(group)
            if self.report_freq is not None and (
                    steps_since_report >= self.report_freq
                    or it + 1 == num_batches):
                self._report(epoch, it, group[-1][0], beta, start,
                             n_steps=steps_since_report, lambs=reg)
                steps_since_report = 0
                start = time.time()
            group = []

    def _report(self, epoch, it, global_it, beta, start, n_steps,
                lambs=None):
        # one device->host transfer of the window's metrics; every step in
        # the window weighs the same
        lambs = lambs or {}
        regs = [k for k in ("equivariance", "encoder_continuity")
                if f"{k}_lamb" in lambs]
        names = ["recon", "kl"] + regs + (["sigma_max"] if self._monitor_sigma
                                          else [])
        sums = torch.stack([torch.stack([m[k] for k in names])
                            for m in self._window]).double().sum(0)
        means = dict(zip(names, (sums / len(self._window)).tolist()))
        self._window = []
        train_recon, train_kl = means["recon"], means["kl"]
        if np.isnan(train_kl):
            raise RuntimeError("NaN KL")

        self.log.add_scalar("train_loss", train_recon + beta * train_kl,
                            global_it)
        self.log.add_scalar("train_recon", train_recon, global_it)
        self.log.add_scalar("train_kl", train_kl, global_it)
        for k in regs:
            self.log.add_scalar(k, means[k], global_it)
            self.log.add_scalar(f"{k}_lamb", lambs[f"{k}_lamb"], global_it)
        if self._monitor_sigma:
            sigma_max = means["sigma_max"]
            self.log.add_scalar("sigma_max", sigma_max, global_it)
            if sigma_max > self._sigma_valid_bound and self._is_main:
                print(f"WARNING: posterior sigma_max {sigma_max:.1f} exceeds "
                      f"the wrapped-density validity bound "
                      f"~{self._sigma_valid_bound:.1f} for its shell count: "
                      "reported KL (and a final IW-LL) are truncation-biased"
                      " - re-evaluate the checkpoint with a larger "
                      "density_k")

        test_vals = self.test()
        test_recon, test_kl = float(test_vals[0]), float(test_vals[1])
        self.best_value = min(self.best_value, test_recon)
        self.log.add_scalar("test_loss", test_recon + beta * test_kl,
                            global_it)
        self.log.add_scalar("test_recon", test_recon, global_it)
        self.log.add_scalar("test_kl", test_kl, global_it)
        self.log.add_scalar("beta", beta, global_it)
        if self.log_histograms:
            for name, p in self.model.named_parameters():
                self.log.add_histogram(name, p.detach().cpu().numpy(),
                                       global_it)
        self.log.flush()

        dt = (time.time() - start) / max(n_steps, 1)
        if not self._is_main:
            return
        print(("Epoch {} it {} train recon {:.4f} kl {:.4f}"
               " test recon {:.4f} kl {:.4f} ({:.3f}s)")
              .format(epoch, it + 1, train_recon, train_kl,
                      test_recon, test_kl, dt))

    # --------------------------------------------------------- profiling

    @ieee_float32()
    def profile(self, log_dir, n_calls=3):
        """Trace ``n_calls`` training steps on the first batch with
        ``torch.profiler`` (after one untraced step) into
        ``log_dir/trace.json`` (chrome trace format). The steps update the
        model, as the JAX harness's profiled steps do; over a mesh every
        rank steps and rank 0 writes its trace."""
        x = next(iter(self._batches(self.train_loader, self._device_train)))
        beta = float(self.beta_schedule(1))

        def step():
            noise, reg = self._step_inputs(1, x.shape[0])
            train_step(self.model, self.optimizer, x, beta, **noise, **reg,
                       elbo_samples=self.elbo_samples, control=self.control,
                       control_p=self.control_p, mesh=self.mesh)

        step()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(n_calls):
                step()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if not self._is_main:
            return
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}")

    # ---------------------------------------------------- log-likelihood

    @torch.no_grad()
    @ieee_float32()
    def log_likelihood(self, dataset, n=500, max_items=None, batch_size=1,
                       n_chunk=None, return_items=False):
        """Importance-sampled LL over a dataset, in eval mode (over a mesh
        every rank evaluates every item, replicated).

        Reference: main.py:134-143 (n=500, batch 1, eval mode). Items are
        evaluated ``batch_size`` at a time (the estimate is per item, so
        batching is exact) in the loader's seeded shuffled order; the n
        samples are drawn in chunks of ``n_chunk`` whose logsumexps are
        merged in float64, then - log n. ``self.last_ll`` keeps the
        per-item estimates and the per-item mean of the same log-weights
        (by Jensen's inequality no estimate can lie below it).
        """
        if n_chunk is None:
            n_chunk = n if batch_size == 1 else max(1, min(n, 50))
        chunks = max(1, -(-n // n_chunk))
        n_chunk = -(-n // chunks)
        n_eff = chunks * n_chunk
        if n_eff != n:
            print(f"log_likelihood: n={n} not divisible into {chunks} "
                  f"chunks; using n={n_eff} importance samples")
        self.model.eval()
        loader = BatchLoader(dataset, batch_size, shuffle=True,
                             drop_last=False)
        items, mean_w, seen = [], [], 0
        for batch in loader:
            if max_items is not None and seen >= max_items:
                break
            x = np.asarray(batch[-1])
            if max_items is not None:
                x = x[:max_items - seen]
            x = _normalize(torch.as_tensor(x, device=self.device),
                           self.dtype)
            lses, sums = [], 0.0
            for _ in range(chunks):
                w = self.model.log_weights(
                    x, n=n_chunk, **self._noise("ll", n_chunk, x.shape[0],
                                                local=False)).double()
                lses.append(torch.logsumexp(w, dim=0))
                sums = sums + w.sum(0)
            lse = torch.logsumexp(torch.stack(lses), dim=0)
            items.append((lse - math.log(n_eff)).cpu())
            mean_w.append((sums / n_eff).cpu())
            seen += x.shape[0]
        self.model.train()
        if not items:                 # empty dataset / max_items=0
            self.last_ll = None
            return float("nan")
        items = torch.cat(items).numpy()
        self.last_ll = {"items": items,
                        "mean_log_weights": torch.cat(mean_w).numpy()}
        if return_items:
            return float(np.mean(items)), items
        return float(np.mean(items))
