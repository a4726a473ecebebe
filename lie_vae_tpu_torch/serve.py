"""Serving: a trained :class:`~lie_vae_tpu_torch.models.LieVAE` behind
fixed-batch ``encode`` / ``decode`` / ``reconstruct`` / ``sample`` /
``geodesic``, and the deployment artifacts it serves from.

Counterpart of ``InferenceSession``, ``export_npz``,
``export_npz_from_torch``, ``export_aot`` (and ``export_aot_from_torch``)
and ``AotSession`` in the JAX
package's ``serve.py``. Requests and
answers are numpy arrays of any leading size N: NHWC images (or toy
spectra, the model's ``out_shape``) and poses in the model's latent
representation: (N, 3, 3) rotations for ``so3``, (N, normal_dims) vectors
for ``normal``, (N, 4) unit vectors for ``vmf`` and unit quaternions for
``vmfq``. Work runs in chunks of ``batch_size`` rows (the last chunk padded
by repeating its last row, the padding cut off again) under
``torch.inference_mode()`` and in IEEE float32
(``precision.ieee_float32``: no TF32), with the model in ``eval()`` so
BatchNorm uses its running statistics. Noise and prior poses are drawn from
a CPU ``torch.Generator`` seeded at construction, so a session on the GPU
and one on the CPU with the same seed draw the same numbers.

:class:`AotSession` serves an :func:`export_aot` artifact with no model
flags: on the card its fixed-batch encode, decode and reconstruct each
replay one CUDA graph, captured once.

Typical use::

    model = flagship_model()
    sess = InferenceSession.from_torch("best.pt", model)
    sess.warmup()
    poses = sess.encode(images)["pose"]
    frames = sess.geodesic(poses[0], poses[1], steps=30)
"""
import json

import numpy as np
import torch

from lie_vae_tpu_torch import compat, ops
from lie_vae_tpu_torch.precision import ieee_float32


class InferenceSession:
    """Fixed-batch inference over a trained model with any of the four
    latents (``so3``, ``normal``, ``vmf``, ``vmfq``) on ``device``."""

    def __init__(self, model, state_dict, batch_size=64, seed=0,
                 device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.model.load_state_dict(state_dict, strict=True)
        self.batch_size = int(batch_size)
        self._gen = torch.Generator(device="cpu").manual_seed(seed)

    @classmethod
    def from_torch(cls, path, model, batch_size=64, seed=0, device="cuda"):
        """Serve a reference PyTorch checkpoint (a saved state_dict)."""
        return cls(model, compat.load_torch(path), batch_size=batch_size,
                   seed=seed, device=device)

    @classmethod
    def from_checkpoint(cls, path, model, batch_size=64, seed=0,
                        device="cuda"):
        """Serve the model of a training checkpoint
        (``train.checkpoint.save_state``)."""
        from lie_vae_tpu_torch.train.checkpoint import load_checkpoint
        return cls(model, load_checkpoint(path)["model"],
                   batch_size=batch_size, seed=seed, device=device)

    @classmethod
    def from_npz(cls, path, model, batch_size=64, seed=0, device="cuda"):
        """Serve a JAX deployment artifact (``.npz`` of flat paths), the JAX
        package's or :func:`export_npz`'s."""
        return cls(model, compat.state_dict_from_jax(compat.load_npz(path),
                                                     model),
                   batch_size=batch_size, seed=seed, device=device)

    # ------------------------------------------------------------ plumbing

    @staticmethod
    def _normalize(x):
        x = np.asarray(x)
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        return x.astype(np.float32, copy=False)

    def _chunks(self, *arrays):
        """The row-aligned ``arrays`` in full ``batch_size`` chunks, the last
        padded by repeating its last row: lists of CPU tensors, each a copy
        (a request's array may be read-only, as an HTTP body's is), and the
        request's N."""
        n = arrays[0].shape[0]
        if n == 0:
            raise ValueError("empty request (0 rows)")
        b = self.batch_size
        for lo in range(0, n, b):
            chunks = []
            for a in arrays:
                c = np.asarray(a[lo:lo + b])
                if c.shape[0] < b:
                    c = np.concatenate(
                        [c, np.repeat(c[-1:], b - c.shape[0], axis=0)])
                else:
                    c = np.array(c)
                chunks.append(torch.from_numpy(c))
            yield chunks

    @staticmethod
    def _gather(outs, n):
        """Per-chunk outputs (a tensor or a tuple of them) -> numpy
        concatenated and cut back to N rows."""
        outs = [tuple(o.cpu().numpy() for o in out)
                if isinstance(out, tuple) else (out.cpu().numpy(),)
                for out in outs]
        res = tuple(np.concatenate(parts)[:n] for parts in zip(*outs))
        return res if len(res) > 1 else res[0]

    def _chunked(self, fn, *arrays):
        """Run ``fn`` on full ``batch_size`` chunks of the row-aligned
        ``arrays`` (moved to the device) and return its outputs, a tensor
        or a tuple of them, as numpy cut back to N rows."""
        outs = []
        with torch.inference_mode():
            for chunks in self._chunks(*arrays):
                outs.append(fn(*(c.to(self.device) for c in chunks)))
        return self._gather(outs, arrays[0].shape[0])

    @staticmethod
    def _posterior(stats):
        """(mean pose, spread) of a stats struct: the algebra-noise sigma
        for SO(3), kappa (B, 1) for vMF, sigma for the Gaussian."""
        if hasattr(stats, "mu_lie"):
            return stats.mu_lie, stats.inner.sigma
        if hasattr(stats, "kappa"):
            return stats.mu, stats.kappa
        return stats.mu, stats.sigma

    def _encode(self, x, *eps):
        """One chunk's posterior and sample; ``eps`` is nothing (the
        session's generator draws), one standard normal, or vMF's pair."""
        if not eps:
            s = self.model.encode(x, n=1, generator=self._gen)[0]
        elif len(eps) == 1:
            s = self.model.encode(x, n=1, eps=eps[0][None])[0]
        else:
            s = self.model.encode(x, n=1, eps=tuple(e[None] for e in eps))[0]
        return (*self._posterior(s), s.z[0])

    def _decode(self, z):
        return self.model.decode(z[None])[0]

    def _recon(self, x):
        """One chunk decoded from its posterior mean; the sample beside it
        takes fixed noise, so nothing is drawn."""
        dims, b = self.model.noise_dims, x.shape[0]
        if dims is None:
            eps = None
        elif self.model.is_vmf:
            eps = (torch.full((1, b), 0.5, device=x.device),
                   torch.zeros((1, b, dims), device=x.device))
        else:
            eps = torch.zeros((1, b, dims), device=x.device)
        s = self.model.encode(x, eps=eps)[0]
        return self._decode(self._posterior(s)[0])

    # ------------------------------------------------------------- surface

    @ieee_float32()
    def encode(self, images, eps=None):
        """Posterior of N inputs: ``{"pose": (N, ...) posterior means,
        "sigma": (N, ...) spreads (kappa (N, 1) for vMF), "sample": (N, ...)
        one posterior sample}``. ``eps`` fixes the sample's noise: a
        standard normal (N, noise_dims), or for vMF the pair (accepted Beta
        draw (N,), tangent normal (N, 4)); otherwise the session's generator
        draws it (a deterministic model draws none and samples its
        mean)."""
        x = self._normalize(images)
        dims = self.model.noise_dims
        if dims is None or (eps is None and self.model.is_vmf):
            pose, sigma, sample = self._chunked(self._encode, x)
        else:
            if eps is None:
                eps = torch.randn((x.shape[0], dims),
                                  generator=self._gen).numpy()
            parts = eps if self.model.is_vmf else (eps,)
            pose, sigma, sample = self._chunked(
                self._encode, x, *(np.asarray(e, np.float32) for e in parts))
        return {"pose": pose, "sigma": sigma, "sample": sample}

    @ieee_float32()
    def decode(self, poses):
        """Decode N poses (the model's latent representation) to outputs
        (N, *out_shape)."""
        return self._chunked(self._decode, np.asarray(poses, np.float32))

    @ieee_float32()
    def reconstruct(self, images):
        """Encode to the posterior mean, then decode: the autoencoder
        path."""
        return self._chunked(self._recon, self._normalize(images))

    @ieee_float32()
    def sample(self, n, seed=None):
        """Decode n poses from the prior (Haar-random rotations for
        ``so3``, Haar-random unit quaternions for ``vmf``/``vmfq``, N(0, I)
        for ``normal``), drawn from a generator seeded with ``seed`` or else
        from the session's."""
        gen = (torch.Generator(device="cpu").manual_seed(seed)
               if seed is not None else self._gen)
        mode = self.model.latent_mode
        if mode == "so3":
            z = ops.random_group_matrices(n, generator=gen, device="cpu")
        elif self.model.is_vmf:
            z = ops.random_quaternions(n, generator=gen, device="cpu")
        else:
            z = torch.randn((n, self.model.normal_dims), generator=gen)
        return self.decode(z.numpy())

    @ieee_float32()
    def geodesic(self, pose_a, pose_b, steps=16, decode=True):
        """Poses at ``steps`` points t of [0, 1] from a to b: for ``so3``
        r(t) = a exp(t log(a^T b)), the bi-invariant geodesic; for ``vmf``
        and ``vmfq`` the slerp of the normalised vectors along the shorter
        arc (b negated when a . b < 0: q and -q are one rotation), constant
        when the angle between them is below 1e-6; for ``normal`` the
        straight line (1 - t) a + t b. Decoded to (steps, *out_shape)
        unless ``decode=False``."""
        mode = self.model.latent_mode
        if mode == "so3":
            with torch.inference_mode():
                a = torch.as_tensor(np.asarray(pose_a, np.float32),
                                    device=self.device)
                b = torch.as_tensor(np.asarray(pose_b, np.float32),
                                    device=self.device)
                t = torch.linspace(0.0, 1.0, steps, device=self.device)
                v = ops.vee(ops.logmap(a.T @ b))
                poses = (a @ ops.expmap(t[:, None] * v)).cpu().numpy()
        else:
            t = np.linspace(0.0, 1.0, steps, dtype=np.float32)[:, None]
            za = np.asarray(pose_a, np.float32)
            zb = np.asarray(pose_b, np.float32)
            poses = (_slerp(za, zb, t) if self.model.is_vmf
                     else (1 - t) * za[None] + t * zb[None])
        return self.decode(poses) if decode else poses

    @ieee_float32()
    def warmup(self):
        """Run every serving path once at the batch shape (on the GPU this
        builds the CUDA kernels and picks cuDNN's algorithms)."""
        x = np.zeros((self.batch_size,) + self.model.out_shape, np.float32)
        self.decode(self.encode(x)["pose"])
        self.reconstruct(x)
        return self


def _slerp(qa, qb, t):
    """Spherical interpolation of two vectors, normalised, along the
    shorter arc, at t (steps, 1); (steps, p)."""
    qa = qa / np.linalg.norm(qa)
    qb = qb / np.linalg.norm(qb)
    if np.dot(qa, qb) < 0:
        qb = -qb
    omega = np.arccos(np.clip(np.dot(qa, qb), -1.0, 1.0))
    if omega < 1e-6:
        return np.repeat(qa[None], t.shape[0], axis=0)
    return (np.sin((1 - t) * omega) * qa[None]
            + np.sin(t * omega) * qb[None]) / np.sin(omega)


# ------------------------------------------------------------- artifacts

def _save_npz(out_path, state_dict, model, step, extra=None):
    flat = compat.state_dict_to_jax(state_dict, model)
    flat["__step__"] = np.asarray(step)
    flat.update(extra or {})
    np.savez(out_path, **flat)
    return out_path


def export_npz(checkpoint_path, out_path, model):
    """The model of a training checkpoint (``train.checkpoint.save_state``'s
    ``checkpoint.pt``) as one ``.npz`` deployment artifact in the JAX
    package's format: parameters and batch statistics under flat ``'/'``
    paths and the step under ``__step__``, which the JAX package's
    ``serve.load_npz`` and :meth:`InferenceSession.from_npz` read. The
    checkpoint holds a state_dict only, so ``model`` (its configuration)
    names the JAX paths."""
    from lie_vae_tpu_torch.train.checkpoint import load_checkpoint
    ckpt = load_checkpoint(checkpoint_path)
    return _save_npz(out_path, ckpt["model"], model, int(ckpt["step"]))


def export_npz_from_torch(torch_path, model, out_path):
    """Like :func:`export_npz`, from a reference PyTorch checkpoint (a
    ``torch.save``'d state_dict); the step is 0."""
    return _save_npz(out_path, compat.load_torch(torch_path), model, 0)


# ------------------------------------------------- the ahead-of-time session

_SURFACES = ("encode", "decode", "reconstruct")


def _pose_shape(model):
    return {"so3": (3, 3), "normal": (model.normal_dims,), "vmf": (4,),
            "vmfq": (4,)}[model.latent_mode]


def _jsonable(value):
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return value.tolist() if isinstance(value, np.ndarray) else value


def _aot_meta(model, batch_size):
    """``__aot_meta__``: a uint8 JSON blob with the JAX package's keys, the
    torch version and ``model``, the ``LieVAE`` constructor's keywords."""
    if model.r_callback is not None:
        raise ValueError("a model with r_callback cannot be rebuilt from "
                         "its keywords")
    meta = {"latent_mode": model.latent_mode,
            "normal_dims": model.normal_dims,
            "out_shape": list(model.out_shape),
            "batch_size": int(batch_size), "platforms": ["cuda"],
            "data_devices": 1, "torch_version": torch.__version__,
            "model": {k: _jsonable(v) for k, v in model.config.items()}}
    return {"__aot_meta__": np.frombuffer(json.dumps(meta).encode(),
                                          np.uint8)}


def export_aot(checkpoint_path, model, out_path, batch_size=64):
    """An ahead-of-time serving artifact of a training checkpoint
    (``checkpoint.pt``): :func:`export_npz`'s layout (flat ``params/...``
    and ``batch_stats/...`` paths, ``__step__``) and ``__aot_meta__``, a
    uint8 JSON blob with the JAX package's keys (``latent_mode``,
    ``normal_dims``, ``out_shape``, ``batch_size``, ``platforms``,
    ``data_devices``), the torch version and ``model``, the ``LieVAE``
    constructor's keywords, from which :class:`AotSession` rebuilds the
    model with no flags.

    The port writes no programs: there is no StableHLO (``__aot_encode__``
    and its siblings) in the artifact, so the JAX package's ``AotSession``
    cannot serve it (its weights load in the JAX package's ``load_npz``).
    :class:`AotSession` captures the programs on the card instead, as CUDA
    graphs at ``batch_size``."""
    from lie_vae_tpu_torch.train.checkpoint import load_checkpoint
    ckpt = load_checkpoint(checkpoint_path)
    return _save_npz(out_path, ckpt["model"], model, int(ckpt["step"]),
                     _aot_meta(model, batch_size))


def export_aot_from_torch(torch_path, model, out_path, batch_size=64):
    """Like :func:`export_aot`, from a reference PyTorch checkpoint (a
    ``torch.save``'d state_dict); the step is 0."""
    return _save_npz(out_path, compat.load_torch(torch_path), model, 0,
                     _aot_meta(model, batch_size))


class AotSession(InferenceSession):
    """Serving over an :func:`export_aot` artifact, with no model flags: the
    model is rebuilt from the artifact's ``model`` keywords. The surface is
    :class:`InferenceSession`'s, answers included: a session of the same
    weights and seed returns the same numbers.

    On the card each fixed-batch surface (``encode``, ``decode``,
    ``reconstruct``; ``sample`` and ``geodesic`` decode) is one CUDA graph,
    captured once at construction (``torch.cuda.graph``, each on its own
    memory pool, in IEEE float32, after two eager runs that build the
    kernels and pick cuDNN's algorithms) and replayed for every chunk: a
    chunk is copied into the graph's static input buffer, the graph
    replays, and its static outputs are copied out. A capture that fails
    raises. Noise is drawn outside the graph, from the session's CPU
    generator exactly as :class:`InferenceSession` draws it, and copied into
    a static buffer: for vMF the sampler's proposals and uniforms, the pick
    against kappa staying inside the graph (a given accepted draw enters as
    the first proposal with uniform 0, which accepts it). The kernels count
    a launch at capture and none at a replay; ``replays`` counts each
    surface's replays. On the CPU the same fixed-batch functions run
    eagerly over the same buffers. ``close()`` frees the graphs.

    The JAX package's AOT artifacts hold StableHLO programs and no model
    keywords; given one, this raises."""

    def __init__(self, path, seed=0, device="cuda"):
        from lie_vae_tpu_torch.models import LieVAE
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        if "__aot_meta__" not in flat:
            raise ValueError(f"{path} is not an ahead-of-time artifact (no "
                             "__aot_meta__): serve it with "
                             "InferenceSession.from_npz and the model flags")
        meta = json.loads(bytes(flat["__aot_meta__"]).decode())
        if "model" not in meta:
            raise ValueError(
                f"{path} is an ahead-of-time artifact of the JAX package "
                f"(platforms {meta.get('platforms')}): its __aot_meta__ has "
                "no 'model' entry, the LieVAE constructor keywords this "
                "session rebuilds the model from, and its StableHLO "
                "programs do not run here; re-export the checkpoint with "
                "lie_vae_tpu_torch.serve.export_aot, or serve the weights "
                "with InferenceSession.from_npz and the model flags")
        if int(meta.get("data_devices", 1)) != 1:
            raise NotImplementedError(
                "an artifact exported over a mesh: not ported yet "
                "(ROADMAP.md, Queue A, A9)")
        model = LieVAE(**meta["model"], device=device)
        weights = {k: v for k, v in flat.items() if not k.startswith("__")}
        super().__init__(model, compat.state_dict_from_jax(weights, model),
                         batch_size=int(meta["batch_size"]), seed=seed,
                         device=device)
        self.meta = meta
        self.replays = dict.fromkeys(_SURFACES, 0)
        self._graphs = {}
        self._buffers()
        if self.device.type == "cuda":
            self._capture()

    def _buffers(self):
        """The static inputs: images (B, *out_shape), poses (B, *pose) and
        the encode's noise: (1, B, noise_dims), or for vMF the proposals
        and uniforms (NUM_PROPOSALS, 1, B) and the tangent normal (1, B,
        4), or nothing for a deterministic model."""
        from lie_vae_tpu_torch.distributions.vmf import NUM_PROPOSALS
        m, b, dev = self.model, self.batch_size, self.device
        self._x = torch.zeros((b,) + tuple(m.out_shape), device=dev)
        self._z = torch.zeros((b,) + _pose_shape(m), device=dev)
        if m.noise_dims is None:
            self._noise = None
        elif m.is_vmf:
            self._noise = (torch.full((NUM_PROPOSALS, 1, b), 0.5, device=dev),
                           torch.ones((NUM_PROPOSALS, 1, b), device=dev),
                           torch.zeros((1, b, m.noise_dims), device=dev))
        else:
            self._noise = torch.zeros((1, b, m.noise_dims), device=dev)
        self._fns = {"encode": self._encode_static,
                     "decode": lambda: self._decode(self._z),
                     "reconstruct": lambda: self._recon(self._x)}
        # InferenceSession's surfaces hand _chunked these per-chunk methods
        self._surface = {self._encode: "encode", self._decode: "decode",
                         self._recon: "reconstruct"}

    def _encode_static(self):
        s = self.model.encode(self._x, n=1, eps=self._noise)[0]
        return (*self._posterior(s), s.z[0])

    def _capture(self):
        """Capture one graph per surface; raises if a capture fails."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.inference_mode(), ieee_float32():
            with torch.cuda.stream(side):
                for fn in self._fns.values():
                    for _ in range(2):
                        fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            for name, fn in self._fns.items():
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = fn()
                self._graphs[name] = (graph, out)

    def close(self):
        """Free the graphs and their memory pools."""
        self._graphs.clear()

    def _run(self, name):
        """The surface's outputs over the static inputs: a replay of its
        graph on the card (counted in ``replays``), the function itself on
        the CPU."""
        if self.device.type != "cuda":
            return self._fns[name]()
        graph, out = self._graphs[name]
        graph.replay()
        self.replays[name] += 1
        return out

    def _stage_noise(self, eps):
        """Copy a chunk's noise into the static buffer: ``eps`` is () (the
        session's generator draws, as InferenceSession's model does per
        chunk), a standard normal (B, dims), or vMF's pair (accepted draw
        (B,), tangent normal (B, 4))."""
        from lie_vae_tpu_torch.distributions.vmf import draw_proposals
        if self._noise is None:
            return
        if not self.model.is_vmf:
            self._noise[0].copy_(eps[0])
            return
        props, u, v = self._noise
        if eps:
            props[0, 0].copy_(eps[0])
            u[0].zero_()
            v[0].copy_(eps[1])
            return
        p = self.model.noise_dims
        drawn = draw_proposals(tuple(props.shape), p, self._gen)
        normal = torch.randn(tuple(v.shape), generator=self._gen)
        for dst, src in zip(self._noise, drawn + (normal,)):
            dst.copy_(src)

    def _chunked(self, fn, *arrays):
        """Each chunk copied into the static input of ``fn``'s surface, the
        surface replayed, its outputs copied out."""
        name = self._surface[fn]
        outs = []
        with torch.inference_mode():
            for chunks in self._chunks(*arrays):
                (self._z if name == "decode" else self._x).copy_(chunks[0])
                if name == "encode":
                    self._stage_noise(chunks[1:])
                out = self._run(name)
                outs.append(tuple(o.cpu() for o in out)
                            if isinstance(out, tuple) else out.cpu())
        return self._gather(outs, arrays[0].shape[0])
