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
``vmfq``. uint8 images are scaled to x / 255. Work runs in chunks of
``batch_size`` rows (the last chunk padded by repeating its last row, the
padding cut off again) under ``torch.inference_mode()`` and in IEEE float32
(``precision.ieee_float32``: no TF32), with the model in ``eval()`` so
BatchNorm uses its running statistics. Noise and prior poses are drawn from
a CPU ``torch.Generator`` seeded at construction, so a session on the GPU
and one on the CPU with the same seed draw the same numbers.

A chunk moves once each way through buffers the session keeps (pinned
when it serves a card): its rows are copied from the request into a
staging buffer of the request's dtype, which goes to the device in one
non_blocking copy; uint8 crosses as uint8 and is scaled on the device
(:func:`scale_uint8`, bit for bit numpy's ``x.astype(np.float32) /
255.0``); the outputs come back into output buffers, whose rows are
copied into the answer, fresh arrays of N rows. ``staged`` counts the
chunks so served by the request's dtype. A session serves one request at
a time (``serve_http`` serialises them behind a lock).

:class:`AotSession` serves an :func:`export_aot` artifact with no model
flags: on the card its fixed-batch encode, decode and reconstruct each
replay one CUDA graph, captured once.

Over a device mesh (``parallel.make_mesh(n, devices=...)``, the ``data``
axis only) a session holds one replica of the weights per device and
splits each chunk into contiguous shards, one per device, whose outputs are
concatenated: the same numbers as the single-device session, the noise
drawn for the whole chunk as one device draws it. An :func:`export_aot`
artifact records its ``data_devices``, and :class:`AotSession` rebuilds
over that many devices, one CUDA graph per surface and device.

Under a ``torch.profiler`` session every surface call is a
``session.request`` span of ``tracing``, with each chunk's stages as
children (``session.chunk``, ``.copy_in``, ``.normalize``, ``.replay``,
``.copy_out``, ``.gather``).

Typical use::

    model = flagship_model()
    sess = InferenceSession.from_torch("best.pt", model)
    sess.warmup()
    poses = sess.encode(images)["pose"]
    frames = sess.geodesic(poses[0], poses[1], steps=30)
"""
import copy
import functools
import json

import numpy as np
import torch

from lie_vae_tpu_torch import compat, ops, tracing
from lie_vae_tpu_torch.distributions.vmf import (NUM_PROPOSALS,
                                                 draw_proposals)
from lie_vae_tpu_torch.precision import ieee_float32


# x / 255 for each byte x, divided as numpy divides (``x.astype(np.float32)
# / 255.0``): a uint8 request is scaled on the device by looking its bytes
# up here, since CUDA's division by a host scalar multiplies by the
# reciprocal, which rounds 126 of the 256 quotients differently
BYTE_SCALE = np.arange(256, dtype=np.uint8).astype(np.float32) / 255.0


def scale_uint8(x, table, out):
    """The uint8 tensor ``x`` scaled into ``out``, of its shape on its
    device: ``table[x]``, with ``table`` :data:`BYTE_SCALE` there in
    ``out``'s dtype, so x / 255 bit for bit as numpy divides in float32."""
    torch.index_select(table, 0, x.reshape(-1).int(), out=out.view(-1))
    return out


def _request(surface):
    """A surface call is one request: a ``session.request`` span whose id
    is the session's count of requests."""
    @functools.wraps(surface)
    def call(self, *args, **kwargs):
        self._requests += 1
        with tracing.span("session.request", self._requests):
            return surface(self, *args, **kwargs)
    return call


def _data_devices(mesh, batch_size):
    """A serving mesh's devices, checked: a device mesh of the ``data``
    axis alone whose size divides the batch."""
    if mesh.distributed or mesh.shape["model"] != 1:
        raise ValueError(f"a session serves over a device mesh of the data "
                         f"axis alone, not {mesh}")
    n = mesh.shape["data"]
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} must be a multiple of the "
                         f"mesh's data size {n}")
    return mesh.devices


# ------------------------------------------------- the fixed-batch surface

def _posterior(stats):
    """(mean pose, spread) of a stats struct: the algebra-noise sigma for
    SO(3), kappa (B, 1) for vMF, sigma for the Gaussian."""
    if hasattr(stats, "mu_lie"):
        return stats.mu_lie, stats.inner.sigma
    if hasattr(stats, "kappa"):
        return stats.mu, stats.kappa
    return stats.mu, stats.sigma


def _encode(model, x, *noise):
    """A batch's posterior means, spreads and one sample each; ``noise`` in
    the layout of :meth:`InferenceSession._noise`."""
    eps = noise[0] if len(noise) == 1 else noise or None
    s = model.encode(x, n=1, eps=eps)[0]
    return (*_posterior(s), s.z[0])


def _decode(model, z):
    return model.decode(z[None])[0]


def _reconstruct(model, x):
    """A batch decoded from its posterior mean; the sample beside it takes
    fixed noise, so nothing is drawn."""
    dims, b = model.noise_dims, x.shape[0]
    if dims is None:
        eps = None
    elif model.is_vmf:
        eps = (torch.full((1, b), 0.5, device=x.device),
               torch.zeros((1, b, dims), device=x.device))
    else:
        eps = torch.zeros((1, b, dims), device=x.device)
    return _decode(model, _posterior(model.encode(x, eps=eps)[0])[0])


_SURFACES = {"encode": _encode, "decode": _decode,
             "reconstruct": _reconstruct}


def _pose_shape(model):
    return {"so3": (3, 3), "normal": (model.normal_dims,), "vmf": (4,),
            "vmfq": (4,)}[model.latent_mode]


class _Replica:
    """One device's share of a session: its model, its ``rows`` of every
    chunk, and device buffers at that share of the batch: the input ``x``,
    the poses ``z``, the uint8 input ``x8`` (scaled into ``x`` by
    ``table``, :data:`BYTE_SCALE` there in ``x``'s dtype) and the noise in
    the layout of :meth:`InferenceSession._noise`. ``run`` replays the
    surface's CUDA graph where :meth:`capture` took one, and otherwise
    calls the surface function over the buffers."""

    def __init__(self, model, rows, device):
        self.model, self.rows, self.device = model, rows, device
        b, dims = rows.stop - rows.start, model.noise_dims
        self.x = torch.zeros((b,) + tuple(model.out_shape), device=device)
        self.x8 = torch.zeros(self.x.shape, dtype=torch.uint8, device=device)
        self.table = torch.from_numpy(BYTE_SCALE).to(device, self.x.dtype)
        self.z = torch.zeros((b,) + _pose_shape(model), device=device)
        if dims is None:
            self.noise = ()
        elif model.is_vmf:
            self.noise = (
                torch.full((NUM_PROPOSALS, 1, b), 0.5, device=device),
                torch.ones((NUM_PROPOSALS, 1, b), device=device),
                torch.zeros((1, b, dims), device=device))
        else:
            self.noise = (torch.zeros((1, b, dims), device=device),)
        self.graphs = {}
        self.replays = dict.fromkeys(_SURFACES, 0)

    def _call(self, surface):
        x = self.z if surface == "decode" else self.x
        noise = self.noise if surface == "encode" else ()
        return _SURFACES[surface](self.model, x, *noise)

    def capture(self):
        """One CUDA graph per surface over the buffers, each on its own
        memory pool, in IEEE float32, after two eager runs on a side stream
        (they build the kernels and pick cuDNN's algorithms); raises if a
        capture fails."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.inference_mode(), ieee_float32(), \
                torch.cuda.device(self.device):
            with torch.cuda.stream(side):
                for surface in _SURFACES:
                    for _ in range(2):
                        self._call(surface)
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            for surface in _SURFACES:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = self._call(surface)
                self.graphs[surface] = (graph, out)

    def run(self, surface):
        """The surface's outputs over the buffers, on the replica's
        device."""
        card = self.device if self.device.type == "cuda" else -1
        with torch.cuda.device(card), \
                tracing.span("session.replay", device=True):
            if surface not in self.graphs:
                return self._call(surface)
            graph, out = self.graphs[surface]
            graph.replay()
        self.replays[surface] += 1
        return out


class InferenceSession:
    """Fixed-batch inference over a trained model with any of the four
    latents (``so3``, ``normal``, ``vmf``, ``vmfq``) on ``device``, or over
    a ``mesh`` (``parallel.make_mesh``: the batch split over its ``data``
    devices, one replica of the weights on each; ``device`` is then its
    first device)."""

    def __init__(self, model, state_dict, batch_size=64, seed=0,
                 device="cuda", mesh=None):
        batch_size = int(batch_size)
        devices = ([torch.device(device)] if mesh is None
                   else _data_devices(mesh, batch_size))
        model = model.to(devices[0]).eval()
        model.load_state_dict(state_dict, strict=True)
        self.mesh = mesh
        self._start([model] + [copy.deepcopy(model).to(d).eval()
                               for d in devices[1:]],
                    devices, batch_size, seed)

    def _start(self, models, devices, batch_size, seed):
        """Serve ``models``, one on each of ``devices``: each chunk is split
        into one contiguous shard a device, a :class:`_Replica` each."""
        self.batch_size = batch_size
        self.model, self.device = models[0], devices[0]
        per = batch_size // len(devices)
        self._replicas = [_Replica(m, slice(i * per, (i + 1) * per), d)
                          for i, (m, d) in enumerate(zip(models, devices))]
        self._cards = list(dict.fromkeys(d for d in devices
                                         if d.type == "cuda"))
        self._gen = torch.Generator(device="cpu").manual_seed(seed)
        self._requests = 0
        self._held = {}
        self._copying = []
        self.staged = {"uint8": 0, "float32": 0}

    @classmethod
    def from_torch(cls, path, model, batch_size=64, seed=0, device="cuda",
                   mesh=None):
        """Serve a reference PyTorch checkpoint (a saved state_dict)."""
        return cls(model, compat.load_torch(path), batch_size=batch_size,
                   seed=seed, device=device, mesh=mesh)

    @classmethod
    def from_checkpoint(cls, path, model, batch_size=64, seed=0,
                        device="cuda", mesh=None):
        """Serve the model of a training checkpoint
        (``train.checkpoint.save_state``)."""
        from lie_vae_tpu_torch.train.checkpoint import load_checkpoint
        return cls(model, load_checkpoint(path)["model"],
                   batch_size=batch_size, seed=seed, device=device,
                   mesh=mesh)

    @classmethod
    def from_npz(cls, path, model, batch_size=64, seed=0, device="cuda",
                 mesh=None):
        """Serve a JAX deployment artifact (``.npz`` of flat paths), the JAX
        package's or :func:`export_npz`'s."""
        return cls(model, compat.state_dict_from_jax(compat.load_npz(path),
                                                     model),
                   batch_size=batch_size, seed=seed, device=device,
                   mesh=mesh)

    # ------------------------------------------------------------ plumbing

    def _keep(self, key, shape, dtype):
        """The session's host buffer ``key`` (made on first use), pinned
        when the session serves a card."""
        key = (key, tuple(shape), dtype)
        buf = self._held.get(key)
        if buf is None:
            buf = self._held[key] = torch.empty(
                shape, dtype=dtype, pin_memory=self.device.type == "cuda")
        return buf

    def _stage(self, arrays, lo):
        """Rows ``lo:lo + batch_size`` of each row-aligned request array
        copied into the session's staging buffer of its dtype (uint8 as it
        came, anything else as float32) at the batch shape, the short last
        chunk padded by repeating its last row. A buffer is written only
        once the copies out of it have finished."""
        with tracing.span("session.chunk"):
            for event in self._copying:
                event.synchronize()
            staged = []
            for j, a in enumerate(arrays):
                rows = a[lo:lo + self.batch_size]
                dtype = torch.uint8 if a.dtype == np.uint8 else torch.float32
                buf = self._keep(("in", j), (self.batch_size,) + a.shape[1:],
                                 dtype)
                host = buf.numpy()
                host[:len(rows)] = rows
                host[len(rows):] = rows[-1]
                staged.append(buf)
            self.staged[str(staged[0].dtype).removeprefix("torch.")] += 1
        return staged

    def _noise(self, eps):
        """A chunk's noise on the host, in the replicas' layout: nothing
        for a deterministic model; a normal's (1, B, d) from the staged
        ``eps``; for vMF the sampler's proposals and uniforms
        (NUM_PROPOSALS, 1, B) and the tangent normal (1, B, 4), drawn from
        the session's generator in the order the model draws them, or,
        with the staged ``eps`` (accepted draw (B,), tangent normal
        (B, 4)), the given draw as the first proposal with uniform 0, which
        accepts it."""
        m, b = self.model, self.batch_size
        if m.noise_dims is None:
            return ()
        if not m.is_vmf:
            return (eps[0][None],)
        if not eps:
            return draw_proposals((NUM_PROPOSALS, 1, b), m.noise_dims,
                                  self._gen) + (
                torch.randn((1, b, m.noise_dims), generator=self._gen),)
        props = torch.full((NUM_PROPOSALS, 1, b), 0.5)
        u = torch.ones((NUM_PROPOSALS, 1, b))
        props[0, 0], u[0] = eps[0], 0.0
        return props, u, eps[1][None]

    def _copy_in(self, surface, staged):
        """Each replica's rows of the staged chunk written into its device
        buffers, one non_blocking copy each: float32 straight into the
        surface's input, uint8 into ``x8`` and scaled from there into
        ``x``; for ``encode`` also the chunk's :meth:`_noise`."""
        noise = self._noise(staged[1:]) if surface == "encode" else ()
        for r in self._replicas:
            x = staged[0][r.rows]
            dst = (r.x8 if x.dtype == torch.uint8
                   else r.z if surface == "decode" else r.x)
            if x.shape != dst.shape:
                raise ValueError(f"{surface} takes rows of shape "
                                 f"{tuple(dst.shape[1:])}, not "
                                 f"{tuple(x.shape[1:])}")
            with tracing.span("session.copy_in"):
                dst.copy_(x, non_blocking=True)
                mine = ([t[..., r.rows] for t in noise[:-1]]
                        + [t[:, r.rows] for t in noise[-1:]])
                for buf, t in zip(r.noise, mine):
                    buf.copy_(t, non_blocking=True)
            with tracing.span("session.normalize"):
                if dst is r.x8:
                    scale_uint8(r.x8, r.table, r.x)

    def _copy_out(self, outs):
        """The replicas' outputs (each a tensor or a tuple of them) copied,
        non_blocking, into their rows of the session's output buffers at the
        batch shape, then one wait for the devices: the buffers as numpy."""
        host = []
        for r, out in zip(self._replicas, outs):
            for k, o in enumerate(out if isinstance(out, tuple) else (out,)):
                if k == len(host):
                    host.append(self._keep(
                        ("out", k), (self.batch_size,) + o.shape[1:],
                        o.dtype))
                host[k][r.rows].copy_(o, non_blocking=True)
        for dev in self._cards:
            torch.cuda.current_stream(dev).synchronize()
        return [h.numpy() for h in host]

    def _chunked(self, surface, *arrays):
        """The fixed-batch ``surface`` over full ``batch_size`` chunks of
        the row-aligned ``arrays``: its outputs, an array or a tuple of
        them, of the request's N rows. Each chunk's rows are staged on the
        host (:meth:`_stage`), copied into the replicas' buffers and scaled
        there if uint8 (:meth:`_copy_in`), run on every replica
        (:meth:`_Replica.run`), copied back (:meth:`_copy_out`) and written
        into the answer, fresh arrays of N rows made at the first chunk."""
        n = arrays[0].shape[0]
        if n == 0:
            raise ValueError("empty request (0 rows)")
        answer = None
        with torch.inference_mode():
            for lo in range(0, n, self.batch_size):
                self._copy_in(surface, self._stage(arrays, lo))
                self._copying = []
                for dev in self._cards:
                    self._copying.append(torch.cuda.Event())
                    self._copying[-1].record(torch.cuda.current_stream(dev))
                outs = [r.run(surface) for r in self._replicas]
                with tracing.span("session.copy_out"):
                    host = self._copy_out(outs)
                with tracing.span("session.gather"):
                    if answer is None:
                        answer = tuple(np.empty((n,) + h.shape[1:], h.dtype)
                                       for h in host)
                    rows = min(self.batch_size, n - lo)
                    for a, h in zip(answer, host):
                        a[lo:lo + rows] = h[:rows]
        return answer if len(answer) > 1 else answer[0]

    # ------------------------------------------------------------- surface

    @_request
    @ieee_float32()
    def encode(self, images, eps=None):
        """Posterior of N inputs: ``{"pose": (N, ...) posterior means,
        "sigma": (N, ...) spreads (kappa (N, 1) for vMF), "sample": (N, ...)
        one posterior sample}``. ``eps`` fixes the sample's noise: a
        standard normal (N, noise_dims), or for vMF the pair (accepted Beta
        draw (N,), tangent normal (N, 4)); otherwise the session's generator
        draws it (a deterministic model draws none and samples its
        mean)."""
        x = np.asarray(images)
        m = self.model
        if eps is None and m.noise_dims is not None and not m.is_vmf:
            eps = torch.randn((x.shape[0], m.noise_dims),
                              generator=self._gen).numpy()
        parts = (() if eps is None or m.noise_dims is None
                 else eps if m.is_vmf else (eps,))
        pose, sigma, sample = self._chunked(
            "encode", x, *(np.asarray(e, np.float32) for e in parts))
        return {"pose": pose, "sigma": sigma, "sample": sample}

    @_request
    @ieee_float32()
    def decode(self, poses):
        """Decode N poses (the model's latent representation) to outputs
        (N, *out_shape)."""
        return self._decode_poses(poses)

    def _decode_poses(self, poses):
        return self._chunked("decode", np.asarray(poses, np.float32))

    @_request
    @ieee_float32()
    def reconstruct(self, images):
        """Encode to the posterior mean, then decode: the autoencoder
        path."""
        return self._chunked("reconstruct", np.asarray(images))

    @_request
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
        return self._decode_poses(z.numpy())

    @_request
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
        return self._decode_poses(poses) if decode else poses

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

def _jsonable(value):
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return value.tolist() if isinstance(value, np.ndarray) else value


def _aot_meta(model, batch_size, data_devices=1):
    """``__aot_meta__``: a uint8 JSON blob with the JAX package's keys, the
    torch version and ``model``, the ``LieVAE`` constructor's keywords."""
    if model.r_callback is not None:
        raise ValueError("a model with r_callback cannot be rebuilt from "
                         "its keywords")
    if batch_size % data_devices:
        raise ValueError(f"batch_size {batch_size} must be a multiple of the "
                         f"mesh's data size {data_devices}")
    meta = {"latent_mode": model.latent_mode,
            "normal_dims": model.normal_dims,
            "out_shape": list(model.out_shape),
            "batch_size": int(batch_size), "platforms": ["cuda"],
            "data_devices": int(data_devices),
            "torch_version": torch.__version__,
            "model": {k: _jsonable(v) for k, v in model.config.items()}}
    return {"__aot_meta__": np.frombuffer(json.dumps(meta).encode(),
                                          np.uint8)}


def _mesh_data(mesh):
    if mesh is None:
        return 1
    if mesh.shape["model"] != 1:
        raise ValueError(f"an ahead-of-time artifact splits the batch only: "
                         f"{mesh} has a model axis")
    return mesh.shape["data"]


def export_aot(checkpoint_path, model, out_path, batch_size=64, mesh=None):
    """An ahead-of-time serving artifact of a training checkpoint
    (``checkpoint.pt``): :func:`export_npz`'s layout (flat ``params/...``
    and ``batch_stats/...`` paths, ``__step__``) and ``__aot_meta__``, a
    uint8 JSON blob with the JAX package's keys (``latent_mode``,
    ``normal_dims``, ``out_shape``, ``batch_size``, ``platforms``,
    ``data_devices``: the ``data`` size of ``mesh``, 1 without one), the
    torch version and ``model``, the ``LieVAE`` constructor's keywords,
    from which :class:`AotSession` rebuilds the model with no flags. The
    batch must be a multiple of ``data_devices``.

    The port writes no programs: there is no StableHLO (``__aot_encode__``
    and its siblings) in the artifact, so the JAX package's ``AotSession``
    cannot serve it (its weights load in the JAX package's ``load_npz``).
    :class:`AotSession` captures the programs on the card instead, as CUDA
    graphs at ``batch_size`` (over ``data_devices`` devices, one graph per
    device at its shard of the batch)."""
    from lie_vae_tpu_torch.train.checkpoint import load_checkpoint
    ckpt = load_checkpoint(checkpoint_path)
    return _save_npz(out_path, ckpt["model"], model, int(ckpt["step"]),
                     _aot_meta(model, batch_size, _mesh_data(mesh)))


def export_aot_from_torch(torch_path, model, out_path, batch_size=64,
                          mesh=None):
    """Like :func:`export_aot`, from a reference PyTorch checkpoint (a
    ``torch.save``'d state_dict); the step is 0."""
    return _save_npz(out_path, compat.load_torch(torch_path), model, 0,
                     _aot_meta(model, batch_size, _mesh_data(mesh)))


def serving_devices(n, device="cuda"):
    """``n`` devices to serve over (a session's mesh, or an artifact
    exported over ``n`` data devices): the first ``n`` cards (raising, with
    both counts, on a machine with fewer), or ``n`` CPU replicas."""
    if torch.device(device).type != "cuda":
        return [torch.device("cpu")] * n
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"serving over {n} data devices needs {n} cards, "
                         f"this machine has {have} card(s)")
    return [torch.device("cuda", i) for i in range(n)]


class AotSession(InferenceSession):
    """Serving over an :func:`export_aot` artifact, with no model flags: the
    model is rebuilt from the artifact's ``model`` keywords. The surface is
    :class:`InferenceSession`'s, answers included: a session of the same
    weights and seed returns the same numbers.

    On the card each fixed-batch surface (``encode``, ``decode``,
    ``reconstruct``; ``sample`` and ``geodesic`` decode) is one CUDA graph
    a replica (:meth:`_Replica.capture`), captured once at construction
    over the replica's buffers and replayed for every chunk; a capture that
    fails raises. Noise is drawn outside the graph, from the session's CPU
    generator as :class:`InferenceSession` draws it, into the buffers: for
    vMF the sampler's proposals and uniforms, the pick against kappa
    staying inside the graph. The kernels count a launch at capture and
    none at a replay; ``replays`` counts each surface's replays (one per
    device and chunk). On the CPU the same fixed-batch functions run
    eagerly over the same buffers. ``close()`` frees the graphs (the
    session then runs eagerly).

    An artifact exported over ``data_devices`` devices is served over as
    many: ``devices`` (default :func:`serving_devices`, which raises on a
    machine with fewer cards; ``device="cpu"`` gives CPU replicas), one
    replica and one graph per surface on each, every chunk split into
    contiguous shards.

    The JAX package's AOT artifacts hold StableHLO programs and no model
    keywords; given one, this raises."""

    def __init__(self, path, seed=0, device="cuda", devices=None):
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
        n = int(meta.get("data_devices", 1))
        devices = [torch.device(d) for d in
                   (devices if devices is not None
                    else serving_devices(n, device))]
        if len(devices) != n:
            raise ValueError(f"{path} was exported over {n} data devices; "
                             f"{len(devices)} given")
        weights = {k: v for k, v in flat.items() if not k.startswith("__")}
        models = []
        for d in devices:
            model = LieVAE(**meta["model"], device=d)
            model.load_state_dict(compat.state_dict_from_jax(weights, model),
                                  strict=True)
            models.append(model.eval())
        self.meta, self.mesh = meta, None
        self._start(models, devices, int(meta["batch_size"]), seed)
        for r in self._replicas:
            if r.device.type == "cuda":
                r.capture()

    @property
    def replays(self):
        """Each surface's graph replays, one per device and chunk."""
        return {s: sum(r.replays[s] for r in self._replicas)
                for s in _SURFACES}

    def close(self):
        """Free the graphs and their memory pools."""
        for r in self._replicas:
            r.graphs.clear()
