"""Serving: a trained :class:`~lie_vae_tpu_torch.models.LieVAE` behind
fixed-batch ``encode`` / ``decode`` / ``reconstruct`` / ``sample`` /
``geodesic``, and the deployment artifacts it serves from.

Counterpart of ``InferenceSession``, ``export_npz`` and
``export_npz_from_torch`` in the JAX package's ``serve.py``. Requests and
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

Typical use::

    model = flagship_model()
    sess = InferenceSession.from_torch("best.pt", model)
    sess.warmup()
    poses = sess.encode(images)["pose"]
    frames = sess.geodesic(poses[0], poses[1], steps=30)
"""
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

    def _chunked(self, fn, *arrays):
        """Run ``fn`` on full ``batch_size`` chunks of the row-aligned
        ``arrays`` (moved to the device) and return its outputs, a tensor
        or a tuple of them, as numpy cut back to N rows."""
        n = arrays[0].shape[0]
        if n == 0:
            raise ValueError("empty request (0 rows)")
        b = self.batch_size
        outs = []
        with torch.inference_mode():
            for lo in range(0, n, b):
                chunks = []
                for a in arrays:
                    c = np.asarray(a[lo:lo + b])
                    if c.shape[0] < b:
                        c = np.concatenate(
                            [c, np.repeat(c[-1:], b - c.shape[0], axis=0)])
                    chunks.append(torch.as_tensor(c, device=self.device))
                out = fn(*chunks)
                outs.append(tuple(o.cpu().numpy() for o in out)
                            if isinstance(out, tuple) else
                            (out.cpu().numpy(),))
        res = tuple(np.concatenate(parts)[:n] for parts in zip(*outs))
        return res if len(res) > 1 else res[0]

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

def _save_npz(out_path, state_dict, model, step):
    flat = compat.state_dict_to_jax(state_dict, model)
    flat["__step__"] = np.asarray(step)
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
