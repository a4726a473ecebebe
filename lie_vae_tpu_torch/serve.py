"""Serving: a trained :class:`~lie_vae_tpu_torch.models.LieVAE` behind
fixed-batch ``encode`` / ``decode`` / ``reconstruct`` / ``sample`` /
``geodesic``.

Counterpart of ``InferenceSession`` in the JAX package's ``serve.py``.
Requests and answers are numpy arrays of any leading size N, NHWC images
and (N, 3, 3) poses. Work runs in chunks of ``batch_size`` rows (the last
chunk padded by repeating its last row, the padding cut off again) under
``torch.inference_mode()``, with the model in ``eval()`` so BatchNorm uses
its running statistics. Noise and Haar poses are drawn from a CPU
``torch.Generator`` seeded at construction, so a session on the GPU and one
on the CPU with the same seed draw the same numbers.

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


class InferenceSession:
    """Fixed-batch inference over a trained model on ``device``."""

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
        """Serve a JAX deployment artifact (``.npz`` of flat paths)."""
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

    def _encode(self, x, eps):
        s = self.model.encode(x, n=1, eps=eps[None])[0]
        return s.mu_lie, s.inner.sigma, s.z[0]

    def _decode(self, z):
        return self.model.decode(z[None])[0]

    # ------------------------------------------------------------- surface

    def encode(self, images, eps=None):
        """Posterior of N images: ``{"pose": (N, 3, 3) mean rotations,
        "sigma": (N, 3) algebra noise scales, "sample": (N, 3, 3) one
        posterior sample}``. ``eps`` (N, 3) standard normal fixes the
        sample's noise; otherwise the session's generator draws it."""
        x = self._normalize(images)
        if eps is None:
            eps = torch.randn((x.shape[0], 3), generator=self._gen).numpy()
        pose, sigma, sample = self._chunked(
            self._encode, x, np.asarray(eps, np.float32))
        return {"pose": pose, "sigma": sigma, "sample": sample}

    def decode(self, poses):
        """Decode N rotations (N, 3, 3) to NHWC images."""
        return self._chunked(self._decode, np.asarray(poses, np.float32))

    def reconstruct(self, images):
        """Encode to the posterior mean, then decode: the autoencoder path."""
        def recon(x):
            eps = torch.zeros((1, x.shape[0], 3), device=x.device)
            return self._decode(self.model.encode(x, eps=eps)[0].mu_lie)
        return self._chunked(recon, self._normalize(images))

    def sample(self, n, seed=None):
        """Decode n Haar-random poses, drawn from a generator seeded with
        ``seed`` or else from the session's."""
        gen = (torch.Generator(device="cpu").manual_seed(seed)
               if seed is not None else self._gen)
        z = ops.random_group_matrices(n, generator=gen, device="cpu")
        return self.decode(z.numpy())

    def geodesic(self, pose_a, pose_b, steps=16, decode=True):
        """Poses r(t) = a exp(t log(a^T b)) at ``steps`` points of [0, 1],
        the bi-invariant geodesic from a to b; decoded to frames
        (steps, 64, 64, C) unless ``decode=False``."""
        with torch.inference_mode():
            a = torch.as_tensor(np.asarray(pose_a, np.float32),
                                device=self.device)
            b = torch.as_tensor(np.asarray(pose_b, np.float32),
                                device=self.device)
            t = torch.linspace(0.0, 1.0, steps, device=self.device)
            v = ops.vee(ops.logmap(a.T @ b))
            poses = (a @ ops.expmap(t[:, None] * v)).cpu().numpy()
        return self.decode(poses) if decode else poses

    def warmup(self):
        """Run every serving path once at the batch shape (on the GPU this
        builds the CUDA kernels and picks cuDNN's algorithms)."""
        x = np.zeros((self.batch_size,) + self.model.out_shape, np.float32)
        self.decode(self.encode(x)["pose"])
        self.reconstruct(x)
        return self
