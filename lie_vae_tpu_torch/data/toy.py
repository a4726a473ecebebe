"""Toy dataset: a random spherical-harmonic spectrum rotated by Haar-random
group elements with the forward operator the action decoder learns.

Counterpart of ``ToyDataset`` in the JAX package's ``data/toy.py``
(reference: ``lie_vae/experiments/datasets.py:130-165``). The ``.npz`` file
has the JAX package's keys (``quaternions`` (N, 4), ``harmonics``
((L+1)^2, C), ``x`` (N, (L+1)^2, C), all float32), so a file written by
either package loads in the other. Generation draws the spectrum
(standard normal, scaled to Frobenius norm 10) and the Haar quaternions
from a seeded CPU ``torch.Generator``, then rotates the spectrum by each
pose with ``ops.block_wigner_matrix_multiply`` at ``impl='fused'``, in
batches of 512: on the card that is the Wigner chain kernel K1. JAX's
random bits cannot be reproduced here, so the same seed gives other
spectra and poses in the two packages.
"""
import os

import numpy as np
import torch

from lie_vae_tpu_torch import ops

DEFAULT_PATH = "data/toy.npz"


class ToyDataset:
    """In-memory (quaternions, harmonics, x) triples: item i is
    (q_i, harmonics, x_i), as the reference's TensorDataset of three."""
    num_workers = 0
    single_id = True
    rgb = False

    def __init__(self, tensors=None, path=DEFAULT_PATH):
        if tensors is None:
            with np.load(path) as data:
                tensors = (data["quaternions"], data["harmonics"], data["x"])
        q, harmonics, x = tensors
        self.quaternions = np.asarray(q, dtype=np.float32)
        self.harmonics = np.asarray(harmonics, dtype=np.float32)
        self.x = np.asarray(x, dtype=np.float32)

    def __len__(self):
        return self.x.shape[0]

    def __getitem__(self, idx):
        return (self.quaternions[idx], self.harmonics, self.x[idx])

    def gather(self, indices):
        """A batch by numpy fancy indexing (no per-item loop)."""
        idx = np.asarray(indices)
        return (self.quaternions[idx],
                np.broadcast_to(self.harmonics,
                                (len(idx),) + self.harmonics.shape),
                self.x[idx])

    @staticmethod
    def prep_batch(batch):
        return batch

    @classmethod
    def from_poses(cls, quaternions, harmonics, degrees, batch_size=512,
                   device="cuda"):
        """The dataset of the given quaternions (N, 4) and spectrum
        ((L+1)^2, C): x = W(quaternions_to_eazyz(q)) harmonics, computed on
        ``device`` in batches of ``batch_size`` (one launch of K1 each on
        the card)."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ToyDataset on device 'cuda': no CUDA card "
                               "is available (pass device='cpu')")
        q = torch.as_tensor(np.asarray(quaternions, np.float32))
        spec = torch.as_tensor(np.asarray(harmonics, np.float32),
                               device=device)
        xs = []
        with torch.no_grad():
            for lo in range(0, q.shape[0], batch_size):
                angles = ops.quaternions_to_eazyz(
                    q[lo:lo + batch_size].to(device)).contiguous()
                xs.append(ops.block_wigner_matrix_multiply(
                    angles, spec, degrees, impl="fused").cpu())
        return cls(tensors=(q.numpy(), spec.cpu().numpy(),
                            torch.cat(xs).numpy()))

    @classmethod
    def generate(cls, n=1000, degrees=6, rep_copies=10, seed=0,
                 batch_size=512, device="cuda"):
        """n Haar-random poses of one random spectrum, Frobenius norm 10
        (reference: ToyDataset.generate, datasets.py:142-158), drawn from a
        CPU generator seeded with ``seed`` (the same numbers on every
        device), rotated on ``device``."""
        gen = torch.Generator().manual_seed(seed)
        harmonics = torch.randn(((degrees + 1) ** 2, rep_copies),
                                generator=gen)
        harmonics = harmonics / torch.linalg.norm(harmonics) * 10.0
        q = ops.random_quaternions(n, generator=gen, device="cpu")
        return cls.from_poses(q.numpy(), harmonics.numpy(), degrees,
                              batch_size=batch_size, device=device)

    def save(self, path=DEFAULT_PATH):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, quaternions=self.quaternions,
                 harmonics=self.harmonics, x=self.x)
