"""Sphere-cube image datasets as the port's generator writes them.

Counterpart of ``ShapeDataset`` and ``SphereCubeDataset`` in the JAX
package's ``data/shapes.py``. The JAX datasets read a directory of PNG
files named by their pose quaternion; the port's read what
``cli/gen_spherecube.py`` writes, so that no image library is needed:

- ``images.npy``: uint8 (N, 64, 64, 3), each image quantised as the JAX
  generator writes its PNGs, ``(img * 255).astype(np.uint8)``;
- ``_poses.npz``: the pose manifest (``r`` (N, 1, 3, 3), ``q`` (N, 1, 4),
  ``meta``, ``step_size``, ``style``), as the JAX generator writes it.

Item i is the JAX dataset's item i: its files sort in pose order. The pose
label is the quaternion read back at the 4 decimals of the JAX file name,
then mapped to a rotation. ``subsample`` draws the same items (numpy seed 0
with the global state saved and restored). Batches come out as
``(names, poses, images)`` with uint8 images; the train step scales them to
[0, 1] on the device.
"""
import os

import numpy as np

from lie_vae_tpu_torch.data._np_ops import quaternions_to_group_matrix_np

IMAGES = "images.npy"
POSES = "_poses.npz"


def pose_labels(q):
    """(N, 4) quaternions -> (N, 3, 3) float32 rotations, the quaternion
    first rounded as the JAX dataset reads it back from its file names
    (``'{:.4f}'``)."""
    q = np.asarray([[float(f"{float(x):.4f}") for x in row]
                    for row in np.asarray(q).reshape(-1, 4)])
    return quaternions_to_group_matrix_np(q)


class ShapeDataset:
    """Reference: ShapeDataset, datasets.py:15-84. Greyscale unless the
    subclass sets ``rgb``: then the channel mean of each image, as the JAX
    dataset loads a greyscale item."""
    rgb = False
    single_id = False

    def __init__(self, directory, subsample=1.0):
        self.directory = directory
        path = os.path.join(directory, IMAGES)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found: render the dataset first, e.g. "
                "python -m lie_vae_tpu_torch.cli.gen_spherecube 2048 "
                f"{directory} --singles")
        images = np.load(path)
        with np.load(os.path.join(directory, POSES)) as f:
            q = f["q"]
        if q.shape[1] != 1:
            raise NotImplementedError(
                f"{directory} holds pose pairs (sc-pairs), which the port "
                "does not load yet (ROADMAP.md, Queue A, A6)")
        if images.dtype != np.uint8 or images.ndim != 4 \
                or images.shape[0] != q.shape[0]:
            raise ValueError(f"{path}: expected uint8 (N, H, W, 3) for "
                             f"{q.shape[0]} poses, got {images.dtype} "
                             f"{images.shape}")
        if not self.rgb:
            images = np.round((images.astype(np.float32) / 255.0).mean(-1)
                              * 255.0).astype(np.uint8)[..., None]
        self.images = images
        self.poses = pose_labels(q[:, 0])
        self.indices = np.arange(len(images))
        if subsample < 1:
            # identical seed semantics to datasets.py:33-37
            state = np.random.get_state()
            np.random.seed(0)
            self.indices = np.random.choice(
                self.indices, int(len(self.indices) * subsample),
                replace=False)
            np.random.set_state(state)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        i = self.indices[idx]
        name = 0 if self.single_id else str(i)
        return name, self.poses[i], self.images[i].astype(np.float32) / 255.0

    def gather(self, indices):
        """Batch fetch: (names, poses (B, 3, 3), uint8 images (B, H, W, C))."""
        rows = self.indices[np.asarray(indices)]
        names = (np.zeros(len(rows), np.int32) if self.single_id
                 else rows.astype(str).astype(object))
        return names, self.poses[rows], self.images[rows]

    @staticmethod
    def prep_batch(batch):
        return batch


class SphereCubeDataset(ShapeDataset):
    """Reference: datasets.py:87-92."""
    rgb = True
    single_id = True

    def __init__(self, directory="data/spherecube", subsample=1.0):
        super().__init__(directory, subsample=subsample)
