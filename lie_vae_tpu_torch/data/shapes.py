"""Image-folder datasets with pose labels parsed from filenames.

Counterpart of the JAX package's ``data/shapes.py`` (reference:
lie_vae/experiments/datasets.py:15-127), with its layout and semantics, so
a directory rendered by either package, or by the reference's Blender
pipeline, reads the same in both: the index is ``files.txt`` or a
recursive jpg/png glob, sorted; ``subsample`` draws with numpy seed 0,
the global state restored; the pose label is the quaternion in the file
name (the same regex); items are decoded once into a uint8 cache, and
``warm_cache`` backs that cache with the JAX package's disk cache
(``_decoded_cache_v2.npz``: the same key and arrays, so a cache that one
package writes the other reads).

PNG files are decoded by the port's own reader (``data/png.py``), which
gives the array PIL gives; ``.jpg`` files through PIL when it imports,
else they raise. Batches come out as ``(names, poses, images)`` with
uint8 images; the train step scales them to [0, 1] on the device.
"""
import hashlib
import os
import re
import zipfile
from glob import glob

import numpy as np

from lie_vae_tpu_torch.data._np_ops import quaternions_to_group_matrix_np
from lie_vae_tpu_torch.data.png import read_png

_QUAT_RE = re.compile(r"-?[01]\.[0-9]{4}")
_NAME_RE = re.compile(r"([A-z0-9]+)\.obj")


def filename_to_quaternion(filename):
    """Pose label from filename: four '-x.xxxx' floats.

    Reference: datasets.py:67-72 (same regex).
    """
    matches = _QUAT_RE.findall(filename)
    if len(matches) != 4:
        raise ValueError("No quaternion found in " + filename)
    return [float(x) for x in matches]


def filename_to_name(filename):
    match = _NAME_RE.search(filename)
    if match is None:
        raise ValueError("Could not find object id from filename "
                         + filename)
    return match.group(1)


def count_renders(directory):
    """Number of rendered images under ``directory`` (0 if absent).

    Counts only jpg/png files: dataset directories also hold other files
    (the pose manifest, the persistent decode cache).
    """
    if not os.path.isdir(directory):
        return 0
    return (len(glob(os.path.join(directory, "**/*.jpg"), recursive=True))
            + len(glob(os.path.join(directory, "**/*.png"), recursive=True)))


def _decode(path):
    """The uint8 array of an image file, as ``np.asarray`` of PIL's image."""
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: no decoder for this format (the port reads PNG "
            "itself; JPEG needs PIL, which is not installed)") from e
    return np.asarray(Image.open(path))


def _load_image(path, rgb):
    img = np.asarray(_decode(path), dtype=np.float32) / 255.0
    if rgb:
        return img[:, :, :3]                       # HWC
    if img.ndim == 3:                              # mean if RGB
        img = img.mean(-1)
    return img[:, :, None]                         # HW1


class ShapeDataset:
    """Reference: ShapeDataset, datasets.py:15-84.

    ``cache=True`` (default) decodes each image once into uint8 and keeps
    it. The cache is a dict that the loader's threads fill; each fill is
    one assignment of a finished tuple, so a reader sees an item whole or
    not at all.
    """
    num_workers = 5
    rgb = False
    single_id = False

    def __init__(self, directory, subsample=1.0, cache=True):
        self.directory = directory
        self._cache_enabled = cache
        self._cache = {}
        index_path = os.path.join(directory, "files.txt")
        if os.path.exists(index_path):
            with open(index_path) as f:
                self.files = f.read().splitlines()
            self.root = directory
        else:
            self.files = glob(os.path.join(directory, "**/*.jpg"),
                              recursive=True)
            self.files += glob(os.path.join(directory, "**/*.png"),
                               recursive=True)
            self.root = None
        self.files = sorted(self.files)
        if not self.files:
            raise FileNotFoundError(
                f"no images under {directory}: render the dataset first, "
                "e.g. python -m lie_vae_tpu_torch.cli.gen_spherecube 2048 "
                f"{directory} --singles")

        if subsample < 1:
            # identical seed semantics to datasets.py:33-37
            state = np.random.get_state()
            np.random.seed(0)
            self.files = list(np.random.choice(
                self.files, int(len(self.files) * subsample), replace=False))
            np.random.set_state(state)

    def __len__(self):
        return len(self.files)

    def _item_by_file_index(self, idx):
        idx = int(idx)
        if self._cache_enabled:
            hit = self._cache.get(idx)
            if hit is not None:
                name, group_el, img_u8 = hit
                return name, group_el, img_u8.astype(np.float32) / 255.0
        name, group_el, image = self.load_file(self.files[idx], self.root)
        if self._cache_enabled:
            self._cache[idx] = (name, group_el,
                                np.round(image * 255.0).astype(np.uint8))
        return name, group_el, image

    def __getitem__(self, idx):
        return self._item_by_file_index(idx)

    @classmethod
    def load_file(cls, filename, root):
        path = os.path.join(root, filename) if root else filename
        image = _load_image(path, cls.rgb)
        quaternion = filename_to_quaternion(filename)
        group_el = quaternions_to_group_matrix_np(np.asarray(quaternion))
        name = 0 if cls.single_id else filename_to_name(filename)
        return name, group_el, image

    # the JAX package's cache file; v2 stores the pose labels in the dtype
    # the fresh decode gives them, so warm and cold opens agree bit for bit
    _DISK_CACHE_NAME = "_decoded_cache_v2.npz"

    def _files_key(self):
        # filenames as listed + size + mtime: re-rendered pixels under the
        # same names must invalidate the cache too
        parts = []
        for f in self.files:
            path = os.path.join(self.root, f) if self.root else f
            try:
                st = os.stat(path)
                parts.append(f"{f}|{st.st_size}|{st.st_mtime_ns}")
            except OSError:
                parts.append(f)
        return hashlib.sha256("\n".join(parts).encode()).hexdigest()

    def _disk_cache_path(self):
        if not self.directory or not os.path.isdir(self.directory):
            return None
        return os.path.join(self.directory, self._DISK_CACHE_NAME)

    def warm_cache(self, persist=True):
        """Fill the uint8 decode cache for every file at once, backed by a
        persistent bulk cache on disk (``<dir>/_decoded_cache_v2.npz``).

        The cache is keyed by a hash of the (post-subsample) file list,
        each file's size and mtime, so a stale or foreign cache never
        serves wrong pixels: it is decoded again and overwritten. With
        ``persist`` a fresh decode writes the cache (atomically).
        """
        if not self._cache_enabled or len(self._cache) >= len(self.files):
            return
        n = len(self.files)
        path = self._disk_cache_path()
        key = self._files_key()
        if path and os.path.exists(path):
            try:
                with np.load(path, allow_pickle=False) as z:
                    if str(z["key"]) == key:
                        imgs, gs, names = z["imgs"], z["gs"], z["names"]
                        for i in range(n):
                            nm = (int(names[i]) if self.single_id
                                  else str(names[i]))
                            self._cache[i] = (nm, gs[i], imgs[i])
                        return
            except (OSError, EOFError, ValueError, KeyError,
                    zipfile.BadZipFile):
                pass   # unreadable or stale cache: decode again below
        for i in range(n):
            self._gather_one(i)
        if persist and path:
            names, gs, imgs = zip(*(self._cache[i] for i in range(n)))
            tmp = path + ".tmp.npz"   # ends in .npz so savez keeps the name
            np.savez(tmp, key=np.asarray(key),
                     names=np.asarray(
                         names, dtype=np.int32 if self.single_id else None),
                     gs=np.stack(gs, 0),
                     imgs=np.stack(imgs, 0))
            os.replace(tmp, path)

    def gather(self, indices):
        """Batch fetch: (names, poses (B, 3, 3), uint8 images (B, H, W, C))."""
        names, gs, imgs = zip(*[self._gather_one(i) for i in indices])
        return (np.asarray(names, dtype=object if not self.single_id
                           else np.int32),
                np.stack(gs, 0), np.stack(imgs, 0))

    def _gather_one(self, idx):
        idx = int(idx)
        if self._cache_enabled:
            hit = self._cache.get(idx)
            if hit is None:
                self._item_by_file_index(idx)   # fills the cache
                hit = self._cache[idx]
            return hit
        name, g, img = self.load_file(self.files[idx], self.root)
        return name, g, np.round(img * 255.0).astype(np.uint8)

    @staticmethod
    def prep_batch(batch):
        return batch


class SphereCubeDataset(ShapeDataset):
    """Reference: datasets.py:87-92."""
    rgb = True
    single_id = True

    def __init__(self, directory="data/spherecube", subsample=1.0):
        super().__init__(directory, subsample=subsample)


class ScPairsDataset(ShapeDataset):
    """Consecutive-pose pairs: item i is files (2i, 2i + 1) stacked on a
    pair axis; ``prep_batch`` flattens the pairs into the batch. Reference:
    datasets.py:95-127. ``subsample`` keeps the first fraction of a numpy
    seed-0 permutation of the pairs, numpy's global state restored."""
    rgb = True
    single_id = True

    def __init__(self, directory="data/sc-pairs", subsample=1.0):
        super().__init__(directory)
        n = len(self.files) // 2
        if subsample < 1:
            state = np.random.get_state()
            np.random.seed(0)
            self.indices = np.random.permutation(n)[:int(n * subsample)]
            np.random.set_state(state)
        else:
            self.indices = np.arange(n)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        idx = self.indices[idx]
        names, gs, imgs = zip(*[self._item_by_file_index(j)
                                for j in (2 * idx, 2 * idx + 1)])
        return (np.asarray(names, dtype=np.int32),
                np.stack(gs, 0), np.stack(imgs, 0))

    def gather(self, indices):
        """Batch fetch: (names (B, 2), poses (B, 2, 3, 3), uint8 images
        (B, 2, H, W, C))."""
        names, gs, imgs = zip(*[self._gather_pair(i) for i in indices])
        return np.stack(names, 0), np.stack(gs, 0), np.stack(imgs, 0)

    def _gather_pair(self, idx):
        idx = self.indices[idx]
        names, gs, imgs = zip(*[self._gather_one(j)
                                for j in (2 * idx, 2 * idx + 1)])
        return (np.asarray(names, dtype=np.int32), np.stack(gs, 0),
                np.stack(imgs, 0))

    @staticmethod
    def prep_batch(batch):
        """(B, 2, ...) pairs -> (2B, ...), pair i on rows 2i and 2i + 1
        (datasets.py:125-127)."""
        return [np.asarray(t).reshape((-1,) + np.shape(t)[2:])
                for t in batch]
