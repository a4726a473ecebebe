"""The port's data pipeline held against the JAX package's, bit for bit.

- the renderer: the port's ``render_spherecube`` against the JAX package's
  ``render_spherecube(..., backend='numpy')``, 8 poses of each style,
  quantised as both generators quantise (``(img * 255).astype(np.uint8)``):
  equal bytes;
- the generated dataset: the first poses of ``data_poses/spherecube.npz``
  rendered by the JAX generator (PNG files, numpy backend) and by the
  port's (``images.npy``), read by each package's ``SphereCubeDataset``,
  whole and subsampled: the same items in the same order, equal uint8
  images and equal pose labels;
- ``random_split`` and ``BatchLoader``: the JAX package's indices exactly,
  over several epochs, with and without shuffling and the ragged tail.
"""
import os

import numpy as np
import pytest

from lie_vae_tpu.cli import gen_spherecube as jgen
from lie_vae_tpu.data import BatchLoader as JaxBatchLoader
from lie_vae_tpu.data import SphereCubeDataset as JaxSphereCubeDataset
from lie_vae_tpu.data import random_split as jax_random_split
from lie_vae_tpu.data import render as jrender
from lie_vae_tpu_torch.cli import gen_spherecube
from lie_vae_tpu_torch.data import (BatchLoader, SphereCubeDataset,
                                    random_split, render_spherecube)
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(ROOT, "data_poses", "spherecube.npz")
N = 24


def _poses(n, offset=0):
    with np.load(MANIFEST) as f:
        return f["r"][offset:offset + n, 0]


@pytest.mark.parametrize("style", ["v1", "v2"])
def test_renderer_gives_the_jax_bytes(style):
    r = _poses(8, offset=100)
    want = jrender.render_spherecube(r, style=style, backend="numpy")
    got = render_spherecube(r, style=style)
    assert got.dtype == np.float32 and got.shape == (8, 64, 64, 3)
    np.testing.assert_array_equal((got * 255).astype(np.uint8),
                                  (want * 255).astype(np.uint8))
    np.testing.assert_array_equal(render_spherecube(r[0], style=style),
                                  got[0])


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same N poses rendered by each package's generator."""
    root = tmp_path_factory.mktemp("renders")
    jdir, tdir = str(root / "jax" / "spherecube"), str(root / "port" /
                                                       "spherecube")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrender, "_NATIVE", None)        # the numpy ray-caster
        jgen.generate(N, jdir, 0.0, pairs=False, from_poses=MANIFEST)
    images = gen_spherecube.generate(N, tdir)        # the pinned manifest
    return jdir, tdir, images


@pytest.mark.parametrize("subsample", [1.0, 0.5])
def test_dataset_matches_jax(datasets, subsample):
    jdir, tdir, images = datasets
    jset = JaxSphereCubeDataset(jdir, subsample=subsample)
    tset = SphereCubeDataset(tdir, subsample=subsample)
    assert len(tset) == len(jset) == int(N * subsample)
    # item i of the JAX dataset is the file of pose index int(name[:6])
    want_idx = [int(os.path.basename(f)[:6]) for f in jset.files]
    np.testing.assert_array_equal(tset.indices, want_idx)
    idx = np.arange(len(jset))[::-1]
    jnames, jposes, jimgs = jset.gather(idx)
    tnames, tposes, timgs = tset.gather(idx)
    assert timgs.dtype == np.uint8
    np.testing.assert_array_equal(timgs, jimgs)
    np.testing.assert_array_equal(tposes, jposes)
    np.testing.assert_array_equal(tnames, jnames)
    if subsample == 1.0:
        np.testing.assert_array_equal(images, timgs[::-1])


def test_missing_renders_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="gen_spherecube"):
        SphereCubeDataset(str(tmp_path))


class _Items:
    """A dataset of n items whose gather returns the indices."""
    num_workers = 0

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def gather(self, indices):
        return (np.asarray(indices),)


@pytest.mark.parametrize("lengths", [[4, 5, 11], [7, 7, 6], [0, 3, 17]])
def test_random_split_matches_jax(lengths):
    want = [s.indices for s in jax_random_split(_Items(20), lengths)]
    got = [s.indices for s in random_split(_Items(20), lengths)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    state = np.random.get_state()[1].copy()
    random_split(_Items(20), lengths)
    np.testing.assert_array_equal(np.random.get_state()[1], state)


@pytest.mark.parametrize("shuffle,drop_last,seed", [
    (True, True, 0), (True, False, 3), (False, False, 0), (False, True, 0)])
def test_batch_loader_matches_jax(shuffle, drop_last, seed):
    items = _Items(23)
    jl = JaxBatchLoader(items, 5, shuffle=shuffle, drop_last=drop_last,
                        seed=seed)
    tl = BatchLoader(items, 5, shuffle=shuffle, drop_last=drop_last,
                     seed=seed)
    assert len(tl) == len(jl)
    for _ in range(3):                  # the permutation changes per epoch
        want = [b[0] for b in jl]
        got = [b[0] for b in tl]
        assert len(got) == len(want)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
