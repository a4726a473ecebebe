"""The port's data pipeline held against the JAX package's, bit for bit.

- the renderer: the port's ``render_spherecube(..., backend='numpy')``
  against the JAX package's, 8 poses of each style, quantised as both
  generators quantise (``(img * 255).astype(np.uint8)``): equal bytes;
- PNG directories both ways: the first poses of ``data_poses/spherecube.npz``
  rendered by the JAX generator (PIL's PNG files, numpy backend) and by the
  port's (its own PNG files, numpy backend), each directory read by each
  package's ``SphereCubeDataset``, whole and subsampled: the same files,
  items, uint8 bytes, pose labels and names;
- ``files.txt`` directories of ``.obj``-named greyscale items for the
  base ``ShapeDataset`` (not single-id): the same names, labels and the
  greyscale channel means;
- the disk decode cache (``warm_cache``): the same key for the same
  directory string, a cache written by either package read by the other
  without a decode, a touched file forcing a fresh decode;
- ``random_split`` and ``BatchLoader``: the JAX package's indices exactly,
  over several epochs, with and without shuffling and the ragged tail; the
  threaded loader's batches equal to the serial loader's and to JAX's, its
  threads gone after an early stop; a stress run with more threads than
  cores and a short switch interval filling the decode cache;
- the Blender backend: the port's copy of the Blender script driven under
  the JAX tests' stand-in ``bpy`` (``tests/test_blender_script.py``), by
  itself and through ``gen_spherecube --blender``.
"""
import json
import os
import shutil
import sys
import threading

import numpy as np
import pytest
from PIL import Image

import test_blender_script as blender_test
import test_torch_port_modes as modes_test
from lie_vae_tpu.cli import gen_spherecube as jgen
from lie_vae_tpu.data import BatchLoader as JaxBatchLoader
from lie_vae_tpu.data import ShapeDataset as JaxShapeDataset
from lie_vae_tpu.data import SphereCubeDataset as JaxSphereCubeDataset
from lie_vae_tpu.data import count_renders as jax_count_renders
from lie_vae_tpu.data import random_split as jax_random_split
from lie_vae_tpu.data import render as jrender
from lie_vae_tpu.data import shapes as jshapes
from lie_vae_tpu_torch.cli import gen_spherecube
from lie_vae_tpu_torch.data import (BatchLoader, ShapeDataset,
                                    SphereCubeDataset, count_renders,
                                    random_split, render_spherecube)
from lie_vae_tpu_torch.data import shapes as tshapes
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
    got = render_spherecube(r, style=style, backend="numpy")
    assert got.dtype == np.float32 and got.shape == (8, 64, 64, 3)
    np.testing.assert_array_equal((got * 255).astype(np.uint8),
                                  (want * 255).astype(np.uint8))
    np.testing.assert_array_equal(
        render_spherecube(r[0], style=style, backend="numpy"), got[0])


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same N poses rendered by each package's generator, both with
    the numpy ray-caster (whose bytes the two packages share)."""
    root = tmp_path_factory.mktemp("renders")
    jdir, tdir = str(root / "jax" / "spherecube"), str(root / "port" /
                                                       "spherecube")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrender, "_NATIVE", None)        # the numpy ray-caster
        jgen.generate(N, jdir, 0.0, pairs=False, from_poses=MANIFEST)
    images = gen_spherecube.generate(N, tdir, backend="numpy")
    return jdir, tdir, images


@pytest.mark.parametrize("renders", ["jax", "port"])
@pytest.mark.parametrize("subsample", [1.0, 0.5])
def test_dataset_matches_jax(datasets, subsample, renders):
    """Either package's renders, read by both packages' datasets."""
    jdir, tdir, images = datasets
    d = jdir if renders == "jax" else tdir
    jset = JaxSphereCubeDataset(d, subsample=subsample)
    tset = SphereCubeDataset(d, subsample=subsample)
    assert len(tset) == len(jset) == int(N * subsample)
    assert tset.files == jset.files
    assert count_renders(d) == jax_count_renders(d) == N
    idx = np.arange(len(jset))[::-1]
    jnames, jposes, jimgs = jset.gather(idx)
    tnames, tposes, timgs = tset.gather(idx)
    assert timgs.dtype == np.uint8 and timgs.shape == jimgs.shape
    np.testing.assert_array_equal(timgs, jimgs)
    np.testing.assert_array_equal(tposes, jposes)
    assert tposes.dtype == jposes.dtype
    np.testing.assert_array_equal(tnames, jnames)
    for i in (0, len(jset) - 1):
        for w, g in zip(jset[i], tset[i]):
            np.testing.assert_array_equal(g, w)
    # item i of the dataset is the render of pose int(name[:6])
    rows = [int(os.path.basename(f)[:6]) for f in tset.files]
    np.testing.assert_array_equal(timgs[::-1], images[rows])


def test_the_port_writes_the_jax_layout(datasets):
    jdir, tdir, _ = datasets
    names = sorted(f for f in os.listdir(tdir) if f.endswith(".png"))
    assert names == sorted(f for f in os.listdir(jdir)
                           if f.endswith(".png"))
    with np.load(os.path.join(tdir, "_poses.npz")) as t, \
            np.load(os.path.join(jdir, "_poses.npz")) as j:
        for k in ("r", "q", "style"):
            np.testing.assert_array_equal(t[k], j[k])
    img = np.asarray(Image.open(os.path.join(tdir, names[3])))
    assert img.dtype == np.uint8 and img.shape == (64, 64, 3)


def test_missing_renders_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="gen_spherecube"):
        SphereCubeDataset(str(tmp_path))


@pytest.fixture(scope="module")
def obj_dir(tmp_path_factory, datasets):
    """A files.txt directory of .obj-named renders in two subdirectories,
    some RGBA, for the greyscale, named base ShapeDataset."""
    _, _, images = datasets
    root = tmp_path_factory.mktemp("objs")
    with np.load(MANIFEST) as f:
        q = f["q"][:12, 0]
    files = []
    for i in range(12):
        sub = f"set{i % 2}"
        os.makedirs(root / sub, exist_ok=True)
        name = (f"{sub}/chair{i % 3}.obj_"
                + gen_spherecube.pose_name(i, 0, q[i]))
        img = images[i]
        if i % 4 == 0:
            img = np.concatenate([img, np.full((64, 64, 1), 200 + i,
                                               np.uint8)], -1)
        Image.fromarray(img).save(root / name)
        files.append(name)
    with open(root / "files.txt", "w") as f:
        f.write("\n".join(files[::-1]))
    return str(root)


@pytest.mark.parametrize("subsample", [1.0, 0.5])
def test_files_txt_obj_names_match_jax(obj_dir, subsample):
    jset = JaxShapeDataset(obj_dir, subsample=subsample)
    tset = ShapeDataset(obj_dir, subsample=subsample)
    assert tset.files == jset.files and tset.root == obj_dir
    idx = np.arange(len(jset))
    want, got = jset.gather(idx), tset.gather(idx)
    assert got[2].shape == (len(idx), 64, 64, 1)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert set(got[0]) <= {"chair0", "chair1", "chair2"}
    for w, g in zip(jset[1], tset[1]):
        np.testing.assert_array_equal(g, w)


def _no_decode(*_):
    raise AssertionError("decoded an image: the disk cache was not read")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_cache_is_shared(datasets, tmp_path, monkeypatch, writer):
    """A cache written by one package is read by the other without a
    decode; a touched file makes the reader decode again and rewrite."""
    jdir, _, _ = datasets
    d = str(tmp_path / "spherecube")
    os.makedirs(d)
    for f in os.listdir(jdir):
        shutil.copy2(os.path.join(jdir, f), os.path.join(d, f))
    want = JaxSphereCubeDataset(d, subsample=0.5).gather(np.arange(12))
    classes = {"jax": (JaxSphereCubeDataset, jshapes),
               "port": (SphereCubeDataset, tshapes)}
    (write_cls, _), (read_cls, read_mod) = (
        classes[writer], classes["port" if writer == "jax" else "jax"])
    write_cls(d, subsample=0.5).warm_cache()
    cache = os.path.join(d, "_decoded_cache_v2.npz")
    stamp = os.stat(cache).st_mtime_ns
    with monkeypatch.context() as mp:
        mp.setattr(read_mod, "_load_image", _no_decode)
        reader = read_cls(d, subsample=0.5)
        assert reader._files_key() == write_cls(d, subsample=0.5)._files_key()
        reader.warm_cache()
        got = reader.gather(np.arange(12))
    assert os.stat(cache).st_mtime_ns == stamp
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    # a touched file (new mtime) changes the key: decoded again, rewritten
    key = reader._files_key()
    touched = reader.files[3]
    st = os.stat(touched)
    os.utime(touched, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    fresh = read_cls(d, subsample=0.5)
    assert fresh._files_key() != key
    fresh.warm_cache()
    assert os.stat(cache).st_mtime_ns != stamp
    with monkeypatch.context() as mp:
        mp.setattr(classes[writer][1], "_load_image", _no_decode)
        again = write_cls(d, subsample=0.5)
        again.warm_cache()
        for w, g in zip(want, again.gather(np.arange(12))):
            np.testing.assert_array_equal(g, w)


def test_device_data_decodes_once_through_warm_cache(datasets, tmp_path,
                                                     monkeypatch):
    """``UnsupervisedExperiment(device_data=True)`` over splits of a PNG
    directory decodes each file once (``warm_cache``, which writes the disk
    cache); a second experiment reads that cache and decodes nothing."""
    import torch
    from lie_vae_tpu_torch.models import LieVAE
    from lie_vae_tpu_torch.train import (ConstantSchedule,
                                         UnsupervisedExperiment)
    jdir, _, _ = datasets
    d = str(tmp_path / "spherecube")
    shutil.copytree(jdir, d)
    want = JaxSphereCubeDataset(jdir)
    decoded = []
    load = tshapes._load_image
    monkeypatch.setattr(tshapes, "_load_image",
                        lambda *a: decoded.append(a) or load(*a))
    model = LieVAE(device="cpu", **dict(modes_test.CONV, rgb=True))
    for decodes in (N, 0):
        decoded.clear()
        valid, train = random_split(SphereCubeDataset(d), [8, N - 8])
        exp = UnsupervisedExperiment(
            model=model, train_dataset=train, test_dataset=valid,
            beta_schedule=ConstantSchedule(1.0), batch_size=4,
            device_data=True)
        assert len(decoded) == decodes
        assert os.path.exists(os.path.join(d, "_decoded_cache_v2.npz"))
        rows, factor = exp._device_train
        assert factor == 1 and rows.dtype == torch.uint8
        np.testing.assert_array_equal(rows.numpy(),
                                      want.gather(train.indices)[2])


def test_cache_key_follows_the_directory_string(datasets):
    """The key hashes the file names as glob spells them: the same string
    gives the same key in both packages, another spelling another key."""
    jdir, _, _ = datasets
    for d in (jdir, jdir + "/", os.path.relpath(jdir)):
        assert (SphereCubeDataset(d)._files_key()
                == JaxSphereCubeDataset(d)._files_key())
    assert (SphereCubeDataset(jdir)._files_key()
            != SphereCubeDataset(os.path.relpath(jdir))._files_key())


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


@pytest.mark.parametrize("threads,prefetch", [(1, 0), (3, 2), (5, 4)])
def test_threaded_loader_gives_the_serial_batches(datasets, threads,
                                                  prefetch):
    jdir, _, _ = datasets
    dataset = SphereCubeDataset(jdir)
    serial = BatchLoader(dataset, 5, drop_last=False, seed=2, num_threads=0)
    threaded = BatchLoader(SphereCubeDataset(jdir), 5, drop_last=False,
                           seed=2, num_threads=threads, prefetch=prefetch)
    jax_loader = JaxBatchLoader(JaxSphereCubeDataset(jdir), 5,
                                drop_last=False, seed=2)
    assert BatchLoader(dataset, 5).num_threads == 5     # num_workers
    for _ in range(2):
        for s, t, j in zip(serial, threaded, jax_loader, strict=True):
            for a, b, c in zip(s, t, j):
                np.testing.assert_array_equal(b, a)
                np.testing.assert_array_equal(b, c)


def test_threaded_loader_stops_its_threads_early(datasets):
    jdir, _, _ = datasets
    before = threading.active_count()
    loader = BatchLoader(SphereCubeDataset(jdir), 2, num_threads=3,
                         prefetch=1)
    it = iter(loader)
    next(it)
    it.close()
    assert threading.active_count() == before


def test_threaded_decode_cache_under_stress(datasets):
    """More threads than cores, a switch interval of 1 us: every item of
    the cache filled once, whole, and equal to a serial decode."""
    jdir, _, _ = datasets
    want = SphereCubeDataset(jdir).gather(np.arange(N))
    dataset = SphereCubeDataset(jdir)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = BatchLoader(dataset, 1, shuffle=False,
                             num_threads=4 * (os.cpu_count() or 1) + 1,
                             prefetch=8)
        got = list(loader)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(dataset._cache) == list(range(N))
    np.testing.assert_array_equal(np.concatenate([b[2] for b in got]),
                                  want[2])


# --------------------------------------------------------------- Blender

PORT_SCRIPT = gen_spherecube.BLENDER_SCRIPT


def test_blender_script_protocol(tmp_path, monkeypatch):
    """The JAX tests' protocol check, run on the port's copy."""
    monkeypatch.setattr(blender_test, "SCRIPT", PORT_SCRIPT)
    blender_test.test_blender_script_protocol(tmp_path, monkeypatch)


def test_gen_spherecube_blender_seam(tmp_path, monkeypatch):
    """--blender writes the JAX generator's spec and runs the port's script
    under the stand-in bpy: one render per pose at the generator's
    rotations, named as the ray-caster names them."""
    import subprocess

    monkeypatch.setattr(blender_test, "SCRIPT", PORT_SCRIPT)
    rec, calls = blender_test._Recorder(), {}

    def fake_check_call(cmd):
        assert cmd[:5] == ["blender", "--background", "--python",
                           PORT_SCRIPT, "--"]
        calls["path"] = cmd[5]
        with open(cmd[5]) as f:
            calls["spec"] = json.load(f)
        blender_test._run_script_with_spec(cmd[5], rec, monkeypatch)

    monkeypatch.setattr(subprocess, "check_call", fake_check_call)
    out = str(tmp_path / "bl")
    gen_spherecube.main(["2", out, "--blender", "--size", "32", "--seed",
                         "3"])
    spec = calls["spec"]
    r, q = gen_spherecube.sample_poses(2, gen_spherecube.STEP_SIZE, True, 3)
    assert spec["size"] == 32 and spec["out_dir"] == os.path.abspath(out)
    assert spec["names"] == [gen_spherecube.pose_name(i, j, q[i, j])
                             for i in range(2) for j in range(2)]
    np.testing.assert_allclose(spec["matrices"], r.reshape(-1, 3, 3),
                               atol=0)
    assert len(rec.renders) == 4
    for (path, world), m in zip(rec.renders, spec["matrices"]):
        np.testing.assert_allclose(world[:3, :3], m, atol=1e-12)
        assert os.path.exists(path)
    assert not os.path.exists(calls["path"])         # the spec is removed
    with pytest.raises(ValueError, match="v1"):
        gen_spherecube.main(["1", out, "--blender", "--style", "v2"])


def test_blender_script_needs_blender():
    """Outside Blender the port's copy loads; building its scene fails on
    bpy."""
    import runpy
    script = runpy.run_path(PORT_SCRIPT, run_name="not_main")
    with pytest.raises(ModuleNotFoundError, match="bpy"):
        script["build_scene"](64)


def test_profile_data_runs_on_the_cpu(tmp_path):
    """``profile_data`` end to end at a tiny size: every stage timed, the
    decoded images the renders (it checks), its directory removed."""
    from lie_vae_tpu_torch import profile_data
    out = str(tmp_path / "pd")
    res = profile_data.main(["--poses", MANIFEST, "--num", "20", "--out",
                             out, "--device", "cpu"])
    assert res["images"] == 20 and res["to_device"] == "cpu"
    assert all(v > 0 for v in res["decode_1024"].values())
    assert res["cache_bytes"] > 20 * 64 * 64 * 3
    # the files are the default filter's compressed scanlines and 57 bytes
    # of signature, IHDR, IDAT's frame and IEND
    assert set(res["png_filters"]) == {"none", "sub", "up", "average",
                                       "paeth", "per_row"}
    assert res["png_bytes"] == 20 * (
        res["png_filters"][res["png_filter"]]["bytes_per_image"] + 57)
    assert not os.path.exists(out)
