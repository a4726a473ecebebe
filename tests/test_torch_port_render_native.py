"""The port's native sphere-cube renderer held against the JAX package's.

- byte for byte (``np.array_equal`` of the float32 images): the port's
  ``render_spherecube`` (``backend='auto'``: ``csrc/render_native.cpp``,
  built with ``g++ -O3 -shared -fPIC`` into ``build/native/``) against the
  JAX package's ``backend='native'`` (the same source and flags), styles v1
  and v2, sizes 32 and 64, a batch and a single pose;
- within 1e-4 of the port's numpy ray-caster (the JAX package's own
  tolerance between its two backends, tests/test_render_native.py: the
  numpy path rounds parts of its ray math through float32);
- a build that cannot run (no ``g++`` on PATH) raises, and ``'auto'`` does
  not fall back to numpy;
- the library lands under ``build/native/``, keyed by a hash of the source,
  never beside its source.
"""
import os

import numpy as np
import pytest

from lie_vae_tpu.data import render as jrender
from lie_vae_tpu_torch.data import _native
from lie_vae_tpu_torch.data import render_spherecube
from lie_vae_tpu_torch.ops.kernels import _build
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(ROOT, "data_poses", "spherecube.npz")


def _poses(n, offset=0):
    with np.load(MANIFEST) as f:
        return f["r"][offset:offset + n, 0]


@pytest.fixture(scope="module")
def jax_native():
    if jrender._load_native() is None:
        pytest.skip("the JAX package's native renderer did not build")


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("style", ["v1", "v2"])
def test_native_equals_jax_native_bytes(jax_native, style, size):
    r = _poses(16, offset=200)
    want = jrender.render_spherecube(r, size=size, style=style,
                                     backend="native")
    got = render_spherecube(r, size=size, style=style)
    assert got.dtype == np.float32 and got.shape == (16, size, size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("style", ["v1", "v2"])
def test_single_pose(jax_native, style):
    r = _poses(1, offset=7)[0]
    got = render_spherecube(r, size=32, style=style, backend="native")
    assert got.shape == (32, 32, 3)
    np.testing.assert_array_equal(
        got, jrender.render_spherecube(r, size=32, style=style,
                                       backend="native"))
    np.testing.assert_array_equal(got, render_spherecube(r[None], size=32,
                                                         style=style)[0])


@pytest.mark.parametrize("style", ["v1", "v2"])
def test_native_within_1e_4_of_numpy(style):
    r = _poses(8, offset=300)
    native = render_spherecube(r, style=style)
    plain = render_spherecube(r, style=style, backend="numpy")
    np.testing.assert_allclose(native, plain, rtol=0, atol=1e-4)


def test_failed_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-compiler-here"))
    _native.library.cache_clear()
    try:
        for backend in ("auto", "native"):
            with pytest.raises(RuntimeError, match="g\\+\\+"):
                render_spherecube(_poses(2), backend=backend)
        assert render_spherecube(_poses(2), backend="numpy").shape == (
            2, 64, 64, 3)
    finally:
        _native.library.cache_clear()
    with pytest.raises(ValueError, match="backend"):
        render_spherecube(_poses(1), backend="blender")


def test_library_lands_under_build_native():
    render_spherecube(_poses(1), size=8)
    path = _build.host_library_path("render_native")
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "native")
    assert os.path.exists(path)
    csrc = os.path.join(ROOT, "lie_vae_tpu_torch", "csrc")
    assert not [f for f in os.listdir(csrc) if f.endswith(".so")]


def test_threads_of_one_process_build_the_library_at_once(tmp_path,
                                                          monkeypatch):
    """A fresh checkout's threaded loader: the first batches' threads all
    build the library at once, each through a file of its own, and every
    one of them gets it."""
    from concurrent.futures import ThreadPoolExecutor
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", str(tmp_path / "native"))
    with ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(lambda _: _build.build_host("render_native"),
                              range(4)))
    assert len(set(paths)) == 1 and os.path.exists(paths[0])
    assert os.listdir(tmp_path / "native") == [os.path.basename(paths[0])]
