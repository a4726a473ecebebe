"""The PyTorch port's InferenceSession held against the JAX package's.

- small width: both sessions from the same JAX weights, on the same
  requests, one of them ragged (not a multiple of the batch); tolerance
  1e-4 (float32, convolutions summed in another order);
- the port imports neither JAX nor the JAX package.

The full-width comparison is in ``test_torch_port_flagship.py``.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
from flax import traverse_util

from lie_vae_tpu import serve as jserve
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu_torch import serve as tserve
from lie_vae_tpu_torch.compat import state_dict_from_jax
from lie_vae_tpu_torch.models import LieVAE
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(latent_mode="so3", decoder_mode="action", encode_mode="conv",
             deconv_mode="deconv", mean_mode="s2s2", degrees=3, rep_copies=4,
             conv_hidden=8, deconv_hidden=16, rgb=True, batch_norm=True)


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def small_sessions():
    import test_torch_port_models as models_test
    flat = models_test._flat_jax_weights(JaxLieVAE(**SMALL))
    params = traverse_util.unflatten_dict(
        {k[len("params/"):]: jnp.asarray(v) for k, v in flat.items()
         if k.startswith("params/")}, sep="/")
    stats = traverse_util.unflatten_dict(
        {k[len("batch_stats/"):]: jnp.asarray(v) for k, v in flat.items()
         if k.startswith("batch_stats/")}, sep="/")
    jsess = jserve.InferenceSession(JaxLieVAE(**SMALL), params, stats,
                                    batch_size=4)
    model = LieVAE(device="cpu", **SMALL)
    tsess = tserve.InferenceSession(model, state_dict_from_jax(flat, model),
                                    batch_size=4, device="cpu")
    return jsess, tsess, flat


def test_small_width_serving_matches_jax(small_sessions):
    jsess, tsess, _ = small_sessions
    x = _images(6, 0)                     # 6 rows: a full and a padded chunk
    j_enc, t_enc = jsess.encode(x), tsess.encode(x)
    for k in ("pose", "sigma"):
        assert t_enc[k].shape == j_enc[k].shape
        np.testing.assert_allclose(t_enc[k], j_enc[k], rtol=0, atol=1e-4)
    assert t_enc["sample"].shape == (6, 3, 3)
    np.testing.assert_allclose(tsess.decode(j_enc["pose"]),
                               jsess.decode(j_enc["pose"]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tsess.reconstruct(x), jsess.reconstruct(x),
                               rtol=0, atol=1e-4)
    a, b = j_enc["pose"][0], j_enc["pose"][3]
    np.testing.assert_allclose(
        tsess.geodesic(a, b, steps=7, decode=False),
        jsess.geodesic(a, b, steps=7, decode=False), rtol=0, atol=1e-5)


def test_padding_is_invisible(small_sessions):
    _, tsess, _ = small_sessions
    x = _images(5, 1)
    full = tsess.reconstruct(x)
    for i in range(5):
        np.testing.assert_allclose(tsess.reconstruct(x[i:i + 1]),
                                   full[i:i + 1], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="empty"):
        tsess.decode(np.zeros((0, 3, 3), np.float32))


def test_sample_and_noise_come_from_the_seed(small_sessions):
    _, tsess, _ = small_sessions
    np.testing.assert_array_equal(tsess.sample(3, seed=7),
                                  tsess.sample(3, seed=7))
    x = _images(3, 2)
    eps = np.zeros((3, 3), np.float32)
    enc = tsess.encode(x, eps=eps)
    np.testing.assert_allclose(enc["sample"], enc["pose"], atol=1e-6)


def test_from_npz_serves_a_jax_artifact(small_sessions, tmp_path):
    """An artifact in the JAX package's export_npz format (flat '/' paths
    plus a step counter) serves from the port as from the JAX package."""
    jsess, _, flat = small_sessions
    path = tmp_path / "artifact.npz"
    np.savez(path, __step__=np.asarray(3), **flat)
    tsess = tserve.InferenceSession.from_npz(
        path, LieVAE(device="cpu", **SMALL), batch_size=4, device="cpu")
    x = _images(4, 4)
    np.testing.assert_allclose(tsess.reconstruct(x), jsess.reconstruct(x),
                               rtol=0, atol=1e-4)


_PORT_SOURCES = [os.path.join(ROOT, "chip_smoke.py")] + [
    os.path.join(d, f)
    for d, _, files in os.walk(os.path.join(ROOT, "lie_vae_tpu_torch"))
    for f in files if f.endswith(".py")]


def test_port_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter (this one has JAX loaded already) imports every
    module of the port and finds no jax, flax or lie_vae_tpu module."""
    modules = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").removesuffix(
            ".__init__")
        for p in _PORT_SOURCES if not p.endswith("chip_smoke.py"))
    for m in ("lie_vae_tpu_torch.losses", "lie_vae_tpu_torch.losses."
              "equivariance", "lie_vae_tpu_torch.losses.continuity",
              "lie_vae_tpu_torch.bench_serve_load", "lie_vae_tpu_torch.serve"):
        assert m in modules, m
    code = (f"import sys\nfor m in {modules!r}:\n    __import__(m)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'lie_vae_tpu')]\n"
            "assert not bad, bad\nprint(len(sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|lie_vae_tpu(?!_torch))\b",
    re.MULTILINE)


@pytest.mark.parametrize("path", _PORT_SOURCES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_statement(path):
    with open(path) as f:
        src = f.read()
    assert not _IMPORT.findall(src)
    assert "importlib" not in src and "__import__" not in src
