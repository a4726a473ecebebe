"""The port's PNG files (``data/png.py``) held against PIL, the image
library of the JAX package's datasets and generator. Bytes exact
throughout:

- files the port writes decode under PIL to the same uint8 array, for
  greyscale, grey + alpha, RGB and RGBA, with each of PNG's five row
  filters and with the writer's default;
- files PIL writes (the JAX generator's ``Image.fromarray(...).save``,
  which picks its filters row by row: Sub, Up and Paeth on the renders)
  decode under the port to the array ``np.asarray(Image.open(...))``
  gives, renders and random images of every colour type;
- the host library's ``png_unfilter`` equal to the plain numpy/Python
  unfilter on every filter and colour type, and on a batch of images;
- malformed files raise: a bad CRC, an unknown filter byte, a 16-bit
  image.
"""
import io
import os
import zlib

import numpy as np
import pytest
from PIL import Image

from lie_vae_tpu_torch.data import _native, png, render_spherecube
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"grey": (17, 23), "grey_alpha": (17, 23, 2), "rgb": (17, 23, 3),
          "rgba": (17, 23, 4)}


def _image(kind, seed=0):
    """Random bytes with smooth regions, so every filter has work."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[kind]
    base = np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1]))
    if len(shape) == 3:
        base = base[:, :, None] + 40 * np.arange(shape[2])
    noise = rng.integers(0, 256, shape) * (rng.random(shape) < 0.3)
    return ((base + noise) % 256).astype(np.uint8)


def _renders(n=3):
    with np.load(os.path.join(ROOT, "data_poses", "spherecube.npz")) as f:
        r = f["r"][:n, 0]
    return (render_spherecube(r, style="v2", backend="numpy")
            * 255).astype(np.uint8)


@pytest.mark.parametrize("filter_type", ["default", 0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_port_files_decode_under_pil(kind, filter_type, tmp_path):
    img = _image(kind)
    path = str(tmp_path / "x.png")
    if filter_type == "default":
        png.write_png(path, img)
    else:
        png.write_png(path, img, filter_type=filter_type)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_pil_files_decode_under_the_port(kind):
    for seed in range(3):
        img = _image(kind, seed)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        got = png.decode_png(buf.getvalue())
        np.testing.assert_array_equal(got, np.asarray(Image.open(buf)))
        np.testing.assert_array_equal(got, img)


def test_pil_renders_decode_under_the_port(tmp_path):
    """The JAX generator's way of writing a render, read back by the port;
    PIL's adaptive rows use several filters."""
    types = set()
    for i, img in enumerate(_renders()):
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(img).save(path)
        np.testing.assert_array_equal(png.read_png(path), img)
        with open(path, "rb") as f:
            _, h, ch, raw = png._parse(f.read())
        types |= {raw[r * (64 * ch + 1)] for r in range(h)}
    assert len(types) >= 3, types


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba"])
def test_native_unfilter_equals_plain(kind, filter_type):
    img = _image(kind, seed=filter_type)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = png.filter_rows(img.reshape(h, w * ch), ch, filter_type)
    raw = rows.tobytes()
    plain = png.unfilter_plain(raw, h, w * ch, ch)
    np.testing.assert_array_equal(plain, img.reshape(h, w * ch))
    np.testing.assert_array_equal(_native.png_unfilter(raw, h, w * ch, ch),
                                  plain)


def test_native_unfilter_of_a_batch():
    """Images stacked in one call, their rows' filters mixed as PIL mixes
    them: each first row's 'up' is zero."""
    imgs = [_image("rgb", seed=s) for s in range(3)]
    raws = []
    for s, img in enumerate(imgs):
        by_type = [png.filter_rows(img.reshape(17, 69), 3, k)
                   for k in range(5)]
        raws.append(np.stack([by_type[(r + s) % 5][r] for r in range(17)]))
    out = _native.png_unfilter(np.concatenate(raws).tobytes(), 51, 69, 3,
                               rows_per_image=17)
    np.testing.assert_array_equal(
        out, np.concatenate([i.reshape(17, 69) for i in imgs]))


def test_malformed_files_raise():
    data = bytearray(png.encode_png(_image("rgb")))
    data[-20] ^= 0xFF                       # inside IDAT: its CRC fails
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))
    rows = png.filter_rows(_image("grey").reshape(17, 23), 1, 0)
    rows[5, 0] = 9
    with pytest.raises(ValueError, match="row 5: unknown filter type 9"):
        _native.png_unfilter(rows.tobytes(), 17, 23, 1)
    with pytest.raises(ValueError, match="row 5: unknown filter type 9"):
        png.unfilter_plain(rows.tobytes(), 17, 23, 1)
    buf = io.BytesIO()
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8)
                    * 1000).save(buf, format="PNG")
    with pytest.raises(ValueError, match="bit depth 16"):
        png.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(zlib.compress(b"x"))
