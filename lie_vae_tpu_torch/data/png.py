"""8-bit PNG files without an image library: the port's stand-in for PIL,
which the JAX package's datasets and generator use.

:func:`write_png` writes greyscale, grey + alpha, RGB and RGBA images with
the stdlib's ``zlib``, every row filtered by PNG's Up filter (``FILTER``;
the other four of the specification's section 9, None, Sub, Average and
Paeth, serve the tests). :func:`read_png` reads such files, and those PIL
writes, back into the array ``np.asarray(PIL.Image.open(path))`` gives:
(H, W) for greyscale, (H, W, 2), (H, W, 3) or (H, W, 4) uint8 otherwise. It
concatenates the IDAT chunks, decompresses them and undoes the filters in
the host library (``csrc/render_native.cpp``, ``png_unfilter``: 0.0083 ms
for a 64x64 RGB render written with Up rows, where :func:`unfilter_plain`,
the numpy and Python version the tests hold it against, takes 0.21 ms,
and 8.6 ms on Sub rows, which it undoes a byte at a time, as PIL's files
need; ``profile_data`` on the host of an NVIDIA H100 80GB HBM3, 700.00
W). Palette, 16-bit and interlaced files raise.
"""
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for 8-bit samples
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


# the row filter the files are written with, and zlib's level. Up: on the
# 32k manifest's renders 1.4% above Paeth's bytes at 0.74-0.97 of its
# encode time, 3.3% above the per-row choice's at 0.50-0.68 of it
# (``profile_data``'s ``png_filters``, two runs on the host of an NVIDIA
# H100 80GB HBM3, 700.00 W)
FILTER = 2
COMPRESS_LEVEL = 6


def _predictor(x, bpp, filter_type):
    """The bytes filter ``filter_type`` predicts for every byte of the (H,
    row_bytes) int16 rows ``x``: 0, left, up, their average, or Paeth."""
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    if filter_type <= 1:
        return a if filter_type else np.zeros_like(x)
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    if filter_type == 2:
        return b
    if filter_type == 3:
        return (a + b) >> 1
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(raw, bpp, filter_type=FILTER):
    """(H, 1 + row_bytes) uint8 scanlines of the (H, row_bytes) rows, every
    row filtered with ``filter_type`` (0-4)."""
    if filter_type not in range(5):
        raise ValueError(f"PNG filter type {filter_type!r} is not 0-4")
    x = raw.astype(np.int16)
    rows = ((x - _predictor(x, bpp, filter_type)) & 0xFF).astype(np.uint8)
    kind = np.full((raw.shape[0], 1), filter_type, np.uint8)
    return np.concatenate([kind, rows], axis=1)


def encode_png(image, filter_type=FILTER):
    """The bytes of an 8-bit PNG of the uint8 image (H, W), (H, W, 1),
    (H, W, 2), (H, W, 3) or (H, W, 4)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG images are uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"cannot write an image of shape {image.shape} "
                         "as PNG")
    h, w, ch = img.shape
    rows = filter_rows(np.ascontiguousarray(img).reshape(h, w * ch), ch,
                       filter_type)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), COMPRESS_LEVEL))
            + _chunk(b"IEND", b""))


def write_png(path, image, filter_type=FILTER):
    """Write ``image`` (see :func:`encode_png`) to ``path``."""
    data = encode_png(image, filter_type)
    with open(path, "wb") as f:
        f.write(data)


def _parse(data):
    """(width, height, channels, the decompressed scanlines) of PNG bytes."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {color}, "
            f"interlace {interlace} (8-bit greyscale, grey + alpha, RGB and "
            "RGBA without interlacing are read)")
    return w, h, _CHANNELS[color], zlib.decompress(b"".join(idat))


def unfilter_plain(raw, rows, row_bytes, bpp):
    """The plain version of the host library's ``png_unfilter``: (rows,
    row_bytes) uint8 of ``rows`` filtered scanlines of one image, a byte
    at a time where the filter needs the bytes just undone."""
    src = np.frombuffer(raw, dtype=np.uint8).reshape(rows, row_bytes + 1)
    out = np.zeros((rows, row_bytes), dtype=np.uint8)
    prev = np.zeros(row_bytes, dtype=np.int64)
    for r in range(rows):
        kind, line = int(src[r, 0]), src[r, 1:].astype(np.int64)
        cur = np.zeros(row_bytes, dtype=np.int64)
        if kind in (0, 2):
            cur = (line + (prev if kind == 2 else 0)) & 0xFF
        elif kind in (1, 3, 4):
            for x in range(row_bytes):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (int(line[x]) + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {r}: unknown filter type {kind}")
        out[r] = cur
        prev = cur
    return out


def decode_png(data, plain=False):
    """The uint8 array of PNG bytes, shaped as PIL's (module docstring);
    ``plain`` undoes the filters with :func:`unfilter_plain` instead of
    the host library."""
    w, h, ch, raw = _parse(data)
    if plain:
        rows = unfilter_plain(raw, h, w * ch, ch)
    else:
        from lie_vae_tpu_torch.data import _native
        rows = _native.png_unfilter(raw, h, w * ch, ch)
    img = rows.reshape(h, w, ch)
    return img[:, :, 0] if ch == 1 else img


def read_png(path, plain=False):
    """The uint8 array of the PNG file at ``path`` (see :func:`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), plain)
