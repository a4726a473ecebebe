"""The data path's host library, ``csrc/render_native.cpp``, built with
``g++`` into ``build/native/`` at first use (``ops/kernels/_build.py``,
:func:`build_host`) and loaded with ``ctypes``. A failed build raises.
ctypes releases the GIL around each call, so threads overlap them.
"""
import ctypes
import functools

import numpy as np

from lie_vae_tpu_torch.ops.kernels import _build


@functools.lru_cache(maxsize=None)
def library():
    lib = ctypes.CDLL(_build.build_host("render_native"))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.render_spherecube_native.argtypes = [ptr, i64, i64, ctypes.c_int,
                                             ptr]
    lib.render_spherecube_native.restype = None
    lib.png_unfilter.argtypes = [ptr, i64, i64, i64, i64, ptr]
    lib.png_unfilter.restype = i64
    return lib


def render(rotations, size, style):
    """float32 (N, size, size, 3) renders of the (N, 3, 3) rotations."""
    R = np.ascontiguousarray(rotations, dtype=np.float32).reshape(-1, 3, 3)
    out = np.empty((R.shape[0], size, size, 3), dtype=np.float32)
    library().render_spherecube_native(
        R.ctypes.data, R.shape[0], size, 0 if style == "v1" else 1,
        out.ctypes.data)
    return out


def png_unfilter(raw, rows, row_bytes, bpp, rows_per_image=None):
    """Unfiltered uint8 (rows, row_bytes) of ``raw``, ``rows`` decompressed
    PNG scanlines (a filter byte, then ``row_bytes`` bytes each) of images
    of ``rows_per_image`` rows (default: one image)."""
    src = np.frombuffer(raw, dtype=np.uint8)
    if src.size != rows * (row_bytes + 1):
        raise ValueError(f"PNG data holds {src.size} bytes, expected "
                         f"{rows} rows of 1 + {row_bytes}")
    out = np.empty((rows, row_bytes), dtype=np.uint8)
    bad = library().png_unfilter(src.ctypes.data, rows,
                                 rows_per_image or rows, row_bytes, bpp,
                                 out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type "
                         f"{src[(bad - 1) * (row_bytes + 1)]}")
    return out
