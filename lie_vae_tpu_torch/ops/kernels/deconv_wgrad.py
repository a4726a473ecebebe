"""The weight gradient of a k4 s2 p1 transposed convolution as a
hand-written CUDA kernel.

``csrc/deconv_wgrad.cu`` computes dw (C_in, C_out, 4, 4) of
``F.conv_transpose2d(x, w, stride=2, padding=1)`` from its input x (B,
C_in, H, W) and its output's gradient dy (B, C_out, 2H, 2W), NCHW float32:
an implicit GEMM over the batch and the input positions, split over K into
a workspace whose splits a second kernel sums in a fixed order. It
replaces no TPU kernel (the JAX package leaves transposed convs to XLA);
the source says why it was added and what bounds it on an H100.
:func:`deconv_wgrad` launches it for CUDA tensors and runs the plain
version (:func:`deconv_wgrad_plain`, the same sums tap by tap) for CPU
tensors. ``deconv_wgrad.launches`` counts the calls on a card (two kernels
each).
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from lie_vae_tpu_torch.ops.kernels import _build

__all__ = ["deconv_wgrad", "deconv_wgrad_plain", "supports", "WIDTHS"]

WIDTHS = (4, 8, 16, 32)   # the input widths the kernel is built for


def supports(c_out, w):
    """Whether the kernel is built for C_out and the input width w: its
    tiles hold 25 output channels, so it takes C_out >= 25 (the hidden
    layers; the image heads' 3 or 1 would leave most of a tile idle)."""
    return w in WIDTHS and c_out >= 25


def deconv_wgrad_plain(x, dy):
    """dw (C_in, C_out, 4, 4) for x (B, C_in, H, W) and dy (B, C_out, 2H,
    2W): tap (kh, kw) is the sum over (b, ih, iw) of x times dy at row
    2 ih - 1 + kh, column 2 iw - 1 + kw (zero outside), as the kernel sums."""
    h, w = x.shape[-2:]
    dyp = F.pad(dy, (1, 1, 1, 1))
    return torch.stack([torch.stack([
        torch.einsum("bihw,bohw->io", x,
                     dyp[:, :, kh:kh + 2 * h:2, kw:kw + 2 * w:2])
        for kw in range(4)], -1) for kh in range(4)], -2)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(_build.build("deconv_wgrad"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.deconv_wgrad_splits.argtypes = [i32] * 5
    lib.deconv_wgrad.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.deconv_wgrad_splits.restype = lib.deconv_wgrad.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _splits(index, *shape):
    with torch.cuda.device(index):
        splits = _lib().deconv_wgrad_splits(*shape)
    if splits < 1:
        raise RuntimeError(f"deconv_wgrad_splits failed for (B, C_in, C_out, "
                           f"H, W) = {shape}")
    return splits


def deconv_wgrad(x, dy):
    """dw (C_in, C_out, 4, 4) of the k4 s2 p1 transposed conv of x (B, C_in,
    H, W) whose output's gradient is dy (B, C_out, 2H, 2W): the kernel for
    contiguous float32 CUDA tensors of a shape it :func:`supports`, the
    plain version for CPU tensors; anything else raises."""
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return deconv_wgrad_plain(x, dy)
    n, c_in, h, w = x.shape
    c_out = dy.shape[1]
    if (x.device.type != "cuda" or dy.device != x.device
            or tuple(dy.shape) != (n, c_out, 2 * h, 2 * w)
            or not supports(c_out, w)):
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and dy "
                         f"{tuple(dy.shape)} on {dy.device}: both on one CUDA "
                         f"device, dy (B, C_out, 2H, 2W), W in {WIDTHS}, "
                         "C_out >= 25")
    for name, t in (("x", x), ("dy", dy)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    splits = _splits(x.device.index, n, c_in, c_out, h, w)
    ws = torch.empty((splits, c_in, c_out, 4, 4), dtype=torch.float32,
                     device=x.device)
    dw = torch.empty((c_in, c_out, 4, 4), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().deconv_wgrad(
            x.data_ptr(), dy.data_ptr(), ws.data_ptr(), dw.data_ptr(), n,
            c_in, c_out, h, w, splits,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"deconv_wgrad failed: CUDA error {rc} (B={n}, "
                           f"C_in={c_in}, C_out={c_out}, H={h}, W={w})")
    deconv_wgrad.launches += 1
    return dw


deconv_wgrad.launches = 0
