"""The wrapped SO(3) log-density and its backward as hand-written CUDA
kernels.

``csrc/so3_density.cu`` computes log q(exp(v)) per sample with the
2k+1-shell sum in registers (forward) and the analytic gradient in v and
sigma (backward). It replaces the TPU kernels ``_density_kernel`` and
``_density_bwd_kernel`` of the JAX package's ``ops/kernels/so3_density.py``;
the source says how the design differs and what bounds it on an H100.
:func:`so3_wrapped_log_density_fused` launches them for CUDA tensors (the
backward through a ``torch.autograd.Function``) and runs the plain density
(:func:`~lie_vae_tpu_torch.distributions.so3.so3_wrapped_log_density_plain`)
for CPU tensors.
"""
import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from lie_vae_tpu_torch.distributions.so3 import so3_wrapped_log_density_plain
from lie_vae_tpu_torch.ops.kernels import _build

__all__ = ["so3_wrapped_log_density_fused"]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(_build.build("so3_density"))
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.so3_density_fwd.argtypes = [ptr, ptr, ptr, i64, i32, i32, f32, ptr]
    lib.so3_density_bwd.argtypes = [ptr] * 5 + [i64, i32, i32, f32, ptr]
    lib.so3_density_fwd.restype = lib.so3_density_bwd.restype = i32
    return lib


def _check(rc, name, N, B, k):
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} (N={N}, B={B}, "
                           f"k={k})")


def _launch_fwd(v, sigma, k, clamp):
    """K3: v (N, 3), sigma (B, 3) -> log q (N,)."""
    N, B = v.shape[0], sigma.shape[0]
    out = torch.empty((N,), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        rc = _lib().so3_density_fwd(
            v.data_ptr(), sigma.data_ptr(), out.data_ptr(), N, B, k, clamp,
            torch.cuda.current_stream().cuda_stream)
    _check(rc, "so3_density_fwd", N, B, k)
    so3_wrapped_log_density_fused.launches += 1
    return out


def _launch_bwd(v, sigma, g, k, clamp):
    """K4: the cotangent g (N,) of log q -> dv (N, 3) and the per-sample
    dsigma (N, 3), not yet summed over the n samples of each row."""
    N, B = v.shape[0], sigma.shape[0]
    dv = torch.empty((N, 3), dtype=torch.float32, device=v.device)
    ds = torch.empty((N, 3), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        rc = _lib().so3_density_bwd(
            v.data_ptr(), sigma.data_ptr(), g.data_ptr(), dv.data_ptr(),
            ds.data_ptr(), N, B, k, clamp,
            torch.cuda.current_stream().cuda_stream)
    _check(rc, "so3_density_bwd", N, B, k)
    so3_wrapped_log_density_fused.launches_backward += 1
    return dv, ds


class _WrappedDensity(torch.autograd.Function):
    """Forward K3, backward K4. dsigma of the (B, 3) sigma is the sum over
    the n samples of the per-sample dsigma: the transpose of the broadcast,
    a deterministic reduction after the kernel."""

    @staticmethod
    def forward(ctx, v, sigma, k, clamp):
        ctx.save_for_backward(v, sigma)
        ctx.k, ctx.clamp = k, clamp
        return _launch_fwd(v, sigma, k, clamp)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        v, sigma = ctx.saved_tensors
        dv, ds = _launch_bwd(v, sigma, g.contiguous(), ctx.k, ctx.clamp)
        return dv, ds.view(-1, *sigma.shape).sum(0), None, None


def so3_wrapped_log_density_fused(v, sigma, k=10, clamp=1e-3):
    """log q(exp(v)), v (n, B, 3), sigma (B, 3) -> (n, B).

    CUDA tensors go through the kernel (float32, contiguous; anything else
    raises), with the backward kernel when a gradient is needed; CPU
    tensors through the plain density. Each launch of the forward kernel
    adds one to ``so3_wrapped_log_density_fused.launches``, each of the
    backward kernel one to ``.launches_backward``.
    """
    if v.device.type == "cpu" and sigma.device.type == "cpu":
        return so3_wrapped_log_density_plain(v, sigma, k, clamp)
    if v.device.type != "cuda" or sigma.device != v.device:
        raise ValueError(f"v on {v.device} and sigma on {sigma.device}: both "
                         "must be on one CUDA device, or both on the CPU")
    if v.dim() != 3 or v.shape[-1] != 3 or tuple(sigma.shape) != (
            v.shape[1], 3):
        raise ValueError(f"v must be (n, B, 3) and sigma (B, 3), got "
                         f"{tuple(v.shape)} and {tuple(sigma.shape)}")
    for name, t in (("v", v), ("sigma", sigma)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    n, B = v.shape[:2]
    if n * B == 0:
        return v.new_zeros((n, B))
    vf = v.reshape(n * B, 3)
    if torch.is_grad_enabled() and (v.requires_grad or sigma.requires_grad):
        out = _WrappedDensity.apply(vf, sigma, int(k), float(clamp))
    else:
        out = _launch_fwd(vf, sigma, int(k), float(clamp))
    return out.view(n, B)


so3_wrapped_log_density_fused.launches = 0
so3_wrapped_log_density_fused.launches_backward = 0
