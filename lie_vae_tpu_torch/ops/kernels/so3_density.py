"""The wrapped SO(3) log-density, its KL against the Haar prior, and their
backward as hand-written CUDA kernels.

``csrc/so3_density.cu`` computes log q(exp(v)) per sample (K3), the KL
kl[b] = mean_s log q(v[s, b]) - LOG_HAAR_UNIFORM per row (K3 with the
mean and the prior folded in), and the analytic gradient in v and in sigma,
dsigma already summed over the n samples of each row (K4). It replaces the
TPU kernels ``_density_kernel`` and ``_density_bwd_kernel`` of the JAX
package's ``ops/kernels/so3_density.py``; the source says how the design
differs and what bounds it on an H100. A sample is taken by a group of G
lanes that split its 2k+1 shells (:func:`lanes_for` picks G from the sample
count).

:func:`so3_wrapped_log_density_fused` and :func:`so3_wrapped_kl_fused`
launch them for CUDA tensors (the backward through a
``torch.autograd.Function``) and run the plain versions
(:func:`~lie_vae_tpu_torch.distributions.so3.so3_wrapped_log_density_plain`,
:func:`~lie_vae_tpu_torch.distributions.so3.so3_wrapped_kl_plain`) for CPU
tensors.
"""
import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from lie_vae_tpu_torch.distributions.so3 import (
    so3_wrapped_kl_plain, so3_wrapped_log_density_plain)
from lie_vae_tpu_torch.ops.kernels import _build

__all__ = ["so3_wrapped_log_density_fused", "so3_wrapped_kl_fused",
           "lanes_for", "LANES"]

LANES = (8, 4, 2, 1)     # the lane-group widths the kernels are built for
# Lanes times samples, per SM, up to which a wider lane group is faster
# (k = 10 on an H100 SXM, compare_so3_density's sweep): beyond them the
# group's repeated per-sample work (loads, reciprocals, the epilogue on one
# lane of G) costs more instruction slots than the split shells save in
# latency. K4's longer shell loop keeps wide groups worth it four times
# further.
FWD_LANE_SAMPLES_PER_SM = 128
BWD_LANE_SAMPLES_PER_SM = 512


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(_build.build("so3_density"))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.so3_density_fwd.argtypes = [ptr] * 3 + [i32] * 4 + [f32, ptr]
    lib.so3_density_kl.argtypes = [ptr] * 3 + [i32] * 4 + [f32, ptr]
    lib.so3_density_bwd.argtypes = ([ptr] * 3 + [i32] * 2 + [ptr] * 2
                                    + [i32] * 4 + [f32, ptr])
    for fn in (lib.so3_density_fwd, lib.so3_density_kl, lib.so3_density_bwd):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def lanes_for(N, per_sm, sms=132):
    """Lanes a sample for N samples: the widest group G with N * G at most
    ``per_sm`` lane-samples on each of ``sms`` SMs (an H100 SXM has 132).
    While the card has room a wider group shortens each sample's chain;
    past that the narrower group does less work a sample."""
    return next((G for G in LANES if N * G <= per_sm * sms), 1)


def _lanes(N, device, lanes, per_sm):
    if lanes is None:
        return lanes_for(N, per_sm, _sm_count(device.index))
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes}")
    return lanes


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check(rc, name, N, B, k):
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} (N={N}, B={B}, "
                           f"k={k})")


def _launch_fwd(v, sigma, k, clamp, lanes=None):
    """K3: v (N, 3), sigma (B, 3) -> log q (N,)."""
    N, B = v.shape[0], sigma.shape[0]
    out = torch.empty((N,), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        rc = _lib().so3_density_fwd(
            v.data_ptr(), sigma.data_ptr(), out.data_ptr(), N, B, k,
            _lanes(N, v.device, lanes, FWD_LANE_SAMPLES_PER_SM), clamp,
            _stream())
    _check(rc, "so3_density_fwd", N, B, k)
    so3_wrapped_log_density_fused.launches += 1
    return out


def _launch_kl(v, sigma, k, clamp, lanes=None):
    """K3 with the KL's mean: v (N, 3) = (n * B, 3), sigma (B, 3) -> (B,)
    mean over the n samples of log q, less LOG_HAAR_UNIFORM."""
    N, B = v.shape[0], sigma.shape[0]
    kl = torch.empty((B,), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        rc = _lib().so3_density_kl(
            v.data_ptr(), sigma.data_ptr(), kl.data_ptr(), N // B, B, k,
            _lanes(N, v.device, lanes, FWD_LANE_SAMPLES_PER_SM), clamp,
            _stream())
    _check(rc, "so3_density_kl", N, B, k)
    so3_wrapped_log_density_fused.launches += 1
    return kl


def _launch_bwd(v, sigma, g, k, clamp, per_row, lanes=None):
    """K4: the cotangent g of log q, (N,) per sample or, with ``per_row``,
    (B,) of the KL (the kernel scales it by 1 / n), any stride -> dv (N, 3)
    and dsigma (B, 3), summed over the n samples of each row."""
    N, B = v.shape[0], sigma.shape[0]
    if g.dtype != torch.float32 or g.device != v.device or tuple(
            g.shape) != ((B,) if per_row else (N,)):
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} on "
                         f"{g.device} for N={N}, B={B}, per_row={per_row}")
    dv = torch.empty((N, 3), dtype=torch.float32, device=v.device)
    ds = torch.empty((B, 3), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        rc = _lib().so3_density_bwd(
            v.data_ptr(), sigma.data_ptr(), g.data_ptr(), g.stride(0),
            int(per_row), dv.data_ptr(), ds.data_ptr(), N // B, B, k,
            _lanes(N, v.device, lanes, BWD_LANE_SAMPLES_PER_SM), clamp,
            _stream())
    _check(rc, "so3_density_bwd", N, B, k)
    so3_wrapped_log_density_fused.launches_backward += 1
    return dv, ds


class _WrappedDensity(torch.autograd.Function):
    """Forward K3 per sample, backward K4 with the cotangent per sample."""

    @staticmethod
    def forward(ctx, v, sigma, k, clamp):
        ctx.save_for_backward(v, sigma)
        ctx.k, ctx.clamp = k, clamp
        return _launch_fwd(v, sigma, k, clamp)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        v, sigma = ctx.saved_tensors
        return _launch_bwd(v, sigma, g, ctx.k, ctx.clamp, False) + (None,
                                                                     None)


class _WrappedKL(torch.autograd.Function):
    """Forward K3 with the mean over n, backward K4 with the cotangent per
    row."""

    @staticmethod
    def forward(ctx, v, sigma, k, clamp):
        ctx.save_for_backward(v, sigma)
        ctx.k, ctx.clamp = k, clamp
        return _launch_kl(v, sigma, k, clamp)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        v, sigma = ctx.saved_tensors
        return _launch_bwd(v, sigma, g, ctx.k, ctx.clamp, True) + (None,
                                                                    None)


def _checked(v, sigma, k):
    """Whether (v, sigma) go to the kernels (both on one CUDA device, of
    the kernels' layout and type) or to the plain version (both on the
    CPU); anything else raises."""
    if v.device.type == "cpu" and sigma.device.type == "cpu":
        return False
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
    if v.numel() >= 3 * (2 ** 31 - 128):
        raise ValueError(f"{v.shape[0] * v.shape[1]} samples: the kernels "
                         "index at most 2**31 - 129")
    return True


def _grad_wanted(v, sigma):
    return torch.is_grad_enabled() and (v.requires_grad
                                        or sigma.requires_grad)


def so3_wrapped_log_density_fused(v, sigma, k=10, clamp=1e-3):
    """log q(exp(v)), v (n, B, 3), sigma (B, 3) -> (n, B).

    CUDA tensors go through the kernel (float32, contiguous; anything else
    raises), with the backward kernel when a gradient is needed; CPU
    tensors through the plain density. Each launch of the forward kernel
    adds one to ``so3_wrapped_log_density_fused.launches``, each of the
    backward kernel one to ``.launches_backward``.
    """
    if not _checked(v, sigma, k):
        return so3_wrapped_log_density_plain(v, sigma, k, clamp)
    n, B = v.shape[:2]
    if n * B == 0:
        return v.new_zeros((n, B))
    vf = v.reshape(n * B, 3)
    if _grad_wanted(v, sigma):
        out = _WrappedDensity.apply(vf, sigma, int(k), float(clamp))
    else:
        out = _launch_fwd(vf, sigma, int(k), float(clamp))
    return out.view(n, B)


def so3_wrapped_kl_fused(v, sigma, k=10, clamp=1e-3):
    """The Monte-Carlo KL against the Haar prior, mean over the n samples of
    log q(exp(v)) - LOG_HAAR_UNIFORM: v (n, B, 3), sigma (B, 3) -> (B,).

    CUDA tensors go through one launch of the forward kernel (the mean and
    the prior folded in; it counts in
    ``so3_wrapped_log_density_fused.launches``) and, for a gradient, one of
    the backward kernel, which takes the (B,) cotangent as it comes;
    CPU tensors through the plain KL.
    """
    if not _checked(v, sigma, k):
        return so3_wrapped_kl_plain(v, sigma, k, clamp)
    n, B = v.shape[:2]
    if n * B == 0:
        return v.new_full((B,), float("nan"))     # the mean of no samples
    vf = v.reshape(n * B, 3)
    if _grad_wanted(v, sigma):
        return _WrappedKL.apply(vf, sigma, int(k), float(clamp))
    return _launch_kl(vf, sigma, int(k), float(clamp))


so3_wrapped_log_density_fused.launches = 0
so3_wrapped_log_density_fused.launches_backward = 0
