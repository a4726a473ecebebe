"""Networks: the convolutional encoder, the transpose-convolutional decoder
head and the MLP, NCHW.

Counterparts of ``ConvEncoder``, ``DeconvNet`` and ``MLP`` in the JAX
package's ``models/nets.py``. Each is an ``nn.Sequential`` laid out as the
original PyTorch reference's, so their state_dict keys
(``encoder.0.weight`` ... ``decoder.deconv.9.weight``, ``decoder.mlp.4.bias``)
are the reference checkpoint's. The JAX ``fast_head`` (a phase
decomposition of the stride-2 transpose conv, an XLA rewrite and not a
Pallas kernel) computes the same function as
``nn.ConvTranspose2d(k=4, s=2, p=1)``.

A convolution takes one path, fixed by its shape, its dtype and its
device, whether or not it has a compute dtype or a ``model`` split. In
float32 on a card, a layer whose window covers its whole input (the
encoder's last conv, ``DeconvNet``'s 1x1 -> 4x4 first) is one matrix
product, and a hidden k4 s2 p1 transposed conv runs its forward in that
sub-pixel form (one stride-1 2x2 convolution of the four output phases,
interleaved) and its weight gradient by ``ops.kernels.deconv_wgrad``
(:func:`conv_transpose_s2`). The rest (the image heads, bfloat16, the
CPU) goes to cuDNN or the CPU's own convolution. Each route is the one
measured fastest for its case (``compare_deconv``, ``PERF.md``).

Compute dtypes follow flax's ``dtype=`` on a layer: the parameters stay
float32; with a ``compute_dtype`` (e.g. ``torch.bfloat16``) a layer casts
its input, weight and bias to it, computes the product without the bias,
then adds the bias in that dtype, so the output is rounded where flax's
is; BatchNorm takes its statistics and normalises in float32 and rounds
its output once to its input's dtype; LeakyReLU multiplies a bfloat16
input by its slope rounded to bfloat16 (JAX casts the weakly typed
Python float to the input's dtype); a stack's output goes back to
float32. Without one a layer computes in the promoted dtype of its input
and its weight, as flax's does. The dtype is a plain attribute: it adds no
parameter or buffer, so the state_dict keys stay the reference's.

Over a process mesh (``parallel.shard_state``) a layer whose weight is
split over ``model`` computes its block of output features and gathers
them, and BatchNorm in train mode takes its statistics over the global
batch of the ``data`` group.
"""
import functools

import torch
import torch.nn.functional as F
from torch import nn

from lie_vae_tpu_torch.ops.kernels.deconv_wgrad import deconv_wgrad
from lie_vae_tpu_torch.ops.kernels.deconv_wgrad import (
    supports as deconv_wgrad_supports)

ACTIVATIONS = {"relu": nn.ReLU, "softplus": nn.Softplus, "tanh": nn.Tanh}

_LOW = (torch.bfloat16, torch.float16)


def _to_float32(x):
    """A low-precision stack output back to float32; others as they are."""
    return x.float() if x.dtype in _LOW else x


class _CastMixin:
    """A layer with an optional ``compute_dtype`` (:mod:`nets`): the
    product with its bias by the layer's shape (``_product``); over a
    ``model`` split the product of the rank's block of output features,
    gathered over the features, then the bias, which stays whole."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cdt = self.compute_dtype or torch.promote_types(x.dtype,
                                                        self.weight.dtype)
        x, w, bias = x.to(cdt), self.weight.to(cdt), self.bias.to(cdt)
        split = getattr(self, "model_split", None)
        if split is None:
            return self._product(x, w, bias)
        # the weight holds this rank's block of output features
        # (parallel.shard_state)
        y = split.gather(self._product(split.copy_in(x), w), self._features)
        return y + (bias if self._features == -1 else bias[:, None, None])

    def _inside(self, bias):
        """The bias a library's product may take into its sums: without a
        compute dtype (with one, flax rounds the product, then the sum)."""
        return bias if self.compute_dtype is None else None


class Linear(_CastMixin, nn.Linear):
    _features = -1

    def _product(self, x, w, bias=None):
        """``F.linear``, the bias inside where :meth:`_inside` allows."""
        inside = self._inside(bias)
        y = F.linear(x, w, inside)
        return y if bias is None or inside is not None else y + bias


class Conv2d(_CastMixin, nn.Conv2d):
    _features = 1

    def _product(self, x, w, bias=None):
        """In float32 on a card, a layer whose window covers its whole
        input (``ConvEncoder``'s last) as one matrix product over the
        input's channels-last rows, the bias after; any other through
        ``conv2d``, the bias inside where :meth:`_inside` allows."""
        if (_card_float32(x) and self.kernel_size == tuple(x.shape[-2:])
                and self.padding == (0, 0) and self.dilation == (1, 1)
                and self.groups == 1):
            n, c_out = x.shape[0], w.shape[0]
            y = F.linear(x.permute(0, 2, 3, 1).reshape(n, -1),
                         w.permute(0, 2, 3, 1).reshape(c_out, -1))
            y = y.view(n, c_out, 1, 1)
        else:
            inside = self._inside(bias)
            y = F.conv2d(x, w, inside, self.stride, self.padding,
                         self.dilation, self.groups)
            if inside is not None:
                return y
        return _add_bias(y, bias)


class ConvTranspose2d(_CastMixin, nn.ConvTranspose2d):
    _features = 1

    def _product(self, x, w, bias=None):
        """In float32 on a card, a hidden k4 s2 p1 layer (C_out of at
        least 25 and an input width ``deconv_wgrad`` is built for) through
        :func:`conv_transpose_s2` and a k4 s1 p0 layer on a 1x1 input
        (``DeconvNet``'s first) as one matrix product, the bias after; any
        other through ``conv_transpose2d``, the bias inside where
        :meth:`_inside` allows."""
        plain = (_card_float32(x) and self.output_padding == (0, 0)
                 and self.dilation == (1, 1) and self.groups == 1
                 and self.kernel_size == (4, 4))
        if (plain and self.stride == (2, 2) and self.padding == (1, 1)
                and deconv_wgrad_supports(w.shape[1], x.shape[-1])):
            return conv_transpose_s2(x, w, bias)
        if (plain and self.stride == (1, 1) and self.padding == (0, 0)
                and x.shape[-2:] == (1, 1)):
            n, c_in, c_out = x.shape[0], w.shape[0], w.shape[1]
            y = (x.flatten(1) @ w.reshape(c_in, 16 * c_out)).view(
                n, c_out, 4, 4)
        else:
            inside = self._inside(bias)
            y = F.conv_transpose2d(x, w, inside, self.stride, self.padding,
                                   self.output_padding, self.groups,
                                   self.dilation)
            if inside is not None:
                return y
        return _add_bias(y, bias)


def _card_float32(x):
    """Whether ``x`` is float32 on a card: where the matrix products, the
    sub-pixel forward and ``deconv_wgrad`` were measured faster than
    cuDNN's convolutions (in bfloat16 and on the CPU they were not;
    ``PERF.md``)."""
    return x.is_cuda and x.dtype == torch.float32


def _add_bias(y, bias):
    """The product, then the bias in the product's dtype (a backend that
    took the bias into its sums would round a bfloat16 output once where
    flax rounds it twice)."""
    return y if bias is None else y + bias[:, None, None]


def _phase_kernel(w):
    """(C_in, C_out, 4, 4) transposed-conv weight -> the (4 C_out, C_in, 2,
    2) conv2d weight whose output channels are the four output phases
    (r, s, C_out): output row 2m + r reads input rows m - 1 + r + t, t in
    (0, 1), through kernel row 3 - r - 2t, and columns likewise."""
    c_in, c_out = w.shape[:2]
    a = w.flip(2, 3).reshape(c_in, c_out, 2, 2, 2, 2)   # (.., t, r, u, s)
    return a.permute(3, 5, 1, 0, 2, 4).reshape(4 * c_out, c_in, 2, 2)


def _phases(o, c_out, h, w):
    """The (B, C_out, H, 2, W, 2) view of the phase conv's (B, 4 C_out,
    H + 1, W + 1) output that is the transposed conv's output: phase (r, s)
    of output (2m + r, 2n + s) sits at (m + r, n + s)."""
    sb, sc, sh, sw = o.stride()
    return o.as_strided(
        (o.shape[0], c_out, h, 2, w, 2),
        (sb, sc, sh, 2 * c_out * sc + sh, sw, c_out * sc + sw),
        o.storage_offset())


def phase_forward(x, w, bias=None):
    """``F.conv_transpose2d(x, w, bias, stride=2, padding=1)`` of a 4x4
    kernel in its sub-pixel form: one stride-1 2x2 convolution of ``x``
    padded by one, whose 4 C_out output channels are the four output
    phases, written interleaved into the NCHW output with the bias added
    in the same pass; ``x`` NCHW."""
    n, _, h, wd = x.shape
    c_out = w.shape[1]
    o = F.conv2d(x, _phase_kernel(w).contiguous(), None, 1, 1)
    y = torch.empty((n, c_out, 2 * h, 2 * wd), dtype=o.dtype,
                    device=o.device)
    y6 = y.unflatten(3, (wd, 2)).unflatten(2, (h, 2))
    if bias is None:
        y6.copy_(_phases(o, c_out, h, wd))
    else:
        torch.add(_phases(o, c_out, h, wd), bias.view(1, c_out, 1, 1, 1, 1),
                  out=y6)
    return y


class _ConvTransposeS2(torch.autograd.Function):
    """A k4 s2 p1 transposed conv, NCHW: the forward in the sub-pixel form
    (:func:`phase_forward`), dx by cuDNN (its forward-conv GEMM), dw by
    :func:`~lie_vae_tpu_torch.ops.kernels.deconv_wgrad.deconv_wgrad` (the
    kernel on a card, its plain version on the CPU), db a sum."""

    @staticmethod
    def forward(ctx, x, w, bias):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return phase_forward(x, w, bias)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = None
        if need_x:
            dx = torch.ops.aten.convolution_backward(
                dy, x, w, None, [2, 2], [1, 1], [1, 1], True, [0, 0], 1,
                [True, False, False])[0]
        dw = deconv_wgrad(x, dy) if need_w else None
        db = dy.sum(dim=(0, 2, 3)) if ctx.has_bias and need_b else None
        return dx, dw, db


def conv_transpose_s2(x, w, bias=None):
    """``F.conv_transpose2d(x, w, bias, stride=2, padding=1)`` for a
    (C_in, C_out, 4, 4) weight (:class:`_ConvTransposeS2`); NCHW out."""
    return _ConvTransposeS2.apply(x, w, bias)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update of the running statistics
    is flax's: ``running_var`` moves toward the biased batch variance (torch
    uses the unbiased one), ``running = (1 - momentum) running + momentum
    batch`` with momentum 0.1 (flax's 0.9 on the old value). Normalisation
    is unchanged (both libraries use the biased batch variance inside the
    step), and so are the state_dict keys. A bfloat16 or float16 input is
    normalised in float32 (its statistics too) and the output rounded once
    back to the input's dtype, as flax's ``BatchNorm(dtype=...)`` does."""

    def forward(self, x):
        if x.dtype in _LOW:
            return self._normalize(x.float()).to(x.dtype)
        return self._normalize(x)

    def _normalize(self, x):
        if not self.training:
            return super().forward(x)
        if getattr(self, "data_mesh", None) is not None:
            return self._normalize_global(x, self.data_mesh)
        y = F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                         momentum=0.0, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        return y

    def _normalize_global(self, x, mesh):
        """Train mode over a ``data`` mesh (``parallel.shard_state``): the
        mean and the biased variance of the global batch, each a sum
        all-reduced over the ``data`` group (two passes: the variance sums
        squares about the global mean), whose gradients flow back to every
        rank's rows; every rank holds as many rows."""
        from lie_vae_tpu_torch.parallel.mesh import AllReduceSum
        count = x.shape[0] * x.shape[2] * x.shape[3] * mesh.shape["data"]
        mean = AllReduceSum.apply(x.sum(dim=(0, 2, 3)), mesh) / count
        d = x - mean[None, :, None, None]
        var = AllReduceSum.apply((d * d).sum(dim=(0, 2, 3)), mesh) / count
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = d * scale[None, :, None, None] + self.bias[None, :, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
            self.running_var.mul_(1.0 - m).add_(m * var.detach())
            self.num_batches_tracked.add_(1)
        return y


@functools.lru_cache(maxsize=None)
def _rounded(value, dtype):
    return float(torch.tensor(value, dtype=dtype))


class LeakyReLU(nn.LeakyReLU):
    """``nn.LeakyReLU`` that, on a bfloat16 or float16 input, multiplies by
    its slope rounded to that dtype first, as flax's ``leaky_relu`` does
    (0.2 becomes 0.2001953125 in bfloat16); the product of two bfloat16
    numbers is exact in float32 and rounds once, as in XLA."""

    def forward(self, x):
        slope = self.negative_slope
        if x.dtype in _LOW:
            slope = _rounded(slope, x.dtype)
        return F.leaky_relu(x, slope, self.inplace)


class MLP(nn.Sequential):
    """Linear layers with an activation between each two:
    in -> hidden (num_layers times) -> out; ``num_layers=0`` is one Linear.
    The reference's layout (linears at Sequential indices 0, 2, ...);
    ``activation`` a key of :data:`ACTIVATIONS`; ``dtype`` the compute
    dtype, the output float32 (:mod:`nets`)."""

    def __init__(self, in_dims, out_dims, hidden_dims, num_layers=1,
                 activation="relu", dtype=None):
        act = ACTIVATIONS[activation]
        widths = [in_dims] + [hidden_dims] * num_layers
        layers = []
        for a, b in zip(widths, widths[1:]):
            layers += [Linear(a, b, compute_dtype=dtype), act()]
        layers.append(Linear(widths[-1], out_dims, compute_dtype=dtype))
        super().__init__(*layers)

    def forward(self, x):
        return _to_float32(super().forward(x))


class ConvEncoder(nn.Sequential):
    """Five strided convs, 64x64 -> out_dims: channels in -> h -> 2h -> 4h
    -> 8h -> out, kernel 4 stride 2 pad 1 (the last 4/1/0), each but the
    last followed by BatchNorm (eps 1e-5, momentum 0.1 with flax's biased
    running variance; optional) and LeakyReLU(0.2); ``dtype`` the convs'
    compute dtype (:mod:`nets`). Takes NCHW, returns float32
    (B, out_dims)."""

    def __init__(self, out_dims, hidden_dims=50, rgb=False, batch_norm=True,
                 dtype=None):
        h = hidden_dims
        widths = [h, 2 * h, 4 * h, 8 * h]
        layers, c_in = [], 3 if rgb else 1
        for w in widths:
            layers.append(Conv2d(c_in, w, 4, 2, 1, compute_dtype=dtype))
            if batch_norm:
                layers.append(BatchNorm2d(w, eps=1e-5, momentum=0.1))
            layers.append(LeakyReLU(0.2))
            c_in = w
        layers.append(Conv2d(c_in, out_dims, 4, 1, 0, compute_dtype=dtype))
        super().__init__(*layers)

    def forward(self, x):
        return _to_float32(super().forward(x).flatten(1))


class DeconvNet(nn.Sequential):
    """(B, in_dims) -> (B, 1|3, 64, 64) NCHW: a 1x1 -> 4x4 transpose conv,
    three k4 s2 ones to 32x32, each with ReLU, and a k4 s2 image head with
    no output nonlinearity. ``dtype`` is the stack's compute dtype,
    ``head_dtype`` the image head's (``'unset'``: the stack's); the output
    is float32 (:mod:`nets`)."""

    def __init__(self, in_dims, hidden_dims, rgb=False, dtype=None,
                 head_dtype="unset"):
        h = hidden_dims
        hd = dtype if head_dtype == "unset" else head_dtype
        super().__init__(
            nn.Unflatten(1, (in_dims, 1, 1)),
            ConvTranspose2d(in_dims, h, 4, 1, 0, compute_dtype=dtype),
            nn.ReLU(),
            ConvTranspose2d(h, h, 4, 2, 1, compute_dtype=dtype), nn.ReLU(),
            ConvTranspose2d(h, h, 4, 2, 1, compute_dtype=dtype), nn.ReLU(),
            ConvTranspose2d(h, h, 4, 2, 1, compute_dtype=dtype), nn.ReLU(),
            ConvTranspose2d(h, 3 if rgb else 1, 4, 2, 1, compute_dtype=hd))

    def forward(self, x):
        return _to_float32(super().forward(x))
