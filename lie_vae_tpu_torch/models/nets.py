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

ACTIVATIONS = {"relu": nn.ReLU, "softplus": nn.Softplus, "tanh": nn.Tanh}

_LOW = (torch.bfloat16, torch.float16)


def _to_float32(x):
    """A low-precision stack output back to float32; others as they are."""
    return x.float() if x.dtype in _LOW else x


class _CastMixin:
    """A layer with an optional ``compute_dtype`` (:mod:`nets`)."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cdt = self.compute_dtype
        split = getattr(self, "model_split", None)
        if cdt is None and split is None:
            dt = torch.promote_types(x.dtype, self.weight.dtype)
            return super().forward(x.to(dt))
        if cdt is None:
            cdt = torch.promote_types(x.dtype, self.weight.dtype)
        if split is None:
            y = self._product(x.to(cdt), self.weight.to(cdt))
        else:
            # the weight holds this rank's block of output features
            # (parallel.shard_state): the product's block, then the
            # gathered features; the bias stays whole and is added after
            y = self._product(split.copy_in(x.to(cdt)), self.weight.to(cdt))
            y = split.gather(y, -1 if isinstance(self, nn.Linear) else 1)
        bias = self.bias.to(cdt)
        return y + (bias if isinstance(self, nn.Linear)
                    else bias[:, None, None])


class Linear(_CastMixin, nn.Linear):
    def _product(self, x, w):
        return F.linear(x, w)


class Conv2d(_CastMixin, nn.Conv2d):
    def _product(self, x, w):
        return F.conv2d(x, w, None, self.stride, self.padding)


class ConvTranspose2d(_CastMixin, nn.ConvTranspose2d):
    def _product(self, x, w):
        return F.conv_transpose2d(x, w, None, self.stride, self.padding)


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
