"""SO(2)-subgroup equivariance regularizer.

Counterpart of the JAX package's ``losses/equivariance.py`` (reference:
EquivarianceLoss, lie_vae/losses/equivariance_loss.py:10-57): for angles
theta, g is the rotation by theta about the x-axis, and the loss asks
``g @ encode(img) == encode(rotate(img, theta))`` in squared Frobenius
norm. Noise is an input: ``theta`` is passed in (the JAX function draws it
from a key), and so is whatever noise ``encode_fn`` samples with.

Two in-plane rotations of NHWC images, both with the align-corners grid and
zeros outside the image:

- ``rotate_images`` ('gather'): one bilinear resample,
  ``torch.nn.functional.grid_sample``, which gives each tap outside the
  image the value 0 as the JAX function's ``map_coordinates`` does;
- ``rotate_images_shear`` ('shear', the training loop's default): the exact
  90-degree pre-rotation nearest to theta, then Paeth's three shears, each a
  batched product with a banded (B, H, W, W) matrix of bilinear weights.
"""
import math

import torch
import torch.nn.functional as F

from lie_vae_tpu_torch.ops.so3 import s2s1rodrigues


def rotate_images(img, theta):
    """Rotate NHWC images in-plane by per-example angles theta (B,):
    out(p) = img(R(theta) p) on the [-1, 1] align-corners grid, bilinear,
    zeros outside."""
    b, h, w, c = img.shape
    theta = torch.as_tensor(theta, dtype=img.dtype, device=img.device)
    ys = torch.linspace(-1.0, 1.0, h, dtype=img.dtype, device=img.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=img.dtype, device=img.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")            # (H, W)
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    sx = cos * gx - sin * gy
    sy = sin * gx + cos * gy
    out = F.grid_sample(img.permute(0, 3, 1, 2),
                        torch.stack([sx, sy], -1), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


def _shear_x(img, s):
    """1-D bilinear resample along W with a per-(example, row) shift s
    (B, H): out[b, y, x] = img[b, y, x + s[b, y]], zeros outside, as the
    product with A[b, y, x, v] = max(0, 1 - |v - x - s[b, y]|)."""
    w = img.shape[2]
    x = torch.arange(w, dtype=img.dtype, device=img.device)
    d = x[None, None, None, :] - x[None, None, :, None] - s[:, :, None, None]
    return torch.clamp(1.0 - torch.abs(d), min=0.0) @ img


def _shear_y(img, s):
    """The same along H with a per-(example, column) shift s (B, W)."""
    return _shear_x(img.transpose(1, 2), s).transpose(1, 2)


def rotate_images_shear(img, theta):
    """In-plane rotation of square NHWC images by Paeth's three shears.

    theta is wrapped to [-pi, pi) and split into the nearest multiple k of
    90 degrees (an exact ``rot90``, picked per example) and a residual phi
    in [-pi/4, pi/4]; then R(phi) = Shear_x(-tan(phi/2)) Shear_y(sin phi)
    Shear_x(-tan(phi/2)), each shear a 1-D bilinear resample. The same
    rotation and centre as :func:`rotate_images`, with three 1-D
    interpolations in place of one 2-D one; exact at multiples of 90
    degrees."""
    b, h, w, c = img.shape
    if h != w:
        raise ValueError(f"square images only, got {h}x{w}")
    theta = torch.as_tensor(theta, dtype=img.dtype, device=img.device)
    theta = torch.remainder(theta + math.pi, 2.0 * math.pi) - math.pi
    k = torch.round(theta / (math.pi / 2.0))
    phi = theta - k * (math.pi / 2.0)
    km = torch.remainder(k.to(torch.int64), 4)
    # rotate_images' convention is out(p) = in(R(theta) p): theta = +90
    # degrees is rot90 with k = +1 over (H, W)
    rots = torch.stack([torch.rot90(img, r, dims=(1, 2)) for r in range(4)])
    base = rots[km, torch.arange(b, device=img.device)]

    yy = torch.arange(h, dtype=img.dtype, device=img.device) - (h - 1) / 2.0
    s_row = -torch.tan(phi / 2.0)[:, None] * yy[None, :]     # (B, H)
    s_col = torch.sin(phi)[:, None] * yy[None, :]            # (B, W)
    out = _shear_x(base, s_row)
    out = _shear_y(out, s_col)
    return _shear_x(out, s_row)


ROTATE_IMPLS = {"gather": rotate_images, "shear": rotate_images_shear}


def equivariance_loss(encode_fn, img, encoding, theta, num_samples=None,
                      rotate_impl="gather"):
    """Returns (mean squared difference, per-example differences (n,)).

    ``encode_fn``: images -> (B, 3, 3) rotations (the first latent's first
    sample); ``encoding``: its value on ``img`` from the main pass; ``theta``
    (B,): the rotation angles; ``num_samples``: use only the first
    num_samples examples (reference: equivariance_loss.py:24-25);
    ``rotate_impl``: a key of ``ROTATE_IMPLS``.
    """
    assert tuple(encoding.shape[-2:]) == (3, 3), \
        "Rotation matrix input required"
    if num_samples:
        img = img[:num_samples]
        encoding = encoding[:num_samples]
    n = img.shape[0]
    theta = torch.as_tensor(theta, device=img.device)[:n].to(img.dtype)
    v = encoding.new_tensor([1.0, 0.0, 0.0]).expand(n, 3)
    s1 = torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    g = s2s1rodrigues(v, s1.to(encoding.dtype))
    enc_rot = g @ encoding
    img_rot_enc = encode_fn(ROTATE_IMPLS[rotate_impl](img, theta))
    diffs = torch.sum((enc_rot - img_rot_enc) ** 2, dim=(-2, -1))
    return torch.mean(diffs), diffs
