"""Plain PyTorch reference of the Lie-group VAE that the benchmark holds the
port to: the training step (forward, ELBO, the equivariance and continuity
regularizers, autograd, the global-norm clip and Adam) and the
reconstruct of a served model.

It follows the published description (arXiv:1807.04689, the reference's
``lie_vae`` package) for the configurations of ``port_bench/configs``: an
SO(3) latent with the S2xS2 mean, the algebra-noise reparameterization
z = mu exp(eps sigma), the block Wigner-D action decoder (the
Pinchon-Hoggan chain Z(a) J Z(b) J Z(g), here formed as dense blocks), the
k-shell wrapped density's Monte-Carlo KL against the Haar prior, and the
transpose-conv image head. Everything is written out with torch tensor
operations: convolutions by ``F.conv2d``/``F.conv_transpose2d``,
BatchNorm by its own mean and biased variance, the in-plane rotation of
the equivariance loss by gathers of two taps a row. It imports nothing of
the program and carries its own copy of the J tables (``jd_tables.npz``
beside this file).

Parameters are a dict of tensors keyed as the reference's ``state_dict``
(``encoder.0.weight`` ... ``decoder.deconv.9.bias``); the functions work
in the dtype and on the device of the tensors given.
"""
import contextlib
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "jd_tables.npz")
LOG_HAAR = -math.log(8.0 * math.pi ** 2)
BN_EPS = 1e-5
SLOPE = 0.2


@contextlib.contextmanager
def precision(mode):
    """Float32 convolutions and matmuls in ``mode`` ('ieee', or 'tf32' for
    the control), the previous settings restored after."""
    conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    saved = (conv.fp32_precision, mm.fp32_precision)
    conv.fp32_precision = mm.fp32_precision = mode
    try:
        yield
    finally:
        conv.fp32_precision, mm.fp32_precision = saved


def _check(model):
    want = {"latent_mode": "so3", "decoder_mode": "action",
            "mean_mode": "s2s2", "encode_mode": "conv",
            "deconv_mode": "deconv", "batch_norm": True}
    for k, v in want.items():
        if model.get(k, v) != v:
            raise ValueError(f"the reference implements {k}={v!r}, "
                             f"not {model[k]!r}")


# ------------------------------------------------------------ the network

def _bn(h, p, name, train):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if train:
        mean = h.mean(dim=(0, 2, 3))
        var = ((h - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
    else:
        mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    scale = w / torch.sqrt(var + BN_EPS)
    return (h - mean[:, None, None]) * scale[:, None, None] \
        + b[:, None, None]


def encoder(p, x, train):
    """NHWC images in [0, 1] -> features (B, out): four k4 s2 p1 convs,
    each with BatchNorm and LeakyReLU(0.2), then a k4 s1 p0 conv."""
    h = x.permute(0, 3, 1, 2)
    for i in range(4):
        h = F.conv2d(h, p[f"encoder.{3 * i}.weight"],
                     p[f"encoder.{3 * i}.bias"], stride=2, padding=1)
        h = _bn(h, p, f"encoder.{3 * i + 1}", train)
        h = torch.where(h >= 0, h, SLOPE * h)
    h = F.conv2d(h, p["encoder.12.weight"], p["encoder.12.bias"])
    return h.flatten(1)


def _linear(h, p, name):
    return h @ p[name + ".weight"].T + p[name + ".bias"]


def _unit(v):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)),
                           min=1e-5)


def posterior(p, h):
    """The S2xS2 mean rotation (B, 3, 3), rows e1, e2, e1 x e2 by
    Gram-Schmidt, and the algebra noise scale (B, 3), softplus floored at
    1e-6."""
    v = _linear(h, p, "reparameterize.0.mean_module.map")
    e1 = _unit(v[:, :3])
    v2 = v[:, 3:]
    e2 = _unit(v2 - (e1 * v2).sum(-1, keepdim=True) * e1)
    e3 = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                      e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                      e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], -1)
    mu = torch.stack([e1, e2, e3], -2)
    sigma = torch.clamp(F.softplus(_linear(
        h, p, "reparameterize.0.reparameterize.sigma_linear")), min=1e-6)
    return mu, sigma


def _skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def expmap(v):
    """Rodrigues: I + sin t / t K + (1 - cos t) / t^2 K^2, with the
    series below t^2 = 1e-8."""
    K = _skew(v)
    t2 = (v * v).sum(-1)[..., None, None]
    small = t2 < 1e-8
    safe = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(safe)
    a = torch.where(small, 1 - t2 / 6 + t2 * t2 / 120, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24 + t2 * t2 / 720,
                    (1 - torch.cos(t)) / safe)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + a * K + b * (K @ K)


def zyz(R):
    """Rotation matrices (N, 3, 3) -> ZYZ Euler angles (N, 3) through the
    quaternion of the reference's layout (Shepperd's four cases, the case
    picked by the largest detached denominator)."""
    r = R
    d0, d1, d2 = r[:, 0, 0], r[:, 1, 1], r[:, 2, 2]
    den = 0.5 * torch.sqrt(1e-6 + torch.stack([
        1 + d0 - d1 - d2, 1 - d0 + d1 - d2, 1 - d0 - d1 + d2,
        1 + d0 + d1 + d2], -1).abs())
    s01, s02, s12 = r[:, 0, 1] + r[:, 1, 0], r[:, 0, 2] + r[:, 2, 0], \
        r[:, 1, 2] + r[:, 2, 1]
    a12, a20, a01 = r[:, 1, 2] - r[:, 2, 1], r[:, 2, 0] - r[:, 0, 2], \
        r[:, 0, 1] - r[:, 1, 0]
    f = 4 * den
    cand = torch.stack([
        torch.stack([den[:, 0], s01 / f[:, 0], s02 / f[:, 0],
                     a12 / f[:, 0]], -1),
        torch.stack([s01 / f[:, 1], den[:, 1], s12 / f[:, 1],
                     a20 / f[:, 1]], -1),
        torch.stack([s02 / f[:, 2], s12 / f[:, 2], den[:, 2],
                     a01 / f[:, 2]], -1),
        torch.stack([a12 / f[:, 3], a20 / f[:, 3], a01 / f[:, 3],
                     den[:, 3]], -1)], 1)
    pick = den.detach().argmax(-1)
    q = cand[torch.arange(r.shape[0], device=r.device), pick]
    q0, q1, q2, q3 = q.unbind(-1)
    alpha = torch.atan2(q1 * q2 - q0 * q3, q0 * q2 + q1 * q3)
    beta = torch.acos(torch.clamp(q3 ** 2 - q0 ** 2 - q1 ** 2 + q2 ** 2,
                                  -1 + 1e-6, 1 - 1e-6))
    gamma = torch.atan2(q0 * q3 + q1 * q2, q1 * q3 - q0 * q2)
    return torch.stack([alpha, beta, gamma], -1)


def _j_blocks(L, dtype, device):
    with np.load(TABLES) as t:
        return [torch.as_tensor(t[f"J{l}"], dtype=dtype, device=device)
                for l in range(L + 1)]


def _zrot(t, l):
    """(N, 2l+1, 2l+1): row i has frequency l - i, cos on the diagonal and
    sin at column 2l - i."""
    f = torch.arange(l, -l - 1, -1, dtype=t.dtype, device=t.device)
    c, s = torch.cos(f * t[:, None]), torch.sin(f * t[:, None])
    eye = torch.eye(2 * l + 1, dtype=t.dtype, device=t.device)
    return c[:, :, None] * eye + s[:, :, None] * eye.flip(1)


def wigner_action(angles, item_rep, L):
    """Each degree's dense Wigner-D block Z(a) J Z(b) J Z(g) applied to its
    rows of the shared spectrum (S, C): (N, S, C)."""
    a, b, g = angles.unbind(-1)
    out = []
    for l, J in enumerate(_j_blocks(L, angles.dtype, angles.device)):
        D = _zrot(a, l) @ J @ _zrot(b, l) @ J @ _zrot(g, l)
        out.append(D @ item_rep[l * l:(l + 1) ** 2])
    return torch.cat(out, 1)


def deconv(p, x, hidden):
    """(N, S C) -> NHWC images: 1x1 -> 4x4, three k4 s2 p1 transpose
    convs with ReLU, then the k4 s2 p1 image head."""
    h = x[:, :, None, None]
    h = F.relu(F.conv_transpose2d(h, p["decoder.deconv.1.weight"],
                                  p["decoder.deconv.1.bias"]))
    for i in (3, 5, 7):
        h = F.relu(F.conv_transpose2d(h, p[f"decoder.deconv.{i}.weight"],
                                      p[f"decoder.deconv.{i}.bias"],
                                      stride=2, padding=1))
    h = F.conv_transpose2d(h, p["decoder.deconv.9.weight"],
                           p["decoder.deconv.9.bias"], stride=2, padding=1)
    return h.permute(0, 2, 3, 1)


def decode(p, R, model):
    spec = wigner_action(zyz(R), p["decoder.item_rep"], model["degrees"])
    return deconv(p, spec.flatten(1), model["deconv_hidden"])


def kl(v, sigma, k):
    """Mean over the samples of the k-shell wrapped density of
    exp(v), v ~ N(0, diag sigma^2), less the Haar log-density: (B,)."""
    theta = torch.sqrt((v * v).sum(-1, keepdim=True))
    u = v / torch.clamp(theta, min=1e-12)
    terms = []
    for j in range(-k, k + 1):
        th = theta + 2 * math.pi * j
        x = u * th
        logp = (-0.5 * (x / sigma) ** 2 - torch.log(sigma)
                - 0.5 * math.log(2 * math.pi)).sum(-1)
        vol = torch.log(torch.clamp(th ** 2, min=1e-3)
                        / torch.clamp(2 - 2 * torch.cos(th), min=1e-3))
        terms.append(logp + vol[..., 0])
    logq = torch.logsumexp(torch.stack(terms, -1), -1)
    return (logq - LOG_HAAR).mean(0)


# ----------------------------------------------------- the regularizers

def _lerp_rows(img, pos):
    """img (B, H, W, C) sampled along W at pos (B, H, W): linear between
    the two neighbouring columns, zero outside the image."""
    w = img.shape[2]
    lo = torch.floor(pos)
    frac = (pos - lo)[..., None]
    lo = lo.long()

    def tap(i):
        ok = ((i >= 0) & (i < w))[..., None].to(img.dtype)
        idx = i.clamp(0, w - 1)[..., None].expand(-1, -1, -1, img.shape[3])
        return torch.gather(img, 2, idx) * ok

    return tap(lo) * (1 - frac) + tap(lo + 1) * frac


def rotate(img, theta):
    """In-plane rotation of square NHWC images: theta wrapped to
    [-pi, pi), the nearest quarter turn done exactly, the rest phi by
    Paeth's shears x(-tan(phi/2)), y(sin phi), x(-tan(phi/2)) about the
    centre, each a linear resample along one axis."""
    b, h, w, c = img.shape
    theta = torch.remainder(theta + math.pi, 2 * math.pi) - math.pi
    k = torch.round(theta / (math.pi / 2))
    phi = theta - k * (math.pi / 2)
    turns = torch.remainder(k.long(), 4)
    base = torch.empty_like(img)
    for r in range(4):
        sel = turns == r
        base[sel] = torch.rot90(img[sel], r, dims=(1, 2))
    y = torch.arange(h, dtype=img.dtype, device=img.device) - (h - 1) / 2
    cols = torch.arange(w, dtype=img.dtype, device=img.device)
    s_row = -torch.tan(phi / 2)[:, None] * y[None]          # (B, H)
    s_col = torch.sin(phi)[:, None] * y[None]               # (B, W)

    def shear_x(t, s):
        return _lerp_rows(t, cols[None, None, :] + s[:, :, None])

    out = shear_x(base, s_row)
    out = shear_x(out.transpose(1, 2), s_col).transpose(1, 2)
    return shear_x(out, s_row)


def x_axis_rotation(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    o, i = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([i, o, o], -1),
                        torch.stack([o, c, -s], -1),
                        torch.stack([o, s, c], -1)], -2)


# ----------------------------------------------------------- the entries

def sample(p, x, eps, train):
    """Encode NHWC images and draw z = mu exp(eps sigma): (mu, sigma, v,
    z) with v, z over the sample axis of eps (n, B, 3)."""
    mu, sigma = posterior(p, encoder(p, x, train))
    v = eps * sigma
    return mu, sigma, v, mu @ expmap(v)


def loss(p, x_uint8, step, model, train_cfg):
    """The step's loss on a batch of uint8 NHWC images, and its unweighted
    terms; ``step`` holds the posterior noise ``eps`` (1, B, 3) and, with
    the equivariance loss, ``theta`` (B,) and ``eq_eps`` (1, B, 3), and the
    regularizers' weights ``equivariance`` and ``encoder_continuity``
    (None: left out)."""
    x = x_uint8.to(p["decoder.item_rep"].dtype) / 255.0
    mu, sigma, v, z = sample(p, x, step["eps"], True)
    n, b = z.shape[:2]
    x_rec = decode(p, z.reshape(n * b, 3, 3), model).reshape(
        (n, b) + x.shape[1:])
    parts = {"recon": ((x_rec - x) ** 2).sum(dim=(2, 3, 4)).mean(),
             "kl": kl(v, sigma, model["density_k"]).mean()}
    total = parts["recon"] + train_cfg["beta"] * parts["kl"]
    enc = z[0]
    if step.get("equivariance") is not None:
        g = x_axis_rotation(step["theta"].to(x.dtype))
        rot = sample(p, rotate(x, step["theta"].to(x.dtype)),
                     step["eq_eps"], True)[3][0]
        parts["equivariance"] = ((g @ enc - rot) ** 2).sum(
            dim=(-2, -1)).mean()
        total = total + step["equivariance"] * parts["equivariance"]
    if step.get("encoder_continuity") is not None:
        e = enc.reshape(b // 2, 2, 9)
        parts["encoder_continuity"] = ((e[:, 0] - e[:, 1]) ** 2).sum(
            -1).mean()
        total = total + step["encoder_continuity"] \
            * parts["encoder_continuity"]
    return total, parts


def train_steps(weights, batches, steps, model, train_cfg):
    """Train from ``weights`` over ``batches`` (uint8 NHWC, one a step) with
    the inputs of ``steps`` (see :func:`loss`): each step the loss, its
    gradient globally clipped to ``clip_grads`` (no clip when its norm is
    below), coupled L2 ``weight_decay`` and Adam (``lr``, ``adam_b1``,
    ``adam_b2``, ``adam_eps``, bias-corrected). Returns the losses (float),
    the first step's gradients as Adam takes them and the parameters after
    the last step, each a dict keyed as ``weights``' parameters, and each
    step's unweighted loss terms (``parts``)."""
    _check(model)
    names = [k for k in weights if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    p = {k: weights[k].detach().clone() for k in weights}
    mu = {k: torch.zeros_like(p[k]) for k in names}
    nu = {k: torch.zeros_like(p[k]) for k in names}
    b1, b2 = train_cfg["adam_b1"], train_cfg["adam_b2"]
    losses, parts, first = [], [], None
    for t, (x, step) in enumerate(zip(batches, steps), start=1):
        for k in names:
            p[k].requires_grad_(True)
        value, terms = loss(p, x, step, model, train_cfg)
        grads = torch.autograd.grad(value, [p[k] for k in names])
        losses.append(value.detach())
        parts.append({k: v.detach() for k, v in terms.items()})
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        clip = train_cfg["clip_grads"]
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        with torch.no_grad():
            grads = {k: g * scale + train_cfg["weight_decay"] * p[k]
                     for k, g in zip(names, grads)}
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            for k in names:
                mu[k] = b1 * mu[k] + (1 - b1) * grads[k]
                nu[k] = b2 * nu[k] + (1 - b2) * grads[k] ** 2
                upd = (mu[k] / (1 - b1 ** t)) / (
                    torch.sqrt(nu[k] / (1 - b2 ** t)) + train_cfg["adam_eps"])
                p[k] = p[k].detach() - train_cfg["lr"] * upd
    return {"losses": [float(v) for v in losses], "grads": first,
            "params": {k: p[k].detach() for k in names},
            "parts": [{k: float(v) for k, v in d.items()} for d in parts]}


@torch.no_grad()
def reconstruct(weights, images_uint8, model, block=256):
    """Encode uint8 NHWC images in eval mode (BatchNorm's running
    statistics), decode the posterior mean rotation: float NHWC images,
    computed ``block`` rows at a time."""
    _check(model)
    p = weights
    outs = []
    for lo in range(0, images_uint8.shape[0], block):
        # a served request is scaled to [0, 1] in float32, as its images
        # arrive over the wire
        x = (images_uint8[lo:lo + block].float() / 255.0).to(
            p["decoder.item_rep"].dtype)
        mu, _ = posterior(p, encoder(p, x, False))
        outs.append(decode(p, mu, model))
    return torch.cat(outs)


def load_checkpoint(path, device, dtype=None):
    """A reference ``state_dict`` file as this module's dict, its floats in
    ``dtype`` (torch's default): the duplicate ``rep_group.*`` entries
    left out."""
    dtype = dtype or torch.get_default_dtype()
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(device, dtype if v.is_floating_point() else v.dtype)
            for k, v in sd.items() if not k.startswith("rep_group.")}
