"""SO(3) group and algebra operations in PyTorch, batched over leading dims.

Counterpart of ``lie_vae_tpu/ops/so3.py``: same conventions (quaternion
layout, four-case Shepperd selection, ZYZ Euler extraction with the
+/-(1 - 1e-6) clamp) and the same guards. Every singular point uses the
double-``where`` pattern: the unselected branch is fed a safe input, so
autograd stays NaN-free at the identity and at the antipodes.
"""
import math

import torch

__all__ = [
    "hat", "vee", "expmap", "logmap", "s2s1rodrigues", "s2s2_gram_schmidt",
    "vector_to_eazyz", "group_matrix_to_quaternions", "quaternions_to_eazyz",
    "group_matrix_to_eazyz", "eazyz_to_group_matrix",
    "quaternions_to_group_matrix",
    "random_quaternions", "random_group_matrices",
]

# Below this theta^2 the Taylor series of the Rodrigues coefficients is
# more accurate than the trig expressions in float32.
_SMALL = 1e-8


def hat(v):
    """R^3 -> so(3): the skew-symmetric K with K @ x = v x x."""
    if v.shape[-1] != 3:
        raise ValueError(f"input must be (..., 3), got {tuple(v.shape)}")
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def vee(X):
    """so(3) -> R^3, the inverse of :func:`hat`."""
    return torch.stack((-X[..., 1, 2], X[..., 0, 2], -X[..., 0, 1]), -1)


def expmap(v):
    """Exponential map R^3 -> SO(3) by the Rodrigues formula, total at 0.

    R = I + (sin t / t) K + ((1 - cos t) / t^2) K^2, K = hat(v), t = |v|,
    with the Taylor branch below t^2 = 1e-8.
    """
    K = hat(v)
    K2 = K @ K
    t2 = torch.sum(v * v, dim=-1)[..., None, None]
    small = t2 < _SMALL
    t2s = torch.where(small, torch.ones_like(t2), t2)   # safe denominator
    ts = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0,
                    torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                    (1.0 - torch.cos(ts)) / t2s)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + a * K + b * K2


def logmap(R):
    """Log map SO(3) -> so(3) (a 3x3 algebra element), total on SO(3).

    Generic branch theta / (2 sin theta) (R - R^T), Taylor-guarded at 0;
    near the antipode (cos theta < -0.9) the axis comes from the quaternion
    instead, whose vector part is negated relative to Hamilton in this
    layout (hence the factor -2).
    """
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    cos_t = torch.clamp(0.5 * (tr - 1.0), -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.acos(cos_t)
    t2 = theta * theta
    # the clamp floors theta near 4.5e-4, so the Taylor threshold sits
    # above that floor
    small = t2 < 4e-6
    ts = torch.where(small, torch.ones_like(theta), theta)
    coef = torch.where(small, 1.0 + t2 / 6.0 + 7.0 * t2 * t2 / 360.0,
                       ts / torch.sin(ts))
    x_generic = coef * 0.5 * (R - R.transpose(-1, -2))

    q = group_matrix_to_quaternions(R)
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    n2 = torch.sum(q[..., :3] ** 2, dim=-1, keepdim=True)
    tiny = n2 < 1e-12
    n = torch.sqrt(torch.where(tiny, torch.ones_like(n2), n2))
    scale = torch.where(tiny, torch.full_like(n, -2.0),
                        -2.0 * torch.atan2(n, q[..., 3:4]) / n)
    x_pi = hat(scale * q[..., :3])

    near_pi = cos_t < -0.9
    return torch.where(near_pi, x_pi, x_generic)


def s2s1rodrigues(s2_el, s1_el):
    """S^2 x S^1 -> SO(3): the rotation about the unit axis ``s2_el`` by the
    angle whose (cos, sin) is ``s1_el``, I + sin K + (1 - cos) K^2."""
    K = hat(s2_el)
    cos_theta = s1_el[..., 0, None, None]
    sin_theta = s1_el[..., 1, None, None]
    eye = torch.eye(3, dtype=s2_el.dtype, device=s2_el.device)
    return eye + sin_theta * K + (1.0 - cos_theta) * (K @ K)


def s2s2_gram_schmidt(v1, v2):
    """S^2 x S^2 -> SO(3) by Gram-Schmidt; rows are (e1, e2, e1 x e2)."""
    e1 = v1 / torch.clamp(torch.linalg.norm(v1, dim=-1, keepdim=True),
                          min=1e-5)
    u2 = v2 - torch.sum(e1 * v2, dim=-1, keepdim=True) * e1
    e2 = u2 / torch.clamp(torch.linalg.norm(u2, dim=-1, keepdim=True),
                          min=1e-5)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], -2)


def vector_to_eazyz(v):
    """R^3 -> ZYZ Euler angles: tanh squashes each coordinate into
    (-pi, pi) x (0, pi) x (-pi, pi). The constants are scalars, so no
    host-to-device copy runs (a CUDA graph can capture it)."""
    t = torch.tanh(v)
    return torch.stack([t[..., 0] * math.pi,
                        t[..., 1] * (math.pi / 2) + math.pi / 2,
                        t[..., 2] * math.pi], -1)


def group_matrix_to_quaternions(r):
    """SO(3) matrix -> quaternion by four-case selection.

    The case is the argmax of the detached denominators, so no gradient
    flows through the selector.
    """
    if r.shape[-2:] != (3, 3):
        raise ValueError(f"input must be (..., 3, 3), got {tuple(r.shape)}")
    batch_shape = r.shape[:-2]
    r = r.reshape(-1, 3, 3)

    d0, d1, d2 = r[:, 0, 0], r[:, 1, 1], r[:, 2, 2]
    denom_pre = torch.stack([
        1.0 + d0 - d1 - d2,
        1.0 - d0 + d1 - d2,
        1.0 - d0 - d1 + d2,
        1.0 + d0 + d1 + d2,
    ], -1)
    denom = 0.5 * torch.sqrt(1e-6 + torch.abs(denom_pre))

    s01 = r[:, 0, 1] + r[:, 1, 0]
    s02 = r[:, 0, 2] + r[:, 2, 0]
    s12 = r[:, 1, 2] + r[:, 2, 1]
    a12 = r[:, 1, 2] - r[:, 2, 1]
    a20 = r[:, 2, 0] - r[:, 0, 2]
    a01 = r[:, 0, 1] - r[:, 1, 0]
    f = 4.0 * denom
    case0 = torch.stack([denom[:, 0], s01 / f[:, 0], s02 / f[:, 0],
                         a12 / f[:, 0]], -1)
    case1 = torch.stack([s01 / f[:, 1], denom[:, 1], s12 / f[:, 1],
                         a20 / f[:, 1]], -1)
    case2 = torch.stack([s02 / f[:, 2], s12 / f[:, 2], denom[:, 2],
                         a01 / f[:, 2]], -1)
    case3 = torch.stack([a12 / f[:, 3], a20 / f[:, 3], a01 / f[:, 3],
                         denom[:, 3]], -1)

    cases = torch.stack([case0, case1, case2, case3], 1)        # (B, 4, 4)
    sel = torch.argmax(denom.detach(), dim=-1)                  # (B,)
    q = torch.gather(cases, 1, sel[:, None, None].expand(-1, 1, 4))[:, 0]
    return q.reshape(batch_shape + (4,))


def quaternions_to_eazyz(q):
    """Quaternion -> ZYZ Euler angles (not reduced mod 2 pi)."""
    if q.shape[-1] != 4:
        raise ValueError(f"input must be (..., 4), got {tuple(q.shape)}")
    eps = 1e-6
    q0, q1, q2, q3 = q.unbind(-1)
    alpha = torch.atan2(q1 * q2 - q0 * q3, q0 * q2 + q1 * q3)
    beta = torch.acos(torch.clamp(q3 ** 2 - q0 ** 2 - q1 ** 2 + q2 ** 2,
                                  -1.0 + eps, 1.0 - eps))
    gamma = torch.atan2(q0 * q3 + q1 * q2, q1 * q3 - q0 * q2)
    return torch.stack([alpha, beta, gamma], -1)


def group_matrix_to_eazyz(r):
    """SO(3) matrix -> ZYZ Euler angles."""
    return quaternions_to_eazyz(group_matrix_to_quaternions(r))


def eazyz_to_group_matrix(angles):
    """ZYZ Euler angles -> SO(3) matrix, R = Rz(-g) Ry(-b) Rz(-a): the
    inverse of :func:`group_matrix_to_eazyz`."""
    if angles.shape[-1] != 3:
        raise ValueError(f"input must be (..., 3), got {tuple(angles.shape)}")
    al, be, ga = angles.unbind(-1)

    def _rz(t):
        c, s = torch.cos(t), torch.sin(t)
        z, o = torch.zeros_like(t), torch.ones_like(t)
        return torch.stack([torch.stack([c, -s, z], -1),
                            torch.stack([s, c, z], -1),
                            torch.stack([z, z, o], -1)], -2)

    def _ry(t):
        c, s = torch.cos(t), torch.sin(t)
        z, o = torch.zeros_like(t), torch.ones_like(t)
        return torch.stack([torch.stack([c, z, s], -1),
                            torch.stack([z, o, z], -1),
                            torch.stack([-s, z, c], -1)], -2)

    return _rz(-ga) @ _ry(-be) @ _rz(-al)


def quaternions_to_group_matrix(q):
    """Normalise q and map it to a rotation matrix (this layout's
    non-Hamilton sign convention, so round trips with
    :func:`group_matrix_to_quaternions` agree)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, i, j, k = q.unbind(-1)
    m = torch.stack([
        r * r - i * i - j * j + k * k, 2 * (r * i + j * k), 2 * (r * j - i * k),
        2 * (r * i - j * k), -r * r + i * i - j * j + k * k, 2 * (i * j + r * k),
        2 * (r * j + i * k), 2 * (i * j - r * k), -r * r - i * i + j * j + k * k,
    ], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def random_quaternions(n, generator=None, dtype=torch.float32, device="cuda"):
    """Haar-uniform quaternions (n, 4) on ``device`` by the subgroup
    algorithm. The uniforms are drawn from ``generator`` on its own device
    (a CPU generator gives the same poses on every device)."""
    gen_device = generator.device if generator is not None else device
    u = torch.rand((3, n), generator=generator, dtype=dtype,
                   device=gen_device).to(device)
    u1, u2, u3 = u[0], u[1], u[2]
    two_pi = 2.0 * math.pi
    return torch.stack((
        torch.sqrt(1.0 - u1) * torch.sin(two_pi * u2),
        torch.sqrt(1.0 - u1) * torch.cos(two_pi * u2),
        torch.sqrt(u1) * torch.sin(two_pi * u3),
        torch.sqrt(u1) * torch.cos(two_pi * u3),
    ), -1)


def random_group_matrices(n, generator=None, dtype=torch.float32,
                          device="cuda"):
    """Haar-uniform rotation matrices."""
    return quaternions_to_group_matrix(
        random_quaternions(n, generator, dtype, device))
