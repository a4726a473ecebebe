"""Host-side numpy math for the data pipeline: a copy of the JAX package's
``data/_np_ops.py``, so that the port imports nothing of that package.

Same conventions as the port's ``ops`` (which are the reference's conventions:
quaternion layout of lie_vae/lie_tools.py:183-192, Haar sampling of
lie_tools.py:256-263).
"""
import numpy as np


def quaternions_to_group_matrix_np(q):
    """Normalise and map to rotation matrices; numpy mirror of
    ops.quaternions_to_group_matrix (used for filename pose labels, replacing
    the reference's lie_learn SO3_coordinates call at datasets.py:61-62 —
    equivalent per the reference's own test, lie_tools.py:294-310)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    r, i, j, k = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.stack([
        r * r - i * i - j * j + k * k, 2 * (r * i + j * k), 2 * (r * j - i * k),
        2 * (r * i - j * k), -r * r + i * i - j * j + k * k, 2 * (i * j + r * k),
        2 * (r * j + i * k), 2 * (i * j - r * k), -r * r - i * i + j * j + k * k,
    ], -1)
    return m.reshape(q.shape[:-1] + (3, 3)).astype(np.float32)


def random_quaternions_np(n, rng):
    """Haar-uniform quaternions (subgroup algorithm)."""
    u1, u2, u3 = rng.uniform(size=(3, n))
    two_pi = 2.0 * np.pi
    return np.stack((
        np.sqrt(1.0 - u1) * np.sin(two_pi * u2),
        np.sqrt(1.0 - u1) * np.cos(two_pi * u2),
        np.sqrt(u1) * np.sin(two_pi * u3),
        np.sqrt(u1) * np.cos(two_pi * u3),
    ), -1).astype(np.float32)


def expmap_np(v):
    """Rodrigues exponential R^3 -> SO(3); numpy mirror of ops.expmap
    (so3.py:68-87, same hat basis as lie_vae/lie_tools.py:17-43)."""
    v = np.asarray(v, dtype=np.float64)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = np.zeros_like(x)
    K = np.stack([
        np.stack([zero, -z, y], -1),
        np.stack([z, zero, -x], -1),
        np.stack([-y, x, zero], -1),
    ], -2)
    K2 = K @ K
    t2 = np.sum(v * v, axis=-1)[..., None, None]
    small = t2 < 1e-12
    t2s = np.where(small, 1.0, t2)
    ts = np.sqrt(t2s)
    a = np.where(small, 1.0 - t2 / 6.0, np.sin(ts) / ts)
    b = np.where(small, 0.5 - t2 / 24.0, (1.0 - np.cos(ts)) / t2s)
    return (np.eye(3) + a * K + b * K2).astype(np.float32)


def group_matrix_to_quaternions_np(r):
    """SO(3) matrix -> quaternion; numpy mirror of
    ops.group_matrix_to_quaternions (so3.py:183-233, the reference's
    4-case Shepperd selection, lie_vae/lie_tools.py:112-157)."""
    r = np.asarray(r, dtype=np.float64)
    batch_shape = r.shape[:-2]
    r = r.reshape((-1, 3, 3))
    d0, d1, d2 = r[:, 0, 0], r[:, 1, 1], r[:, 2, 2]
    denom_pre = np.stack([
        1.0 + d0 - d1 - d2,
        1.0 - d0 + d1 - d2,
        1.0 - d0 - d1 + d2,
        1.0 + d0 + d1 + d2,
    ], -1)
    denom = 0.5 * np.sqrt(1e-6 + np.abs(denom_pre))
    cases = np.stack([
        np.stack([denom[:, 0],
                  (r[:, 0, 1] + r[:, 1, 0]) / (4.0 * denom[:, 0]),
                  (r[:, 0, 2] + r[:, 2, 0]) / (4.0 * denom[:, 0]),
                  (r[:, 1, 2] - r[:, 2, 1]) / (4.0 * denom[:, 0])], -1),
        np.stack([(r[:, 0, 1] + r[:, 1, 0]) / (4.0 * denom[:, 1]),
                  denom[:, 1],
                  (r[:, 1, 2] + r[:, 2, 1]) / (4.0 * denom[:, 1]),
                  (r[:, 2, 0] - r[:, 0, 2]) / (4.0 * denom[:, 1])], -1),
        np.stack([(r[:, 0, 2] + r[:, 2, 0]) / (4.0 * denom[:, 2]),
                  (r[:, 1, 2] + r[:, 2, 1]) / (4.0 * denom[:, 2]),
                  denom[:, 2],
                  (r[:, 0, 1] - r[:, 1, 0]) / (4.0 * denom[:, 2])], -1),
        np.stack([(r[:, 1, 2] - r[:, 2, 1]) / (4.0 * denom[:, 3]),
                  (r[:, 2, 0] - r[:, 0, 2]) / (4.0 * denom[:, 3]),
                  (r[:, 0, 1] - r[:, 1, 0]) / (4.0 * denom[:, 3]),
                  denom[:, 3]], -1),
    ], 1)                                                   # (B, 4, 4)
    sel = np.argmax(denom, axis=-1)
    q = np.take_along_axis(cases, sel[:, None, None], axis=1)[:, 0]
    return q.reshape(batch_shape + (4,)).astype(np.float32)
