"""The sphere-cube scene and its numpy ray-caster: a frozen copy of
``lie_vae_tpu_torch/data/render.py`` at commit 81ffa68 (its numpy path; the
native backend left out), so that the benchmark's inputs do not move when
the program's renderer changes. ``PROVENANCE.md`` records the copy.

Scene: a unit cube (six face albedos) intersected with a sphere of radius
1.15, one directional light and ambient, a perspective camera at distance 5
on the -y axis looking at the origin.
"""
import numpy as np

# distinct face albedos (+x, -x, +y, -y, +z, -z)
_FACE_COLORS = np.array([
    [0.85, 0.10, 0.10],
    [0.10, 0.60, 0.85],
    [0.10, 0.75, 0.20],
    [0.85, 0.65, 0.10],
    [0.80, 0.15, 0.75],
    [0.95, 0.95, 0.95],
], dtype=np.float32)

_HALF = 1.0          # cube half-extent
_SPHERE_R = 1.15     # sphere radius (carves the cube edges/corners)
_CAM_DIST = 5.0
_FOV_SCALE = 0.45    # tan(half-fov)
_LIGHT = np.array([0.5, 0.7, 0.6], dtype=np.float32)
_LIGHT_DIR = _LIGHT / np.linalg.norm(_LIGHT)
_AMBIENT = 0.35


_FOV_SCALE_V2 = 0.33     # tighter framing: the object fills ~3/4 of frame
_AMBIENT_V2 = 0.50       # brighter fill light
# v1's light has +y (the camera looks along +y from (0,-5,0)), i.e. it sits
# BEHIND the object: camera-facing surfaces get ~zero Lambert and the whole
# render is dim. v2 lights from the camera side.
_LIGHT_V2 = np.array([0.4, -0.75, 0.55], dtype=np.float32)
_LIGHT_DIR_V2 = _LIGHT_V2 / np.linalg.norm(_LIGHT_V2)


def render_spherecube(rotations, size=64, style="v1"):
    """float32 images (N, size, size, 3) in [0, 1] of the sphere-cube under
    the (N, 3, 3) (or one (3, 3)) world-from-object rotations, by the
    numpy ray-caster; ``style`` 'v1' or 'v2'."""
    if style not in ("v1", "v2"):
        raise ValueError(f"unknown render style {style!r}")
    fov = _FOV_SCALE if style == "v1" else _FOV_SCALE_V2
    ambient = _AMBIENT if style == "v1" else _AMBIENT_V2

    R = np.asarray(rotations, dtype=np.float32)
    single = R.ndim == 2
    if single:
        R = R[None]
    n = R.shape[0]

    # camera at (0, -d, 0) looking along +y; image x -> world x, image y -> -z
    ys, xs = np.meshgrid(np.linspace(1, -1, size), np.linspace(-1, 1, size),
                         indexing="ij")
    dirs = np.stack([xs * fov, np.ones_like(xs), ys * fov],
                    axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)        # (H, W, 3)
    origin = np.array([0.0, -_CAM_DIST, 0.0], dtype=np.float32)

    # object frame: o = R^T (x - 0); rays per pose
    d_obj = np.einsum("nij,hwj->nhwi", np.swapaxes(R, -1, -2), dirs)
    o_obj = np.einsum("nij,j->ni", np.swapaxes(R, -1, -2), origin)
    o_obj = o_obj[:, None, None, :]                             # (N,1,1,3)

    t, normal, albedo = _intersect(o_obj, d_obj, style=style)

    hit = np.isfinite(t)
    # shade in object space: rotate light into object frame per pose
    light = _LIGHT_DIR if style == "v1" else _LIGHT_DIR_V2
    l_obj = np.einsum("nij,j->ni", np.swapaxes(R, -1, -2),
                      light)[:, None, None, :]
    lambert = np.clip(np.sum(normal * l_obj, axis=-1), 0.0, 1.0)
    shade = (ambient + (1.0 - ambient) * lambert)[..., None]
    img = np.where(hit[..., None], albedo * shade, 0.05)
    return (img[0] if single else img).astype(np.float32)


def _intersect(o, d, style="v1"):
    """Ray-intersect the cube-sphere CSG intersection.

    o: (N,1,1,3) origins, d: (N,H,W,3) unit dirs (object frame).
    Returns (t, normal, albedo), each (N,H,W[,3]); t=inf on miss.
    """
    eps = 1e-9
    inv = 1.0 / np.where(np.abs(d) < eps, np.copysign(eps, d), d)

    # slab test for the cube
    t1 = (-_HALF - o) * inv
    t2 = (_HALF - o) * inv
    tmin_ax = np.minimum(t1, t2)
    tmax_ax = np.maximum(t1, t2)
    t_in_cube = tmin_ax.max(-1)
    t_out_cube = tmax_ax.min(-1)

    # sphere intersection
    b = np.sum(o * d, axis=-1)
    c = np.sum(o * o, axis=-1) - _SPHERE_R ** 2
    disc = b * b - c
    sq = np.sqrt(np.maximum(disc, 0.0))
    t_in_sph = -b - sq
    t_out_sph = -b + sq
    sph_ok = disc > 0

    # CSG intersection: enter at max of entries, exit at min of exits
    t_enter = np.maximum(t_in_cube, t_in_sph)
    t_exit = np.minimum(t_out_cube, t_out_sph)
    hit = sph_ok & (t_enter < t_exit) & (t_exit > 0) & (t_enter > 0)
    t = np.where(hit, t_enter, np.inf)

    # which surface bounds the entry? cube face or sphere
    cube_bounds = (t_in_cube >= t_in_sph)
    t_safe = np.where(np.isfinite(t), t, 1.0)
    p = o + t_safe[..., None] * d                              # hit points

    # cube normal/albedo: the axis whose slab we entered last
    face_axis = np.argmax(tmin_ax, axis=-1)                    # (N,H,W)
    sign = np.take_along_axis(np.sign(d), face_axis[..., None],
                              axis=-1)[..., 0]
    n_cube = -np.sign(sign)[..., None] * np.eye(
        3, dtype=np.float32)[face_axis]
    face_idx = face_axis * 2 + (n_cube.sum(-1) < 0)            # +ax=0, -ax=1
    a_cube = _FACE_COLORS[face_idx.astype(np.int32)]

    # sphere normal/albedo (position-tinted to make pose identifiable)
    n_sph = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    a_sph = 0.5 + 0.45 * n_sph

    if style == "v2":
        # face texture: 4x4 checker of face color vs near-white, under an
        # in-plane brightness ramp that breaks the checker's 90-degree
        # rotational symmetry (each face's in-plane orientation becomes
        # identifiable, like a textured cube.blend face)
        uv_axes = np.stack([np.where(face_axis == 0, 1, 0),
                            np.where(face_axis == 2, 1, 2)], axis=-1)
        u = np.take_along_axis(p, uv_axes[..., :1], axis=-1)[..., 0]
        v = np.take_along_axis(p, uv_axes[..., 1:], axis=-1)[..., 0]
        checker = (np.floor((u + 1.0) * 2.0).astype(np.int32)
                   + np.floor((v + 1.0) * 2.0).astype(np.int32)) % 2
        white = np.float32(0.95)
        a_cube = np.where(checker[..., None] > 0, a_cube, white)
        ramp = (0.55 + 0.45 * (u + 1.0) * 0.5
                )[..., None].astype(np.float32)
        a_cube = a_cube * ramp
        # sphere: longitude banding adds high-frequency angular detail on
        # the carved edge/corner regions
        band = 0.5 + 0.5 * np.sin(
            7.0 * np.arctan2(n_sph[..., 1], n_sph[..., 0])
            + 9.0 * n_sph[..., 2])
        a_sph = a_sph * (0.45 + 0.55 * band[..., None])

    normal = np.where(cube_bounds[..., None], n_cube, n_sph)
    albedo = np.where(cube_bounds[..., None], a_cube,
                      a_sph).astype(np.float32)
    return t, normal.astype(np.float32), albedo


# ---------------------------------------------------------------- poses
# Frozen copies of ``lie_vae_tpu_torch/data/_np_ops.py``'s
# ``random_quaternions_np``, ``quaternions_to_group_matrix_np`` and
# ``expmap_np``, and of ``cli/gen_spherecube.py``'s pair step (81ffa68).

PAIR_STEP = 2 * np.pi / 60      # std of a pair's algebra perturbation


def random_quaternions(n, rng):
    """Haar-uniform quaternions (n, 4) by the subgroup algorithm."""
    u1, u2, u3 = rng.uniform(size=(3, n))
    two_pi = 2.0 * np.pi
    return np.stack((
        np.sqrt(1.0 - u1) * np.sin(two_pi * u2),
        np.sqrt(1.0 - u1) * np.cos(two_pi * u2),
        np.sqrt(u1) * np.sin(two_pi * u3),
        np.sqrt(u1) * np.cos(two_pi * u3),
    ), -1).astype(np.float32)


def quaternions_to_group_matrix(q):
    """Normalised quaternions to rotation matrices, in the layout of the
    reference's ``lie_tools``."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    r, i, j, k = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.stack([
        r * r - i * i - j * j + k * k, 2 * (r * i + j * k), 2 * (r * j - i * k),
        2 * (r * i - j * k), -r * r + i * i - j * j + k * k, 2 * (i * j + r * k),
        2 * (r * j + i * k), 2 * (i * j - r * k), -r * r - i * i + j * j + k * k,
    ], -1)
    return m.reshape(q.shape[:-1] + (3, 3)).astype(np.float32)


def expmap(v):
    """Rodrigues exponential R^3 -> SO(3)."""
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


def sample_poses(num, per_item, rng):
    """(num, per_item, 3, 3) poses: Haar-random, and with ``per_item`` 2
    each followed by its consecutive pose a @ exp(N(0, PAIR_STEP))."""
    a = quaternions_to_group_matrix(random_quaternions(num, rng))
    if per_item == 1:
        return a[:, None]
    if per_item != 2:
        raise ValueError(f"items of 1 or 2 poses, not {per_item}")
    d = expmap(rng.normal(size=(num, 3)) * PAIR_STEP)
    return np.stack([a, a @ d], 1)


def render_uint8(rotations, size=64, style="v1"):
    """uint8 renders (N, size, size, 3), quantised as the dataset
    generator writes them."""
    return (render_spherecube(rotations, size, style) * 255).astype(np.uint8)


def render_chunk(args):
    """``render_uint8`` of a (rotations, size, style) tuple: a render
    worker's task."""
    rotations, size, style = args
    return render_uint8(rotations, size, style)
