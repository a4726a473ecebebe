"""Software renderer for the sphere-cube object: the JAX package's
``data/render.py``, its numpy ray-caster copied and its native C++ backend
(``csrc/render_native.cpp``, built with ``g++`` into ``build/native/``)
beside it. A dependency-free stand-in for the reference's Blender
pipeline (blender_spherecube.py + cube.blend, invoked via subprocess at
gen_spherecube_pairs.py:30-32).

The reference renders a cube-with-sphere object rotated by pose quaternions
to 64x64 RGB images named by the quaternion. This renderer produces the same
*kind* of dataset (same geometry of the task: pose-identifiable rigid object
under SO(3)) with a vectorized numpy ray-caster, so the full image pipeline
runs in environments without Blender.

Scene: unit cube (six distinct face albedos) intersected with a sphere of
radius 1.15 * half-extent (the classic 'sphere-cube'), one directional
light + ambient, perspective camera at distance 5 on the +y axis looking at
the origin (matching the reference camera setup, blender_spherecube.py).

Styles:
- 'v1': the round-1 look (flat face colors, dim ambient). Kept verbatim for
  reproducibility of the r1/r2 datasets and results.
- 'v2': high-pose-contrast look — checker-textured faces with an in-plane
  brightness ramp (breaks the checker's 90-degree symmetry), banded sphere
  shading, brighter lighting, tighter framing. Motivated by the measured v1
  weakness (BENCHMARKS '32k renders' section): v1 images at independent
  random poses differ by only ~2x the mean-image SSE, so under the SSE
  pixel likelihood pose precision does not pay and the SO(3) posterior
  rationally drifts broad. Blender's cube.blend (the reference's data
  source) is texture-rich; v2 restores that property.
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


def render_spherecube(rotations, size=64, style="v1", backend="auto"):
    """Render the sphere-cube under one or more rotations.

    rotations: (N, 3, 3) or (3, 3) world-from-object rotation matrices.
    style: 'v1' (round-1 flat look) | 'v2' (high-pose-contrast textures).
    backend: 'auto' or 'native' (the C++ renderer) | 'numpy' (the plain
    ray-caster). Unlike the JAX package, whose 'auto' falls back to numpy
    when ``g++`` fails, 'auto' here is the native renderer and a failed
    build raises: a silent fallback would let a timed render measure the
    wrong renderer. Returns float32 images (N, size, size, 3) in [0, 1],
    as the JAX package's ``render_spherecube`` renders them with the same
    backend. The native renderer runs in float64 throughout, the numpy one
    partly in float32: they agree within 1e-4, and a few bytes of the
    ``(img * 255).astype(np.uint8)`` quantisation differ.
    """
    if style not in ("v1", "v2"):
        raise ValueError(f"unknown render style {style!r}")
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown render backend {backend!r}")
    if backend != "numpy":
        from lie_vae_tpu_torch.data import _native
        single = np.ndim(rotations) == 2
        out = _native.render(rotations, size, style)
        return out[0] if single else out
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
