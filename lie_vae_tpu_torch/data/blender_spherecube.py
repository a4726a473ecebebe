"""Blender render script for the sphere-cube dataset (runs inside Blender's
bundled Python; Blender 2.8+ API).

A from-scratch equivalent of the reference's Blender pipeline
(blender_spherecube.py + the binary cube.blend asset): the scene is built
procedurally (no .blend needed) — a cube intersected with a sphere via a
boolean modifier, six per-face materials, a sun light, and a camera at
distance 5 tracking the origin. Each requested quaternion rotates the
object; one PNG per pose, named by the quaternion (the filename format the
dataset loaders parse, data/shapes.py).

A copy of the JAX package's ``data/blender_spherecube.py``, but that
``bpy`` and ``mathutils`` are imported where they are used, so that the
module imports outside Blender (its functions need Blender).

Invoke through the CLI:
  python -m lie_vae_tpu_torch.cli.gen_spherecube NUM DIR --blender
which passes a JSON spec file after '--':
  {"matrices": [[[...3x3...]] ...], "names": [...], "out_dir": ..., "size": 64}
(rotation matrices, row-major world-from-object — convention-unambiguous,
unlike quaternion component orderings)

No Blender binary is at hand to test with: the tests drive this script
under a stand-in ``bpy``; the native renderer (data/render.py) is the
generator's default backend.
"""
import json
import os
import sys

FACE_COLORS = [
    (0.85, 0.10, 0.10, 1.0), (0.10, 0.60, 0.85, 1.0),
    (0.10, 0.75, 0.20, 1.0), (0.85, 0.65, 0.10, 1.0),
    (0.80, 0.15, 0.75, 1.0), (0.95, 0.95, 0.95, 1.0),
]


def build_scene(size):
    import bpy  # only importable inside Blender

    bpy.ops.wm.read_factory_settings(use_empty=True)
    scene = bpy.context.scene
    scene.render.resolution_x = size
    scene.render.resolution_y = size
    scene.render.image_settings.file_format = "PNG"

    # object: cube boolean-intersected with a sphere
    bpy.ops.mesh.primitive_cube_add(size=2.0)
    cube = bpy.context.active_object
    for i, rgba in enumerate(FACE_COLORS):
        mat = bpy.data.materials.new(f"face{i}")
        mat.diffuse_color = rgba
        cube.data.materials.append(mat)
    for poly, mat_idx in zip(cube.data.polygons, range(6)):
        poly.material_index = mat_idx

    bpy.ops.mesh.primitive_uv_sphere_add(radius=1.15)
    sphere = bpy.context.active_object
    mod = cube.modifiers.new("spherecube", "BOOLEAN")
    mod.operation = "INTERSECT"
    mod.object = sphere
    sphere.hide_render = True

    # light + camera at (0, -5, 0) looking at the origin
    bpy.ops.object.light_add(type="SUN", location=(2, -3, 4))
    bpy.ops.object.camera_add(location=(0.0, -5.0, 0.0))
    cam = bpy.context.active_object
    scene.camera = cam
    track = cam.constraints.new(type="TRACK_TO")
    track.target = cube
    track.track_axis = "TRACK_NEGATIVE_Z"
    track.up_axis = "UP_Y"
    return cube


def main():
    argv = sys.argv[sys.argv.index("--") + 1:]
    with open(argv[0]) as f:
        spec = json.load(f)

    import bpy
    from mathutils import Matrix

    cube = build_scene(spec.get("size", 64))
    out_dir = spec["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    for m, name in zip(spec["matrices"], spec["names"]):
        cube.matrix_world = Matrix(m).to_4x4()
        bpy.context.scene.render.filepath = os.path.join(out_dir, name)
        bpy.ops.render.render(write_still=True)


if __name__ == "__main__":
    main()
