"""The dynamic and instanced scenes of chip_smoke.py phase 24, for either
package (numpy only; each function takes the package's classes).

  instanced   tests/test_instances.py's `_build(n)`: n rotated, scaled
              cubes, a floor and an emissive quad, three meshes;
  forest      tests/test_instances.py's 300-instance forest: one cube mesh
              at seeded placements and scales over a floor, under a
              constant sky;
  spheres     a BLAS above the dense band: `sphere(c, r, 64, 128)` (16,128
              triangles) instanced 16 times over a floor under an emissive
              quad (about 258k rows flattened);
  skinned     a sphere with radial vertex normals (not flat-shaded; its
              south-pole slivers left out) on a floor, rigged to two bones
              split by x: bone 0 holds the left
              half and the floor, bone 1 bends the right half about the
              y axis through the centre. `skinned_inputs(n_theta, n_phi)`
              gives `build_scene`'s inputs, `rig` the bone ids and weights
              in leaf order, `pose(k)` the k-th of POSES poses.

The pins of tools/dynamic_reference_mean.py and the card's runs in
chip_smoke.py build these scenes with the same arguments.
"""
from __future__ import annotations

import numpy as np

POSES = 8
CENTER = np.array([0.0, 0.0, 1.0])
RADIUS = 0.8
DIFFUSE = 0          # scene/bsdf.py's DIFFUSE tag (both packages)
CONSTANT_ENV, POINT = 5, 0


def translate(x, y, z, s=1.0):
    m = np.eye(4)
    m[:3, :3] *= s
    m[:3, 3] = [x, y, z]
    return m


def rot_z(deg):
    a = np.radians(deg)
    m = np.eye(4)
    m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    return m


def _diffuse(tex=0):
    return {"bsdf_type": DIFFUSE, "tex_albedo": tex}


def instanced(ds, shapes, Camera, n=8):
    """tests/test_instances.py `_build(n)` into the DynamicScene `ds`."""
    cube = ds.create_mesh(shapes.box([-0.3, -0.3, 0.0], [0.3, 0.3, 0.6]))
    floor = ds.create_mesh(shapes.quad([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]))
    lightq = ds.create_mesh(shapes.quad([-0.6, -0.6, 3.2], [-0.6, 0.6, 3.2], [0.6, 0.6, 3.2],
                                        [0.6, -0.6, 3.2]))
    for i in range(n):
        ds.create_node(cube, rot_z(360.0 * i / n) @ translate(1.2, 0.0, 0.0, s=0.7 + 0.15 * i),
                       _diffuse())
    ds.create_node(floor, np.eye(4), _diffuse())
    ln = ds.create_node(lightq, np.eye(4), _diffuse())
    ds.make_node_emissive(ln, [14.0, 13.0, 12.0])
    ds.set_camera(Camera.look_at([0, -5.5, 3.0], [0, 0, 0.4], up=[0, 0, 1], fov_deg=45.0))
    return ds


def forest(ds, shapes, Camera, n=300):
    """tests/test_instances.py's forest into `ds`; returns (ds, the
    generator after the placements, which the test's rays continue)."""
    cube = ds.create_mesh(shapes.box([-0.1, -0.1, 0.0], [0.1, 0.1, 0.3]))
    rng = np.random.default_rng(3)
    for _ in range(n):
        x, y = rng.uniform(-3, 3, 2)
        ds.create_node(cube, translate(x, y, 0.0, s=0.5 + rng.uniform(0, 1)), _diffuse())
    floor = ds.create_mesh(shapes.quad([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]))
    ds.create_node(floor, np.eye(4), _diffuse())
    ds.set_camera(Camera.look_at([0, -6, 4.0], [0, 0, 0.2], up=[0, 0, 1], fov_deg=50.0))
    # the test has no light (it only intersects); a constant sky lights the renders
    ds.create_light({"type": CONSTANT_ENV, "radiance": [1.0, 1.0, 1.0]})
    return ds, rng


def spheres(ds, shapes, Camera, n_side=4):
    """n_side^2 instances of one 16,128-triangle sphere over a floor."""
    ball = ds.create_mesh(shapes.sphere([0.0, 0.0, 0.0], 0.4, 64, 128))
    for i in range(n_side):
        for j in range(n_side):
            x, y = 1.1 * (i - (n_side - 1) / 2), 1.1 * (j - (n_side - 1) / 2)
            ds.create_node(ball, translate(x, y, 0.4 + 0.05 * ((i + j) % 3),
                                           s=0.8 + 0.1 * ((i * n_side + j) % 4)), _diffuse())
    floor = ds.create_mesh(shapes.quad([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]))
    ds.create_node(floor, np.eye(4), _diffuse())
    lightq = ds.create_mesh(shapes.quad([-0.8, -0.8, 4.0], [-0.8, 0.8, 4.0], [0.8, 0.8, 4.0],
                                        [0.8, -0.8, 4.0]))
    ln = ds.create_node(lightq, np.eye(4), _diffuse())
    ds.make_node_emissive(ln, [12.0, 12.0, 11.0])
    ds.set_camera(Camera.look_at([0, -6.0, 4.5], [0, 0, 0.3], up=[0, 0, 1], fov_deg=45.0))
    return ds


def skinned_inputs(shapes, n_theta: int, n_phi: int) -> dict:
    """`build_scene`'s inputs for the skinned sphere on its floor: vertices,
    radial vertex normals (the floor's face normals), material ids,
    material, texture and light records, and the camera's look_at."""
    ball = shapes.sphere(CENTER, RADIUS, n_theta, n_phi).astype(np.float32)
    # sphere()'s last ring meets the south pole in slivers of area ~1e-17:
    # left out, as JAX's gradient of their normals is NaN
    area = np.linalg.norm(np.cross(ball[:, 1] - ball[:, 0], ball[:, 2] - ball[:, 0]), axis=-1)
    ball = ball[area > 1e-8 * RADIUS ** 2]
    floor = shapes.quad([-3, -3, 0], [3, -3, 0], [3, 3, 0], [-3, 3, 0]).astype(np.float32)
    n_ball = ball - CENTER.astype(np.float32)
    n_ball /= np.linalg.norm(n_ball, axis=-1, keepdims=True)
    n_floor = np.broadcast_to(np.array([0, 0, 1], np.float32), floor.shape)
    return dict(
        vertices=np.concatenate([ball, floor]),
        normals=np.concatenate([n_ball, n_floor]).astype(np.float32),
        mat_id=np.concatenate([np.ones(len(ball), np.int32), np.zeros(len(floor), np.int32)]),
        materials=[_diffuse(0), _diffuse(1)],
        textures=[{"type": 0, "color_a": [0.75, 0.75, 0.72]},
                  {"type": 0, "color_a": [0.72, 0.35, 0.22]}],
        lights=[{"type": CONSTANT_ENV, "radiance": [0.25, 0.27, 0.3]},
                {"type": POINT, "position": [1.2, -1.6, 2.6], "radiance": [6.0, 5.8, 5.4]}],
        camera=dict(origin=[0.0, -4.0, 1.6], target=[0.0, 0.0, 0.9], up=[0, 0, 1],
                    fov_deg=40.0),
    )


def build_skinned(inputs: dict, build_scene, Materials, Textures, Camera, **kw):
    """The skinned case's Scene through a package's `build_scene` (`kw`:
    the port's device)."""
    return build_scene(inputs["vertices"], inputs["normals"], None, inputs["mat_id"],
                       Materials.build(inputs["materials"]), Textures.build(inputs["textures"]),
                       inputs["lights"], Camera.look_at(**inputs["camera"]), **kw)


def rig(leaf_verts: np.ndarray):
    """(bone_ids, weights, inv_bind) for leaf-ordered (T, 3, 3) vertices:
    bone 1's weight ramps from 0 to 1 across x in [-0.25 r, 0.25 r] of the
    sphere; the floor (z < 0.05) follows bone 0 alone."""
    v = np.asarray(leaf_verts, np.float64)
    w1 = np.clip((v[..., 0] - CENTER[0] + 0.25 * RADIUS) / (0.5 * RADIUS), 0.0, 1.0)
    w1 = w1 * w1 * (3 - 2 * w1)
    w1[v[..., 2] < 0.05] = 0.0
    bone_ids = np.zeros(v.shape[:2] + (4,), np.int32)
    bone_ids[..., 1] = 1
    weights = np.zeros(v.shape[:2] + (4,), np.float32)
    weights[..., 0] = 1.0 - w1
    weights[..., 1] = w1
    return bone_ids, weights, np.stack([np.eye(4)] * 2).astype(np.float32)


def pose(k: int) -> np.ndarray:
    """(2, 4, 4) float32: bone 0 at rest; bone 1 turned about the y axis
    through the centre by 30 sin(2 pi k / POSES) degrees and moved 0.05 k /
    POSES along +x."""
    a = np.radians(30.0 * np.sin(2 * np.pi * k / POSES))
    R = np.eye(4)
    R[[0, 0, 2, 2], [0, 2, 0, 2]] = [np.cos(a), np.sin(a), -np.sin(a), np.cos(a)]
    T = translate(*CENTER) @ R @ translate(*(-CENTER))
    T[0, 3] += 0.05 * k / POSES
    return np.stack([np.eye(4), T]).astype(np.float32)
