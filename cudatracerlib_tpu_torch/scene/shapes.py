"""Procedural geometry, the Cornell box, the white furnace, the glossy scene
and the caustic scene (port of cudatracerlib_tpu/scene/shapes.py:18-141,
217-241, 244-374), and two scenes of the port's own for the nested BSDFs and
the delta lights: the furnace sphere under a coating or blend
(`nested_furnace`) and the Cornell box lit by a point and a spot light
(`cornell_point_spot`).

The geometry and the scene records are the JAX package's, built through the
port's `build_scene`. Every scene factory puts its tensors on `device`, the
card unless the caller asks for the CPU. The port's own scenes are also
given as host inputs (`*_inputs`: vertices, material ids, texture, material
and light records, the camera's look_at arguments), which either package's
`build_scene` takes (`build_inputs` is the port's).

The surface-shading cases that chip_smoke.py's phase 21, its pins
(tools/shading_reference_mean.py) and the port's tests render are defined
here once, as keywords either package's factories take: FURNACE_CASES,
NESTED_CASES with NESTED_KW, and CORNELL_CAMERAS.
"""
from __future__ import annotations

import numpy as np

from . import bsdf as B
from . import lights as L
from .scene import Materials, build_scene
from . import sensors as S
from .sensors import Camera
from .textures import Textures


def quad(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3 (counter-clockwise winding)."""
    p0, p1, p2, p3 = [np.asarray(p, np.float32) for p in (p0, p1, p2, p3)]
    return np.stack([np.stack([p0, p1, p2]), np.stack([p0, p2, p3])])


def box(lo, hi, flip=False):
    """12 triangles of an axis-aligned box; flip=True turns normals inward."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    faces = [
        quad([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0])[:, ::-1],  # floor (+z up)
        quad([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),            # ceiling
        quad([x0, y0, z0], [x0, y1, z0], [x0, y1, z1], [x0, y0, z1])[:, ::-1],
        quad([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]),
        quad([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),
        quad([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1])[:, ::-1],
    ]
    tris = np.concatenate(faces)
    if flip:
        tris = tris[:, ::-1]
    return tris


def sphere(center, radius, n_theta=16, n_phi=32):
    center = np.asarray(center, np.float32)
    vs = []
    for i in range(n_theta):
        t0 = np.pi * i / n_theta
        t1 = np.pi * (i + 1) / n_theta
        for j in range(n_phi):
            p0 = 2 * np.pi * j / n_phi
            p1 = 2 * np.pi * (j + 1) / n_phi

            def pt(t, p):
                return center + radius * np.array(
                    [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], np.float32
                )

            a, b, c, d = pt(t0, p0), pt(t1, p0), pt(t1, p1), pt(t0, p1)
            vs.append(np.stack([a, b, c]))
            if i != 0 and i != n_theta - 1:
                vs.append(np.stack([a, c, d]))
    return np.stack(vs)


def cornell_box(
    light_radiance=(17.0, 12.0, 4.0),
    white=(0.725, 0.71, 0.68),
    red=(0.63, 0.065, 0.05),
    green=(0.14, 0.45, 0.091),
    fov_deg: float = 39.3077,
    extra_objects: str = "boxes",
    device="cuda",
):
    """The canonical Cornell box (BASELINE config 1 scene).

    Coordinates: x right, y depth (camera looks +y), z up; box spans
    [-1,1]x[0,2]x[0,2]. Returns a fully built Scene.
    """
    tris = []
    mids = []

    def add(t, mid):
        tris.append(t)
        mids.extend([mid] * len(t))

    # 0 white, 1 red (left), 2 green (right), 3 light
    add(quad([-1, 0, 0], [1, 0, 0], [1, 2, 0], [-1, 2, 0]), 0)          # floor
    add(quad([-1, 0, 2], [-1, 2, 2], [1, 2, 2], [1, 0, 2]), 0)          # ceiling
    add(quad([-1, 2, 0], [1, 2, 0], [1, 2, 2], [-1, 2, 2]), 0)          # back wall
    add(quad([-1, 0, 0], [-1, 2, 0], [-1, 2, 2], [-1, 0, 2]), 1)        # left (red)
    add(quad([1, 0, 0], [1, 0, 2], [1, 2, 2], [1, 2, 0]), 2)            # right (green)

    if extra_objects == "boxes":
        add(box([-0.65, 0.9, 0.0], [-0.05, 1.5, 1.2]), 0)               # tall block
        add(box([0.1, 0.5, 0.0], [0.65, 1.05, 0.6]), 0)                 # short block
    elif extra_objects == "spheres":
        add(sphere([-0.4, 1.2, 0.45], 0.45), 4)
        add(sphere([0.45, 0.8, 0.3], 0.3), 5)

    # area light: small quad slightly below the ceiling
    light_tris = quad(
        [-0.25, 0.75, 1.999], [-0.25, 1.25, 1.999], [0.25, 1.25, 1.999], [0.25, 0.75, 1.999]
    )
    add(light_tris, 3)

    vertices = np.concatenate(tris)
    mat_id = np.asarray(mids, np.int32)

    textures = Textures.build(
        [
            {"type": 0, "color_a": white},
            {"type": 0, "color_a": red},
            {"type": 0, "color_a": green},
            {"type": 0, "color_a": [0, 0, 0]},
            {"type": 0, "color_a": [1, 1, 1]},
        ]
    )
    mat_records = [
        {"bsdf_type": B.DIFFUSE, "tex_albedo": 0},
        {"bsdf_type": B.DIFFUSE, "tex_albedo": 1},
        {"bsdf_type": B.DIFFUSE, "tex_albedo": 2},
        {"bsdf_type": B.DIFFUSE, "tex_albedo": 3,
         "emission": np.asarray(light_radiance, np.float32), "light_id": 0},
        {"bsdf_type": B.ROUGHCONDUCTOR, "tex_albedo": 4, "alpha_u": 0.08, "alpha_v": 0.08},
        {"bsdf_type": B.DIELECTRIC, "tex_albedo": 4, "eta": 1.5},
    ]
    materials = Materials.build(mat_records)

    light_records = [
        {"type": L.AREA_LIGHT, "radiance": light_radiance, "tris": light_tris}
    ]
    camera = Camera.look_at(
        origin=[0.0, -3.25, 1.0],
        target=[0.0, 1.0, 1.0],
        up=[0.0, 0.0, 1.0],
        fov_deg=fov_deg,
    )
    return build_scene(
        vertices, None, None, mat_id, materials, textures, light_records, camera,
        device=device,
    )


def furnace_scene(albedo=0.7, env_radiance=1.0, bsdf_type=B.DIFFUSE, specular=1.0,
                  device="cuda", **mat_kw):
    """White-furnace test scene: a sphere in a constant environment. For a
    lossless BSDF the render equals env_radiance everywhere; `specular`
    scales the specular texture separately. Extra keywords are material
    fields (alpha_u, eta, ...)."""
    tris = sphere([0, 0, 0], 1.0, n_theta=24, n_phi=48)
    mat_id = np.zeros(len(tris), np.int32)
    textures = Textures.build([
        {"type": 0, "color_a": [albedo] * 3},
        {"type": 0, "color_a": [specular] * 3},
    ])
    materials = Materials.build([
        {"bsdf_type": bsdf_type, "tex_albedo": 0, "tex_specular": 1,
         "tex_transmittance": 1, **mat_kw}
    ])
    light_records = [{"type": L.CONSTANT_ENV, "radiance": [env_radiance] * 3}]
    camera = Camera.look_at(origin=[0, -4, 0], target=[0, 0, 0], fov_deg=35.0)
    return build_scene(tris, None, None, mat_id, materials, textures, light_records, camera,
                       device=device)


def _sky_envmap(res_y: int = 64, sun_dir=(0.35, -0.45, 0.82),
                sun_radiance=120.0, sky_scale=0.6) -> np.ndarray:
    """Procedural HDR sky: a gradient plus a bright sun disk, as an
    (res_y, 2 res_y, 3) equirectangular map. The sharp sun is what makes the
    environment's 2-D CDF importance sampling matter."""
    res_x = 2 * res_y
    theta = (np.arange(res_y) + 0.5) / res_y * np.pi
    phi = (np.arange(res_x) + 0.5) / res_x * 2 * np.pi
    T, P = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)], -1)
    sd = np.asarray(sun_dir, np.float32)
    sd = sd / np.linalg.norm(sd)
    cos_sun = (d @ sd).clip(-1, 1)
    horizon = np.clip(d[..., 2], 0.0, 1.0)
    sky = np.stack([
        0.25 + 0.35 * (1 - horizon),
        0.38 + 0.25 * (1 - horizon),
        0.75 + 0.10 * horizon,
    ], -1) * sky_scale
    ground = np.array([0.18, 0.15, 0.12], np.float32) * sky_scale
    img = np.where((d[..., 2] > 0)[..., None], sky, ground[None, None])
    sun = (cos_sun > np.cos(np.radians(2.5))).astype(np.float32)
    img = img + sun[..., None] * np.array([1.0, 0.92, 0.80]) * sun_radiance
    return img.astype(np.float32)


def glossy_scene(alpha_cond=0.08, alpha_diel=0.12, device="cuda"):
    """Bench config 2: a rough-plastic checkerboard floor, a rough gold
    sphere, a rough glass sphere, a smooth copper box and a rough plastic
    sphere under an HDR sun/sky environment map (6,624 padded triangles,
    above the dense band). Returns a fully built Scene."""
    tris, mids = [], []

    def add(t, mid):
        tris.append(t)
        mids.extend([mid] * len(t))

    ext = 6.0
    add(quad([-ext, -ext, 0], [ext, -ext, 0], [ext, ext, 0], [-ext, ext, 0]), 0)
    add(sphere([-1.2, 0.3, 1.0], 1.0, n_theta=24, n_phi=48), 1)      # rough gold
    add(sphere([1.3, -0.6, 0.8], 0.8, n_theta=24, n_phi=48), 2)      # rough glass
    add(box([0.2, 1.2, 0.0], [1.8, 2.4, 1.4]), 3)                    # smooth copper
    add(sphere([-0.2, -1.9, 0.45], 0.45, n_theta=16, n_phi=32), 4)   # plastic

    vertices = np.concatenate(tris)
    mat_id = np.asarray(mids, np.int32)
    textures = Textures.build([
        {"type": 1, "color_a": [0.45, 0.45, 0.45],
         "color_b": [0.25, 0.25, 0.28], "uv_xform": [8, 8, 0, 0]},
        {"type": 0, "color_a": [1.0, 0.71, 0.29]},   # gold tint
        {"type": 0, "color_a": [1, 1, 1]},
        {"type": 0, "color_a": [0.95, 0.64, 0.54]},  # copper tint
        {"type": 0, "color_a": [0.15, 0.30, 0.65]},  # plastic kd
    ])
    materials = Materials.build([
        {"bsdf_type": B.ROUGHPLASTIC, "tex_albedo": 0, "tex_specular": 2,
         "eta": 1.49, "alpha_u": 0.25, "alpha_v": 0.25},
        {"bsdf_type": B.ROUGHCONDUCTOR, "tex_albedo": 1,
         "cond_eta": [0.143, 0.375, 1.44], "cond_k": [3.98, 2.39, 1.60],
         "alpha_u": alpha_cond, "alpha_v": alpha_cond},
        {"bsdf_type": B.ROUGHDIELECTRIC, "tex_albedo": 2, "tex_specular": 2,
         "tex_transmittance": 2, "eta": 1.5,
         "alpha_u": alpha_diel, "alpha_v": alpha_diel},
        {"bsdf_type": B.CONDUCTOR, "tex_albedo": 3,
         "cond_eta": [0.20, 0.92, 1.10], "cond_k": [3.90, 2.45, 2.14]},
        {"bsdf_type": B.ROUGHPLASTIC, "tex_albedo": 4, "tex_specular": 2,
         "eta": 1.49, "alpha_u": 0.08, "alpha_v": 0.08},
    ])
    light_records = [{"type": L.INFINITE, "radiance": [1.0, 1.0, 1.0]}]
    camera = Camera.look_at(
        origin=[0.3, -5.5, 2.2], target=[0.0, 0.0, 0.9], up=[0, 0, 1],
        fov_deg=42.0,
    )
    return build_scene(
        vertices, None, None, mat_id, materials, textures, light_records,
        camera, env_map=_sky_envmap(), device=device,
    )


def caustic_scene(light_radiance=(400.0, 380.0, 340.0), device="cuda"):
    """Bench config 5: a smooth dielectric sphere focusing a small bright
    area light onto the diffuse floor of a closed room (3,160 padded
    triangles, inside the dense band). Returns a fully built Scene."""
    tris, mids = [], []

    def add(t, mid):
        tris.append(t)
        mids.extend([mid] * len(t))

    # closed room so light doesn't escape (keeps photon passes efficient)
    add(quad([-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]), 0)     # floor
    add(quad([-2, -2, 3], [-2, 2, 3], [2, 2, 3], [2, -2, 3]), 1)     # ceiling
    add(quad([-2, 2, 0], [2, 2, 0], [2, 2, 3], [-2, 2, 3]), 1)       # back
    add(quad([-2, -2, 0], [-2, 2, 0], [-2, 2, 3], [-2, -2, 3]), 2)   # left
    add(quad([2, -2, 0], [2, -2, 3], [2, 2, 3], [2, 2, 0]), 3)       # right
    add(sphere([0.0, 0.3, 1.1], 0.55, n_theta=24, n_phi=48), 4)      # glass
    light_tris = quad([-0.12, 0.18, 2.799], [-0.12, 0.42, 2.799],
                      [0.12, 0.42, 2.799], [0.12, 0.18, 2.799])
    add(light_tris, 5)

    vertices = np.concatenate(tris)
    mat_id = np.asarray(mids, np.int32)
    textures = Textures.build([
        {"type": 0, "color_a": [0.68, 0.65, 0.60]},
        {"type": 0, "color_a": [0.55, 0.55, 0.55]},
        {"type": 0, "color_a": [0.60, 0.12, 0.10]},
        {"type": 0, "color_a": [0.12, 0.45, 0.14]},
        {"type": 0, "color_a": [1, 1, 1]},
        {"type": 0, "color_a": [0, 0, 0]},
    ])
    materials = Materials.build([
        {"bsdf_type": B.DIFFUSE, "tex_albedo": 0},
        {"bsdf_type": B.DIFFUSE, "tex_albedo": 1},
        {"bsdf_type": B.DIFFUSE, "tex_albedo": 2},
        {"bsdf_type": B.DIFFUSE, "tex_albedo": 3},
        {"bsdf_type": B.DIELECTRIC, "tex_albedo": 4, "tex_specular": 4,
         "tex_transmittance": 4, "eta": 1.5},
        {"bsdf_type": B.DIFFUSE, "tex_albedo": 5,
         "emission": np.asarray(light_radiance, np.float32), "light_id": 0},
    ])
    light_records = [
        {"type": L.AREA_LIGHT, "radiance": light_radiance, "tris": light_tris}
    ]
    camera = Camera.look_at(
        origin=[0.0, -5.2, 1.6], target=[0.0, 0.3, 0.9], up=[0, 0, 1],
        fov_deg=33.0,
    )
    return build_scene(
        vertices, None, None, mat_id, materials, textures, light_records, camera,
        device=device,
    )


def build_inputs(inputs: dict, device="cuda"):
    """A port Scene from host inputs (see the module note)."""
    return build_scene(inputs["vertices"], None, None, inputs["mat_id"],
                       Materials.build(inputs["materials"]), Textures.build(inputs["textures"]),
                       inputs["lights"], Camera.look_at(**inputs["camera"]), device=device)


def nested_furnace_inputs(outer=B.COATING, inner=B.DIFFUSE, albedo=0.8, **outer_kw) -> dict:
    """The furnace sphere (as `furnace_scene`) whose material is a nested
    BSDF `outer` (COATING, ROUGHCOATING or BLEND, its own fields from
    `outer_kw`) over the inner material `inner` (alpha 0.3). Textures: 0 the
    outer albedo, 1 white (both specular and transmittance), 2 the inner
    albedo, each `albedo` grey."""
    tris = sphere([0, 0, 0], 1.0, n_theta=24, n_phi=48)
    return dict(
        vertices=tris, mat_id=np.zeros(len(tris), np.int32),
        textures=[{"type": 0, "color_a": [albedo] * 3}, {"type": 0, "color_a": [1.0] * 3},
                  {"type": 0, "color_a": [albedo] * 3}],
        materials=[
            {"bsdf_type": outer, "tex_albedo": 0, "tex_specular": 1, "tex_transmittance": 1,
             "nested_id": 1, **outer_kw},
            {"bsdf_type": inner, "tex_albedo": 2, "tex_specular": 1, "tex_transmittance": 1,
             "alpha_u": 0.3, "alpha_v": 0.3},
        ],
        lights=[{"type": L.CONSTANT_ENV, "radiance": [1.0] * 3}],
        camera=dict(origin=[0, -4, 0], target=[0, 0, 0], fov_deg=35.0),
    )


def nested_furnace(outer=B.COATING, inner=B.DIFFUSE, albedo=0.8, device="cuda", **outer_kw):
    return build_inputs(nested_furnace_inputs(outer, inner, albedo, **outer_kw), device)


def cornell_point_spot_inputs(point=(2.0, 1.8, 1.5), spot=(10.0, 8.0, 6.0)) -> dict:
    """The Cornell box's walls and blocks (no area light) lit by a POINT
    light under the ceiling and a SPOT light in the front right corner
    aimed at the tall block (cone 30 degrees, full intensity within 20)."""
    tris = [quad([-1, 0, 0], [1, 0, 0], [1, 2, 0], [-1, 2, 0]),        # floor
            quad([-1, 0, 2], [-1, 2, 2], [1, 2, 2], [1, 0, 2]),        # ceiling
            quad([-1, 2, 0], [1, 2, 0], [1, 2, 2], [-1, 2, 2]),        # back wall
            quad([-1, 0, 0], [-1, 2, 0], [-1, 2, 2], [-1, 0, 2]),      # left (red)
            quad([1, 0, 0], [1, 0, 2], [1, 2, 2], [1, 2, 0]),          # right (green)
            box([-0.65, 0.9, 0.0], [-0.05, 1.5, 1.2]),                  # tall block
            box([0.1, 0.5, 0.0], [0.65, 1.05, 0.6])]                    # short block
    mids = [0, 0, 0, 1, 2, 0, 0]
    aim = np.array([-0.35, 1.2, 0.6]) - np.array([0.8, 0.2, 1.8])
    return dict(
        vertices=np.concatenate(tris),
        mat_id=np.concatenate([np.full(len(t), m, np.int32) for t, m in zip(tris, mids)]),
        textures=[{"type": 0, "color_a": (0.725, 0.71, 0.68)},
                  {"type": 0, "color_a": (0.63, 0.065, 0.05)},
                  {"type": 0, "color_a": (0.14, 0.45, 0.091)}],
        materials=[{"bsdf_type": B.DIFFUSE, "tex_albedo": i} for i in range(3)],
        lights=[{"type": L.POINT, "position": [0.0, 1.0, 1.8], "radiance": list(point)},
                {"type": L.SPOT, "position": [0.8, 0.2, 1.8], "direction": aim.tolist(),
                 "radiance": list(spot), "cos_width": float(np.cos(np.radians(30.0))),
                 "cos_falloff": float(np.cos(np.radians(20.0)))}],
        camera=dict(origin=[0.0, -3.25, 1.0], target=[0.0, 1.0, 1.0], up=[0.0, 0.0, 1.0],
                    fov_deg=39.3077),
    )


def cornell_point_spot(device="cuda"):
    return build_inputs(cornell_point_spot_inputs(), device)


# furnace_scene keywords of the white furnace with each closed-form BSDF
# (tests/test_render.py's test_energy_conservation cases, HK's and
# NULL_BSDF's default fields; PHONG and WARD at specular 0.2, kd + ks <= 1)
FURNACE_CASES = {
    "roughdiffuse": dict(albedo=0.8, bsdf_type=B.ROUGHDIFFUSE, alpha_u=0.3),
    "thindielectric": dict(albedo=0.8, bsdf_type=B.THINDIELECTRIC),
    "plastic": dict(albedo=0.8, bsdf_type=B.PLASTIC),
    "phong": dict(albedo=0.8, bsdf_type=B.PHONG, specular=0.2),
    "ward": dict(albedo=0.8, bsdf_type=B.WARD, alpha_u=0.3, alpha_v=0.3, specular=0.2),
    "hk": dict(albedo=0.8, bsdf_type=B.HK),
    "null": dict(albedo=0.8, bsdf_type=B.NULL_BSDF),
}
# nested_furnace(_inputs) outer types, over a DIFFUSE inner, with NESTED_KW
NESTED_CASES = {"coating": B.COATING, "roughcoating": B.ROUGHCOATING, "blend": B.BLEND}
NESTED_KW = dict(alpha_u=0.2, alpha_v=0.2, blend_weight=0.3)
# Camera.look_at keywords of the Cornell box through the other camera models
_CORNELL_VIEW = dict(origin=[0.0, -3.25, 1.0], target=[0.0, 1.0, 1.0], up=[0.0, 0.0, 1.0],
                     fov_deg=39.3077)
CORNELL_CAMERAS = {
    "thinlens": dict(_CORNELL_VIEW, ctype=S.THINLENS, aperture_radius=0.08, focal_distance=4.25),
    "orthographic": dict(_CORNELL_VIEW, ctype=S.ORTHOGRAPHIC, ortho_scale=1.2),
    "spherical": dict(_CORNELL_VIEW, ctype=S.SPHERICAL, origin=[0.0, 1.0, 1.0],
                      target=[0.0, 2.0, 1.0]),
    "telecentric": dict(_CORNELL_VIEW, ctype=S.TELECENTRIC, ortho_scale=1.2,
                        aperture_radius=0.05),
}
