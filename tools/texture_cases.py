"""The host inputs (numpy only) of the texture and subsurface scenes that
chip_smoke.py phase 23, tools/texture_reference_mean.py,
tools/texture_grad_reference.py and the port's tests render; either
package's `build_scene` takes them (`build`).

  maps_case()   a Cornell-style box whose floor carries a seeded IMAGE albedo
                (trilinear through the ray cone, uv x 3), whose back wall
                carries a seeded height map with parallax occlusion, and with
                an alpha-tested quad in the middle (a seeded block mask,
                luminance >= 0.5 kept), lit by the Cornell area light;
  sss_case(sss_record)   tests/test_sss.py's scene: a sphere of measured
                Marble (scale 3) over a dark floor, lit from behind by an
                area light; `sss_record` is the caller's package's
                `material_lib.sss_record`.

Tag numbers are the packages' own: BSDF DIFFUSE 0, light AREA_LIGHT 3,
texture CONSTANT 0 and IMAGE 2, filter POINT 0.
"""
import numpy as np

DIFFUSE, AREA_LIGHT, CONSTANT, IMAGE, FILTER_POINT = 0, 3, 0, 2, 0
QUAD_UVS = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]], np.float32)
CORNELL_CAMERA = dict(origin=[0.0, -3.25, 1.0], target=[0.0, 1.0, 1.0], up=[0.0, 0.0, 1.0],
                      fov_deg=39.3077)


def quad(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3 (the packages' shapes.quad)."""
    p0, p1, p2, p3 = [np.asarray(p, np.float32) for p in (p0, p1, p2, p3)]
    return np.stack([np.stack([p0, p1, p2]), np.stack([p0, p2, p3])])


def sphere(center, radius, n_theta=16, n_phi=32):
    """The packages' shapes.sphere."""
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
                    [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], np.float32)

            a, b, c, d = pt(t0, p0), pt(t1, p0), pt(t1, p1), pt(t0, p1)
            vs.append(np.stack([a, b, c]))
            if i != 0 and i != n_theta - 1:
                vs.append(np.stack([a, c, d]))
    return np.stack(vs)


def _images(seed: int = 0):
    """The maps case's three seeded 64x64 images: a blocky albedo (16x16
    random colours), a smooth height field (four random sinusoids) and a
    block mask (8x8 random 0 / 1)."""
    rng = np.random.default_rng(seed)
    albedo = np.kron(rng.uniform(0.1, 0.9, (16, 16, 3)), np.ones((4, 4, 1)))
    yy, xx = np.meshgrid(np.linspace(0, 2 * np.pi, 64), np.linspace(0, 2 * np.pi, 64),
                         indexing="ij")
    h = np.zeros((64, 64))
    for fx, fy, ph in zip(rng.integers(1, 5, 4), rng.integers(1, 5, 4), rng.uniform(0, 6, 4)):
        h += np.sin(fx * xx + fy * yy + ph)
    h = (h - h.min()) / (h.max() - h.min())
    mask = np.kron((rng.random((8, 8)) < 0.6).astype(np.float64), np.ones((8, 8)))
    return [albedo.astype(np.float32), np.repeat(h[..., None], 3, -1).astype(np.float32),
            np.repeat(mask[..., None], 3, -1).astype(np.float32)]


def maps_case(light_radiance=(17.0, 12.0, 4.0)) -> dict:
    """The maps case (module note)."""
    parts = [
        (quad([-1, 0, 0], [1, 0, 0], [1, 2, 0], [-1, 2, 0]), 0),          # floor: image albedo
        (quad([-1, 0, 2], [-1, 2, 2], [1, 2, 2], [1, 0, 2]), 1),          # ceiling
        (quad([-1, 2, 0], [1, 2, 0], [1, 2, 2], [-1, 2, 2]), 5),          # back: height map
        (quad([-1, 0, 0], [-1, 2, 0], [-1, 2, 2], [-1, 0, 2]), 2),        # left red
        (quad([1, 0, 0], [1, 0, 2], [1, 2, 2], [1, 2, 0]), 3),            # right green
        (quad([-0.5, 1.0, 0.0], [0.5, 1.0, 0.0], [0.5, 1.0, 1.0], [-0.5, 1.0, 1.0]), 6),  # alpha
    ]
    light = quad([-0.25, 0.75, 1.999], [-0.25, 1.25, 1.999], [0.25, 1.25, 1.999],
                 [0.25, 0.75, 1.999])
    parts.append((light, 4))
    return dict(
        vertices=np.concatenate([t for t, _ in parts]),
        uvs=np.concatenate([QUAD_UVS] * len(parts)),
        mat_id=np.concatenate([np.full(len(t), m, np.int32) for t, m in parts]),
        textures=[
            {"type": IMAGE, "image_id": 0, "uv_xform": [3, 3, 0, 0]},
            {"type": CONSTANT, "color_a": [0.725, 0.71, 0.68]},
            {"type": CONSTANT, "color_a": [0.63, 0.065, 0.05]},
            {"type": CONSTANT, "color_a": [0.14, 0.45, 0.091]},
            {"type": CONSTANT, "color_a": [0, 0, 0]},
            {"type": IMAGE, "image_id": 1, "uv_xform": [2, 2, 0, 0]},
            {"type": IMAGE, "image_id": 2, "filter_mode": FILTER_POINT},
            {"type": CONSTANT, "color_a": [0.6, 0.6, 0.55]},
        ],
        images=_images(0),
        materials=[
            {"bsdf_type": DIFFUSE, "tex_albedo": 0},
            {"bsdf_type": DIFFUSE, "tex_albedo": 1},
            {"bsdf_type": DIFFUSE, "tex_albedo": 2},
            {"bsdf_type": DIFFUSE, "tex_albedo": 3},
            {"bsdf_type": DIFFUSE, "tex_albedo": 4,
             "emission": np.asarray(light_radiance, np.float32), "light_id": 0},
            {"bsdf_type": DIFFUSE, "tex_albedo": 7, "tex_height": 5, "height_scale": 0.04,
             "parallax": 1},
            {"bsdf_type": DIFFUSE, "tex_albedo": 1, "alpha_mode": 1, "tex_alpha": 6,
             "alpha_ref": 0.5},
        ],
        lights=[{"type": AREA_LIGHT, "radiance": list(light_radiance), "tris": light}],
        camera=CORNELL_CAMERA,
    )


def sss_case(sss_record) -> dict:
    """tests/test_sss.py's `_sss_scene(sss_record("Marble", scale=3.0))`."""
    parts = [(sphere([0.0, 0.0, 0.6], 0.55), 0),
             (quad([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]), 1)]   # floor
    light = quad([-0.7, 1.8, 0.1], [0.7, 1.8, 0.1], [0.7, 1.8, 1.3], [-0.7, 1.8, 1.3])
    parts.append((light, 2))
    return dict(
        vertices=np.concatenate([t for t, _ in parts]).astype(np.float32),
        uvs=None,
        mat_id=np.concatenate([np.full(len(t), m, np.int32) for t, m in parts]),
        textures=[{"type": CONSTANT, "color_a": [1.0, 1.0, 1.0]},
                  {"type": CONSTANT, "color_a": [0.05, 0.05, 0.05]},
                  {"type": CONSTANT, "color_a": [0, 0, 0]}],
        images=None,
        materials=[sss_record("Marble", scale=3.0),
                   {"bsdf_type": DIFFUSE, "tex_albedo": 1},
                   {"bsdf_type": DIFFUSE, "tex_albedo": 2, "emission": [40.0, 40.0, 40.0],
                    "light_id": 0}],
        lights=[{"type": AREA_LIGHT, "radiance": [40.0] * 3, "tris": light}],
        camera=dict(origin=[0.0, -3.2, 0.9], target=[0.0, 0.0, 0.6], up=[0, 0, 1],
                    fov_deg=35.0),
    )


def build(case: dict, build_scene, Materials, Textures, Camera, **kw):
    """A Scene from a case's inputs through a package's `build_scene` and
    classes (`kw`: the port's device)."""
    return build_scene(case["vertices"], None, case["uvs"], case["mat_id"],
                       Materials.build(case["materials"]),
                       Textures.build(case["textures"], images=case["images"]),
                       case["lights"], Camera.look_at(**case["camera"]), **kw)
