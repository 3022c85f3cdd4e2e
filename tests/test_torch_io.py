"""Scene loading: the port's io/ (OBJ, PLY, `.serialized`, hair, MD5, the
Preetham sky, images and the Mitsuba XML loader) against the JAX package's,
both reading the same files written to `tmp_path` (the inputs of
tests/test_io.py, whose checks each case repeats on the port).

Tolerances, stated once:
  * numpy outputs of the two loaders are equal (array_equal; dicts and
    lists equal);
  * a Mitsuba scene's arrays equal JAX's field by field (`convert.flatten`
    of both; BVH nodes compared as bits, their child codes are bitcast
    ints), except the light-selection CDF within 1e-6 (a float32 sum over
    the sky map's power, rounded in another order) and JAX's `clusters`,
    the TPU kernel's layout, which the port does not build;
  * one 32x32 render per mesh format through a Mitsuba XML is held to
    JAX's as tests/test_torch_render.py holds renders (99% of pixels
    within 1e-3 relative, means within 0.5%); the nested-BSDF scene's 98%
    (NESTED_FRAC: its bump map differentiates a 16x16 noise image, whose
    float32 rounding moves 12 of the 1,024 pixels past 1e-3, with JAX's
    Woop decision in the port's place as with the watertight one);
  * `render_vol` of the media scene (interior medium with a `.vol` grid,
    a PNG bump map, a nested coating, the sunsky) within 0.5% of JAX's
    `render_vol` mean at the same seed (the random stream is JAX's lane for
    lane; a float32 decision that an ulp flips re-draws a lane).
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import os
import struct
import textwrap
import warnings

import sys

import numpy as np
import pytest
import torch

import test_io as jt
from cudatracerlib_tpu.io import hair as jhair
from cudatracerlib_tpu.io import md5 as jmd5
from cudatracerlib_tpu.io import mitsuba as jmi
from cudatracerlib_tpu.io import obj as jobj
from cudatracerlib_tpu.io import ply as jply
from cudatracerlib_tpu.io import serialized as jser
from cudatracerlib_tpu.io import sunsky as jsun
from cudatracerlib_tpu_torch import convert
from cudatracerlib_tpu_torch.io import hair as thair
from cudatracerlib_tpu_torch.io import image_io as timg
from cudatracerlib_tpu_torch.io import md5 as tmd5
from cudatracerlib_tpu_torch.io import mitsuba as tmi
from cudatracerlib_tpu_torch.io import obj as tobj
from cudatracerlib_tpu_torch.io import ply as tply
from cudatracerlib_tpu_torch.io import serialized as tser
from cudatracerlib_tpu_torch.io import sunsky as tsun
from cudatracerlib_tpu_torch.scene import bsdf as B
from cudatracerlib_tpu_torch.scene import phase as PH
from cudatracerlib_tpu_torch.scene import textures as T

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import io_cases  # noqa: E402  (tools/io_cases.py, numpy only)


NESTED_FRAC = 0.98


def _equal(a, b):
    """Equal numpy outputs, recursively through tuples, lists and dicts."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None or isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _assert_scene_arrays_equal(ts, js, cdf_atol=1e-6):
    fa, fb = convert.flatten(ts), convert.flatten(js)
    jax_only = {k for k in fb if k.startswith("clusters.")}
    assert set(fa) == set(fb) - jax_only, sorted(set(fa) ^ (set(fb) - jax_only))
    for k in fa:
        a, b = np.asarray(fa[k]), np.asarray(fb[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k.endswith("nodes"):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=k)
        elif k == "light_cdf":
            np.testing.assert_allclose(a, b, rtol=0, atol=cdf_atol, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _assert_images_close(port, ref, frac=0.99, rel=1e-3):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    ok = (np.abs(port - ref) <= rel * np.abs(ref) + 1e-6).all(-1)
    assert ok.mean() >= frac, f"only {ok.mean():.4f} of pixels within {rel}"
    assert abs(port.mean() - ref.mean()) <= 5e-3 * abs(ref.mean())


# ---------------------------------------------------------------- mesh files

OBJ_MTL = textwrap.dedent("""
    newmtl red
    Kd 0.8 0.1 0.1
    newmtl shiny
    Kd 0.1 0.1 0.1
    Ks 0.9 0.9 0.9
    Ns 100
    newmtl glass
    Kd 0.9 0.9 0.9
    d 0.5
    Ni 1.45
    newmtl lamp
    Kd 0.5 0.5 0.5
    Ke 4 4 3
""")
OBJ_TEXT = textwrap.dedent("""
    mtllib m.mtl
    v 0 0 0
    v 1 0 0
    v 1 1 0
    v 0 1 0
    v 0 0 1
    vn 0 0 1
    vt 0 0
    vt 1 0
    vt 1 1
    usemtl red
    f 1/1/1 2/2/1 3/3/1 4//1
    usemtl shiny
    f 1//1 3//1 4//1
    usemtl glass
    f -5 -4 -1
    usemtl lamp
    f 2 3 5
""")


def test_obj_load_and_materials(tmp_path):
    (tmp_path / "m.mtl").write_text(OBJ_MTL)
    (tmp_path / "t.obj").write_text(OBJ_TEXT)
    mesh = tobj.load_obj(str(tmp_path / "t.obj"), cache=False)
    ref = jobj.load_obj(str(tmp_path / "t.obj"), cache=False)
    _equal(tuple(mesh), tuple(ref))
    assert mesh.vertices.shape == (5, 3, 3) and len(mesh.materials) == 4
    out, out_j = tobj.obj_to_scene_arrays(mesh), jobj.obj_to_scene_arrays(ref)
    _equal(out, out_j)
    v, n, uv, mid, mats, texs = out
    assert {m["bsdf_type"] for m in mats} == {B.DIFFUSE, B.PHONG, B.DIELECTRIC}
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)


def test_obj_cache_roundtrip(tmp_path):
    """The compiled `.npz` cache: written by either package, read by both."""
    for k, (write, other) in enumerate(((tobj, jobj), (jobj, tobj))):
        p = tmp_path / f"c{k}.obj"
        p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3 4\n")
        m1 = write.load_obj(str(p), cache=True)
        assert os.path.exists(str(p) + ".compiled.npz")
        _equal(tuple(other.load_obj(str(p), cache=True)), tuple(m1))
        _equal(tuple(write.load_obj(str(p), cache=True)), tuple(m1))


PLY_ASCII = textwrap.dedent("""\
    ply
    format ascii 1.0
    element vertex 4
    property float x
    property float y
    property float z
    property float nx
    property float ny
    property float nz
    property float u
    property float v
    element face 2
    property list uchar int vertex_indices
    end_header
    0 0 0 0 0 1 0 0
    1 0 0 0 0 1 1 0
    1 1 0 0 0 1 1 1
    0 1 0 0 0 1 0 1
    3 0 1 2
    4 0 1 2 3
""")


def _ply_binary():
    header = textwrap.dedent("""\
        ply
        format binary_little_endian 1.0
        element vertex 3
        property float x
        property float y
        property float z
        element face 1
        property list uchar int vertex_indices
        end_header
    """).encode()
    body = b"".join(struct.pack("<fff", *p) for p in [(0, 0, 0), (1, 0, 0), (0, 1, 0)])
    return header + body + struct.pack("<Biii", 3, 0, 1, 2)


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_ply(tmp_path, fmt):
    p = tmp_path / f"{fmt}.ply"
    if fmt == "ascii":
        p.write_text(PLY_ASCII)
    else:
        p.write_bytes(_ply_binary())
    out, ref = tply.load_ply(str(p)), jply.load_ply(str(p))
    _equal(out, ref)
    v, n, uv = out
    assert v.shape == ((3, 3, 3) if fmt == "ascii" else (1, 3, 3))
    assert (n is None) == (fmt == "binary")
    np.testing.assert_allclose(v[0, 1], [1, 0, 0])


def test_serialized_roundtrip(tmp_path):
    """save_serialized / load_serialized (zlib streams, versions 3-4) across
    the two packages, both ways; JAX test_io's checks on the port's read."""
    rng = np.random.default_rng(0)
    v1 = rng.normal(size=(10, 3)).astype(np.float32)
    t1 = np.asarray([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.uint32)
    n1 = rng.normal(size=(10, 3)).astype(np.float32)
    uv1 = rng.uniform(size=(10, 2)).astype(np.float32)
    v2 = rng.normal(size=(6, 3)).astype(np.float32)
    t2 = np.asarray([[0, 1, 2], [3, 4, 5]], np.uint32)
    shapes = [(v1, t1, n1, uv1, "a"), (v2, t2, None, None, "b")]
    for writer in (tser, jser):
        p = str(tmp_path / f"{writer.__name__.split('.')[0]}.serialized")
        writer.save_serialized(p, shapes)
        for idx in (0, 1, 2):
            _equal(tser.load_serialized(p, idx), jser.load_serialized(p, idx))
        m0, m1 = tser.load_serialized(p, 0), tser.load_serialized(p, 1)
        assert m0.name == "a" and m1.name == "b" and m1.normals is None
        np.testing.assert_allclose(m0.vertices, v1[t1], atol=1e-6)
        np.testing.assert_allclose(m0.normals, n1[t1], atol=1e-6)
        np.testing.assert_allclose(m0.uvs, uv1[t1], atol=1e-6)
        np.testing.assert_allclose(m1.vertices, v2[t2], atol=1e-6)
        assert tser.load_serialized(p, 2) is None


def _hair_file(tmp_path, kind):
    p = tmp_path / f"{kind}.hair"
    if kind == "text":
        p.write_text("0 0 0\n0 0 1\n0 0 2\n\n1 0 0\n1 0 1\n")
    else:
        blob = b"BINARY_HAIR" + struct.pack("<I", 4)
        for t in [(0, 0, 0), (0, 0, 1), (float("inf"),), (1, 0, 0), (1, 0, 1)]:
            blob += struct.pack(f"<{len(t)}f", *t)
        p.write_bytes(blob)
    return str(p)


@pytest.mark.parametrize("kind,n_tris", [("text", 6), ("binary", 4)])
def test_hair(tmp_path, kind, n_tris):
    p = _hair_file(tmp_path, kind)
    tris = thair.load_hair(p, radius=0.01)
    _equal(tris, jhair.load_hair(p, radius=0.01))
    assert tris.shape == (n_tris, 3, 3) and np.isfinite(tris).all()
    np.testing.assert_allclose(np.linalg.norm(tris[0, 1] - tris[0, 0]), 0.02, rtol=1e-4)


def test_md5_mesh_anim_and_skinning(tmp_path):
    """The MD5 arrays equal JAX's, and fed to each package's animation layer
    (build_scene, make_skinned, animate_scene at frame 1) they pose the
    same vertices: the tip bends to +y as in JAX test_io."""
    from cudatracerlib_tpu.scene import animation as janim
    from cudatracerlib_tpu.scene import scene as jscene
    from cudatracerlib_tpu.scene.sensors import Camera as JCamera
    from cudatracerlib_tpu_torch.accel.bvh import build_bvh
    from cudatracerlib_tpu_torch.scene import animation as tanim
    from cudatracerlib_tpu_torch.scene import scene as tscene
    from cudatracerlib_tpu_torch.scene.sensors import Camera as TCamera

    (tmp_path / "beam.md5mesh").write_text(jt.MD5MESH)
    (tmp_path / "beam.md5anim").write_text(jt.MD5ANIM)
    mesh = tmd5.load_md5mesh(str(tmp_path / "beam.md5mesh"))
    anim = tmd5.load_md5anim(str(tmp_path / "beam.md5anim"))
    jmesh = jmd5.load_md5mesh(str(tmp_path / "beam.md5mesh"))
    _equal(tuple(mesh), tuple(jmesh))
    _equal(tuple(anim), tuple(jmd5.load_md5anim(str(tmp_path / "beam.md5anim"))))
    corners = tmd5.md5_corner_arrays(mesh)
    _equal(corners, jmd5.md5_corner_arrays(jmesh))
    np.testing.assert_allclose(mesh.verts[2], [2, 0.2, 0], atol=1e-6)
    np.testing.assert_allclose(anim.poses[1, 1, :3, :3] @ [1, 0, 0], [0, 1, 0], atol=1e-5)

    tris, uvs, bid, bw, mids = corners
    light = [{"type": 1, "position": [0.0, 0.0, 3.0], "radiance": [1.0, 1.0, 1.0]}]
    ts = tscene.build_scene(tris, None, uvs, mids, tscene.Materials.build([{}]),
                            T.Textures.build([{}]), light,
                            TCamera.look_at([0, -4, 1], [0, 0, 0]), device="cpu")
    js = jscene.build_scene(tris, None, uvs, mids, jscene.Materials.build([{}]),
                            __import__("cudatracerlib_tpu.scene.textures",
                                       fromlist=["Textures"]).Textures.build([{}]),
                            light, JCamera.look_at([0, -4, 1], [0, 0, 0]))
    _, host = build_bvh(tris, with_host=True, device="cpu")
    order = host["order"]
    _equal(order, np.asarray(js.bvh.tri_index))
    rig = (tmd5.leaf_order(bid, order), tmd5.leaf_order(bw, order), mesh.inv_bind)
    tmesh = tanim.make_skinned(ts, host["nodes"], host["root"], *rig)
    jskin = janim.make_skinned(js, host["nodes"], host["root"],
                               *(jmd5.leaf_order(x, order) for x in (bid, bw)), jmesh.inv_bind)
    posed = tanim.animate_scene(ts, tmesh, torch.from_numpy(anim.poses[1]))
    jposed = janim.animate_scene(js, jskin, anim.poses[1])
    got, ref = posed.shading.verts.numpy(), np.asarray(jposed.shading.verts)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    tip = order.tolist().index(1)     # triangle 1 (0, 2, 3): corner 2 is vertex 3
    np.testing.assert_allclose(got[tip, 2], [1, 1, 0], atol=1e-5)


def test_sunsky_and_images(tmp_path):
    sd = tsun.sun_direction_from_angles(30.0, 40.0)
    _equal(sd, jsun.sun_direction_from_angles(30.0, 40.0))
    for turb in (2.0, 4.0):
        _equal(tsun.preetham_sky(sd, turb, res=16, scale=1.5),
               jsun.preetham_sky(sd, turb, res=16, scale=1.5))
        _equal(tsun.sun_radiance(turb, 1.5), jsun.sun_radiance(turb, 1.5))
    img = torch.linspace(0, 1, 8 * 6 * 3).reshape(8, 6, 3)
    timg.write_png(str(tmp_path / "a.png"), img)
    from cudatracerlib_tpu.io import image_io as jimg

    jimg.write_png(str(tmp_path / "b.png"), img.numpy())
    import PIL.Image

    np.testing.assert_array_equal(np.asarray(PIL.Image.open(tmp_path / "a.png")),
                                  np.asarray(PIL.Image.open(tmp_path / "b.png")))
    timg.write_hdr_npz(str(tmp_path / "h.npz"), img, spp=torch.tensor(4))
    np.testing.assert_array_equal(timg.read_hdr_npz(str(tmp_path / "h.npz")), img.numpy())
    np.testing.assert_array_equal(jimg.read_hdr_npz(str(tmp_path / "h.npz")), img.numpy())


# ---------------------------------------------------------------- Mitsuba

def _vol_file(path, n=(6, 5, 4), channels=1):
    data = np.linspace(0.05, 1.0, int(np.prod(n)) * channels).astype("<f4")
    with open(path, "wb") as f:
        f.write(b"VOL" + struct.pack("B", 3) + struct.pack("<i", 1))
        f.write(struct.pack("<3i", *n) + struct.pack("<i", channels))
        f.write(struct.pack("<6f", 0, 0, 0, 1, 1, 1) + data.tobytes())


@pytest.mark.parametrize("channels", [1, 3])
def test_vol_grid(tmp_path, channels):
    """`_load_vol`: native resolution and a forced resample, equal to JAX's."""
    _vol_file(tmp_path / "d.vol", channels=channels)
    for res in (None, 8):
        got = tmi._load_vol(str(tmp_path / "d.vol"), res)
        _equal(got, jmi._load_vol(str(tmp_path / "d.vol"), res))
        assert got.shape[:3] == ((6, 5, 4) if res is None else (8, 8, 8))
        assert got.ndim == (3 if channels == 1 else 4)


def _load_both(path, **kw):
    ts, tm = tmi.load_mitsuba_full(str(path), device="cpu", **kw)
    js, jm = jmi.load_mitsuba_full(str(path), **kw)
    return ts, tm, js, jm


def test_mitsuba_parse_and_render(tmp_path):
    """JAX test_io's Mitsuba scene: equal arrays; the JAX test's checks on
    the port's scene and render; the render held to JAX's."""
    from cudatracerlib_tpu.render import path_tracer as jpt
    from cudatracerlib_tpu_torch.render import path_tracer as tpt

    (tmp_path / "scene.xml").write_text(jt.MITSUBA_XML)
    ts, tm, js, jm = _load_both(tmp_path / "scene.xml")
    assert tm is None and jm is None
    _assert_scene_arrays_equal(ts, js)
    assert ts.lights.ltype.shape[0] == 2
    types = set(ts.materials.bsdf_type.tolist())
    assert {B.DIFFUSE, B.ROUGHCONDUCTOR} <= types
    img = tpt.render(ts, 32, 32, 4, 0, tpt.PTConfig(max_depth=4))
    ref = jpt.render(js, 32, 32, 4, 0, jpt.PTConfig(max_depth=4))
    _assert_images_close(img, ref)
    c = img[13:19, 13:19].mean((0, 1))
    assert float(img.mean()) > 0.01 and c[0] > c[2]     # the gold-ish sphere


def test_mitsuba_nested_bsdfs_and_maps(tmp_path):
    """Coating, bumpmap (a PNG height map), mask and blendbsdf as JAX
    flattens them: equal arrays (the atlas included), a render held to
    JAX's."""
    import PIL.Image

    from cudatracerlib_tpu.render import path_tracer as jpt
    from cudatracerlib_tpu_torch.render import path_tracer as tpt

    bump = (np.random.default_rng(0).random((16, 16, 3)) * 255).astype(np.uint8)
    PIL.Image.fromarray(bump).save(tmp_path / "bump.png")
    src = open(jt.__file__).read()
    start = src.index('xml.write_text("""<scene version="0.5.0">\n  <sensor')
    xml = src[start + len('xml.write_text("""'):src.index('</scene>""")', start) + 8]
    (tmp_path / "nested.xml").write_text(xml)
    ts, _, js, _ = _load_both(tmp_path / "nested.xml")
    _assert_scene_arrays_equal(ts, js)
    m = ts.materials
    bt = m.bsdf_type.numpy()
    ci = int(np.nonzero(bt == B.COATING)[0][0])
    assert bt[int(m.nested_id[ci])] == B.DIFFUSE
    hi = np.nonzero(m.tex_height.numpy() >= 0)[0]
    assert float(m.height_scale[hi[0]]) == 2.0
    assert int(ts.textures.ttype[int(m.tex_height[hi[0]])]) == T.IMAGE
    bi = int(np.nonzero(bt == B.BLEND)[0][0])
    assert int(m.alpha_mode[bi]) == 1 and int(m.tex_alpha[bi]) >= 0
    assert bt[int(m.nested_id[bi])] == B.ROUGHCONDUCTOR
    img = tpt.render(ts, 32, 32, 4, 0, tpt.PTConfig(max_depth=4))
    _assert_images_close(img, jpt.render(js, 32, 32, 4, 0, jpt.PTConfig(max_depth=4)),
                         frac=NESTED_FRAC)


def test_mitsuba_unsupported_plugin_warns(tmp_path):
    (tmp_path / "warn.xml").write_text("""<scene version="0.5.0">
  <emitter type="constant"><spectrum name="radiance" value="1"/></emitter>
  <shape type="sphere">
    <float name="radius" value="1"/>
    <bsdf type="hanrahankrueger_nonexistent"/>
  </shape>
  <shape type="rectangle"><bsdf type="diffuse">
    <texture type="gradient_nonexistent" name="reflectance"/></bsdf></shape>
  <shape type="cube"><bsdf type="bumpmap"/></shape>
</scene>""")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tmi.load_mitsuba(str(tmp_path / "warn.xml"), device="cpu")
    msgs = [str(x.message) for x in w if "mitsuba loader" in str(x.message)]
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        jmi.load_mitsuba(str(tmp_path / "warn.xml"))
    assert msgs == [str(x.message) for x in wj if "mitsuba loader" in str(x.message)]
    assert sum("unsupported" in m for m in msgs) == 2 and len(msgs) >= 4


SENSOR_EMITTER_XML = """<scene version="0.5.0">
  <sensor type="{sensor}">
    <float name="fov" value="50"/><float name="apertureRadius" value="0.05"/>
    <float name="focusDistance" value="4"/>
    <transform name="toWorld"><lookat origin="0,-4,1" target="0,0,1" up="0,0,1"/></transform>
  </sensor>
  <emitter type="point"><point name="position" x="0" y="-1" z="2"/>
    <rgb name="intensity" value="3 3 3"/></emitter>
  <emitter type="spot"><float name="cutoffAngle" value="30"/><rgb name="intensity" value="5 5 5"/>
    <transform name="toWorld"><lookat origin="0,-2,3" target="0,0,0"/></transform></emitter>
  <emitter type="directional"><vector name="direction" x="0" y="0.3" z="-1"/>
    <rgb name="irradiance" value="0.5 0.5 0.5"/></emitter>
  <emitter type="sun"><vector name="direction" x="0.2" y="0.3" z="-1"/></emitter>
  <emitter type="{env}"><string name="filename" value="env.png"/>
    <float name="turbidity" value="3"/><rgb name="radiance" value="0.2 0.2 0.2"/></emitter>
  <shape type="disk"><bsdf type="roughplastic"><float name="alpha" value="0.2"/></bsdf></shape>
  <shape type="cylinder"><float name="radius" value="0.3"/>
    <bsdf type="dielectric"><string name="intIOR" value="water"/></bsdf></shape>
  <shape type="sphere"><point name="center" x="1" y="0" z="1"/><float name="radius" value="0.3"/>
    <bsdf type="conductor"><string name="material" value="ag"/></bsdf></shape>
</scene>"""


@pytest.mark.parametrize("sensor,env", [("perspective", "envmap"), ("thinlens", "sky"),
                                        ("orthographic", "constant"),
                                        ("spherical", "sunsky"), ("telecentric", "envmap")])
def test_mitsuba_sensors_and_emitters(tmp_path, sensor, env):
    """The five sensor types and the point, spot, directional, sun, sky,
    sunsky, constant and envmap emitters: equal arrays."""
    import PIL.Image

    env_img = (np.random.default_rng(1).random((8, 16, 3)) * 255).astype(np.uint8)
    PIL.Image.fromarray(env_img).save(tmp_path / "env.png")
    (tmp_path / "s.xml").write_text(SENSOR_EMITTER_XML.format(sensor=sensor, env=env))
    ts, _, js, _ = _load_both(tmp_path / "s.xml", aspect_hint=1.5)
    _assert_scene_arrays_equal(ts, js)
    assert ts.camera.ctype == ["perspective", "thinlens", "orthographic", "spherical",
                               "telecentric"].index(sensor)


def mesh_scene_xml(fmt):
    """tools/io_cases.py's Cornell room around a mesh file of format `fmt`
    (obj, ply, serialized, hair) with a rough conductor."""
    filename = {"obj": "m.obj", "ply": "m.ply", "serialized": "m.serialized",
                "hair": "m.hair"}[fmt]
    extra = '<float name="radius" value="0.05"/>' if fmt == "hair" else ""
    return f"""<scene version="0.5.0">
  <sensor type="perspective"><float name="fov" value="40"/>
    <transform name="toWorld"><lookat origin="0,-3.6,1" target="0,0,1" up="0,0,1"/></transform>
  </sensor>
  <bsdf type="diffuse" id="white"><rgb name="reflectance" value="0.725 0.71 0.68"/></bsdf>
  <bsdf type="diffuse" id="red"><rgb name="reflectance" value="0.63 0.065 0.05"/></bsdf>
  <bsdf type="diffuse" id="green"><rgb name="reflectance" value="0.14 0.45 0.091"/></bsdf>
{io_cases.CORNELL_ROOM}  <shape type="{fmt}"><string name="filename" value="{filename}"/>{extra}
    <transform name="toWorld"><scale value="0.8"/><translate x="-0.4" y="-0.2" z="0.0"/></transform>
    <bsdf type="roughconductor"><float name="alpha" value="0.3"/></bsdf></shape>
</scene>"""


def write_mesh_files(tmp_path):
    """The same small mesh (a tetrahedron with a square base) as OBJ, PLY,
    `.serialized` and a hair file."""
    v = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 0.9]], np.float32)
    f = np.asarray([[0, 2, 1], [0, 3, 2], [0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]], np.uint32)
    (tmp_path / "m.obj").write_text("".join(f"v {a} {b} {c}\n" for a, b, c in v)
                                    + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f))
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 5\nproperty float x\n"
              "property float y\nproperty float z\nelement face 6\n"
              "property list uchar int vertex_indices\nend_header\n").encode()
    body = v.astype("<f4").tobytes() + b"".join(struct.pack("<Biii", 3, *t) for t in f)
    (tmp_path / "m.ply").write_bytes(header + body)
    tser.save_serialized(str(tmp_path / "m.serialized"), [(v, f, None, None, "m")])
    (tmp_path / "m.hair").write_text("0 0 0\n0 0 0.5\n0.2 0 1\n\n0.6 0.5 0\n0.5 0.5 0.8\n")


@pytest.mark.parametrize("fmt", ["obj", "ply", "serialized", "hair"])
def test_mitsuba_mesh_formats_render(tmp_path, fmt):
    """One 32x32 render per mesh format, loaded through a Mitsuba XML by
    each package: equal arrays, the render held to JAX's."""
    from cudatracerlib_tpu.render import path_tracer as jpt
    from cudatracerlib_tpu_torch.render import path_tracer as tpt

    write_mesh_files(tmp_path)
    (tmp_path / "s.xml").write_text(mesh_scene_xml(fmt))
    ts, _, js, _ = _load_both(tmp_path / "s.xml")
    _assert_scene_arrays_equal(ts, js)
    img = tpt.render(ts, 32, 32, 4, 3, tpt.PTConfig(max_depth=4))
    _assert_images_close(img, jpt.render(js, 32, 32, 4, 3, jpt.PTConfig(max_depth=4)))
    assert float(img.mean()) > 0.01


def test_mitsuba_media_sunsky_instances(tmp_path):
    """JAX test_io's media scene: shapegroup / instances, a cylinder, the
    cube's interior HG medium and the sunsky: equal scene and media arrays;
    JAX test_io's checks on the port's."""
    (tmp_path / "scene.xml").write_text(jt.MITSUBA_MEDIA_XML)
    ts, tm, js, jm = _load_both(tmp_path / "scene.xml")
    _assert_scene_arrays_equal(ts, js)
    _equal(convert.flatten(tm), convert.flatten(jm))
    assert ts.lights.ltype.shape[0] == 2
    assert int(tm.active[0]) == 1 and int(tm.phase_type[0]) == PH.HG
    np.testing.assert_allclose(float(tm.phase_g[0]), 0.6)
    np.testing.assert_allclose(tm.box_min[0].numpy(), [-1, -1, 0], atol=1e-5)
    assert ts.bvh.woop.shape[0] >= 64 + 12


def test_mitsuba_media_maps_render_vol(tmp_path):
    """The media-and-maps scene of tools/io_cases.py (a nested coating, a
    PNG bump map, the sunsky, a heterogeneous `.vol` medium inside a shape):
    equal arrays; `render` and `render_vol` held to JAX's."""
    from cudatracerlib_tpu.render import path_tracer as jpt
    from cudatracerlib_tpu.render import volpath as jvp
    from cudatracerlib_tpu_torch.render import path_tracer as tpt
    from cudatracerlib_tpu_torch.render import volpath as tvp

    path = io_cases.write_media_maps(str(tmp_path))
    ts, tm, js, jm = _load_both(path)
    _assert_scene_arrays_equal(ts, js)
    _equal(convert.flatten(tm), convert.flatten(jm))
    p = io_cases.PIN
    img = tpt.render(ts, 32, 32, p["spp"], p["seed"], tpt.PTConfig(max_depth=p["max_depth"]))
    _assert_images_close(img, jpt.render(js, 32, 32, p["spp"], p["seed"],
                                         jpt.PTConfig(max_depth=p["max_depth"])))
    vol = tvp.render_vol(ts, tm, 32, 32, p["spp"], p["seed"],
                         tpt.PTConfig(max_depth=p["max_depth"]))
    ref = np.asarray(jvp.render_vol(js, jm, 32, 32, p["spp"], p["seed"],
                                    jpt.PTConfig(max_depth=p["max_depth"])))
    assert np.isfinite(vol.numpy()).all() and vol.shape == ref.shape
    assert abs(float(vol.mean()) - ref.mean()) <= 5e-3 * ref.mean()
