"""The files of chip_smoke.py phase 26 and of the port's loader tests, for
either package's Mitsuba loader (numpy and PIL only).

  media_maps_xml     a Mitsuba Cornell box (rectangles, an area light) with
                     a coating nested over a diffuse sphere, a PNG bump map
                     on a box, the sunsky emitter seen through the open
                     front, and a heterogeneous medium from a `.vol` grid
                     inside an index-matched dielectric box;
  write_media_maps   writes that XML, its bump map and its grid into a
                     directory from fixed seeds; returns the XML's path;
  write_big_scene    bench config 3's scene (`build_big_scene`'s triangles
                     and materials, given as numpy; its light and camera)
                     as binary PLY or `.serialized` files, one shape a
                     material, and a Mitsuba XML that references them with
                     the same BSDFs, area light and camera;
  PIN                the pinned size of phase 26 (c)'s renders, which
                     tools/io_reference_mean.py computes.
"""
from __future__ import annotations

import os
import struct

import numpy as np

PIN = dict(size=64, spp=4, seed=3, max_depth=5, vol_depth=6)

CORNELL_ROOM = """  <shape type="rectangle"><ref id="white"/></shape>
  <shape type="rectangle"><transform name="toWorld"><rotate x="1" angle="180"/>
    <translate z="2"/></transform><ref id="white"/></shape>
  <shape type="rectangle"><transform name="toWorld"><rotate x="1" angle="90"/>
    <translate y="1" z="1"/></transform><ref id="white"/></shape>
  <shape type="rectangle"><transform name="toWorld"><rotate y="1" angle="90"/>
    <translate x="-1" z="1"/></transform><ref id="red"/></shape>
  <shape type="rectangle"><transform name="toWorld"><rotate y="1" angle="-90"/>
    <translate x="1" z="1"/></transform><ref id="green"/></shape>
  <shape type="rectangle"><transform name="toWorld"><scale value="0.25"/>
    <rotate x="1" angle="180"/><translate z="1.98"/></transform>
    <emitter type="area"><rgb name="radiance" value="17 12 4"/></emitter></shape>
"""


def media_maps_xml() -> str:
    return f"""<?xml version="1.0"?>
<scene version="0.5.0">
  <sensor type="perspective"><float name="fov" value="40"/>
    <transform name="toWorld"><lookat origin="0,-3.6,1" target="0,0,1" up="0,0,1"/></transform>
  </sensor>
  <bsdf type="diffuse" id="white"><rgb name="reflectance" value="0.725 0.71 0.68"/></bsdf>
  <bsdf type="diffuse" id="red"><rgb name="reflectance" value="0.63 0.065 0.05"/></bsdf>
  <bsdf type="diffuse" id="green"><rgb name="reflectance" value="0.14 0.45 0.091"/></bsdf>
  <emitter type="sunsky"><float name="turbidity" value="3"/><float name="scale" value="0.05"/>
    <vector name="sunDirection" x="0.3" y="-0.6" z="0.75"/></emitter>
{CORNELL_ROOM}  <shape type="sphere"><point name="center" x="-0.45" y="0.25" z="0.35"/>
    <float name="radius" value="0.35"/>
    <bsdf type="coating"><float name="intIOR" value="1.5"/>
      <bsdf type="diffuse"><rgb name="reflectance" value="0.2 0.35 0.8"/></bsdf></bsdf></shape>
  <shape type="cube"><transform name="toWorld"><scale value="0.25"/>
    <translate x="0.45" y="0.3" z="0.25"/></transform>
    <bsdf type="bumpmap"><float name="scale" value="3.0"/>
      <texture type="bitmap"><string name="filename" value="bump.png"/></texture>
      <bsdf type="diffuse"><rgb name="reflectance" value="0.6 0.6 0.55"/></bsdf></bsdf></shape>
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    <translate x="0.05" y="-0.2" z="1.15"/></transform>
    <bsdf type="dielectric"><float name="intIOR" value="1.000277"/></bsdf>
    <medium type="heterogeneous" name="interior">
      <rgb name="sigmaS" value="3.0 3.0 3.0"/><rgb name="sigmaA" value="0.4 0.5 0.6"/>
      <phase type="hg"><float name="g" value="0.3"/></phase>
      <volume type="gridvolume" name="density"><string name="filename" value="density.vol"/></volume>
    </medium></shape>
</scene>
"""


def write_vol(path: str, grid: np.ndarray) -> None:
    """A Mitsuba `.vol` file (version 3, float32) of an (nx, ny, nz) grid."""
    nx, ny, nz = grid.shape
    with open(path, "wb") as f:
        f.write(b"VOL" + struct.pack("B", 3) + struct.pack("<i", 1))
        f.write(struct.pack("<3i", nx, ny, nz) + struct.pack("<i", 1))
        f.write(struct.pack("<6f", 0, 0, 0, 1, 1, 1))
        f.write(np.transpose(grid, (2, 1, 0)).astype("<f4").tobytes())


def write_media_maps(directory: str) -> str:
    from PIL import Image

    rng = np.random.default_rng(16)
    bump = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    Image.fromarray(bump).save(os.path.join(directory, "bump.png"))
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, 12),) * 3, indexing="ij")
    grid = np.clip(1.0 - np.sqrt(x * x + y * y + z * z), 0.0, 1.0) ** 0.5
    grid = (grid * (0.6 + 0.4 * rng.random(grid.shape))).astype(np.float32)
    write_vol(os.path.join(directory, "density.vol"), grid)
    path = os.path.join(directory, "media_maps.xml")
    with open(path, "w") as f:
        f.write(media_maps_xml())
    return path


# bench config 3's materials, light and camera (scene/bigscene.py of either package). The
# fields build_big_scene leaves at their defaults are written out too (the GGX distribution,
# the default conductor eta and k, tex_specular = texture 0, the conductor's tint), so that
# every material field the renderer reads equals build_big_scene's.
_BIG_DEFAULTS = ('<string name="distribution" value="ggx"/><rgb name="eta" value="0.2 0.92 1.1"/>'
                 '<rgb name="k" value="3.9 2.45 2.14"/>'
                 '<rgb name="specularReflectance" value="0.45 0.4 0.3"/>')
BIG_MATERIALS = (
    f'<bsdf type="diffuse" id="m0"><rgb name="reflectance" value="0.45 0.4 0.3"/>{_BIG_DEFAULTS}'
    '</bsdf>',
    f'<bsdf type="diffuse" id="m1"><rgb name="reflectance" value="0.6 0.55 0.5"/>{_BIG_DEFAULTS}'
    '</bsdf>',
    '<bsdf type="roughconductor" id="m2"><rgb name="reflectance" value="0.9 0.9 0.9"/>'
    f'<float name="alpha" value="0.15"/>{_BIG_DEFAULTS}</bsdf>',
)
# build_big_scene's two light triangles, wound down
BIG_LIGHT = np.asarray([[[-3, -3, 14], [3, 3, 14], [3, -3, 14]],
                        [[-3, -3, 14], [-3, 3, 14], [3, 3, 14]]], np.float32)
BIG_LIGHT_RADIANCE = "40 38 30"
BIG_CAMERA = '<lookat origin="0,-24,6" target="0,0,1" up="0,0,1"/>'
BIG_FOV = 55.0


def indexed(tris: np.ndarray):
    """(vertices (V, 3) float32, faces (T, 3) uint32) of a triangle soup,
    each distinct vertex once: `vertices[faces]` gives `tris` back bit for
    bit."""
    flat = np.ascontiguousarray(tris.reshape(-1, 3), np.float32)
    uniq, inv = np.unique(flat.view(np.dtype((np.void, 12))), return_inverse=True)
    return uniq.view(np.float32).reshape(-1, 3), inv.reshape(-1, 3).astype(np.uint32)


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian PLY of an indexed triangle mesh."""
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
              "end_header\n").encode()
    rec = np.empty(len(faces), dtype=[("n", "u1"), ("i", "<i4", 3)])
    rec["n"] = 3
    rec["i"] = faces
    with open(path, "wb") as f:
        f.write(header + np.asarray(verts, "<f4").tobytes() + rec.tobytes())


def write_big_scene(directory: str, tris: np.ndarray, mat_id: np.ndarray, save_serialized,
                    fmt: str) -> str:
    """Bench config 3's scene as files: the triangles of each material as
    one shape, binary PLY (`fmt` "ply") or `.serialized` ("serialized",
    written by the given `save_serialized`), each an indexed mesh whose
    faces give the triangles back bit for bit; the area light's two
    triangles as an emitting binary PLY (black, one-sided, wound down;
    PLY, not OBJ, so that its uvs are the loader's defaults); the
    camera; and a Mitsuba XML that references them. Returns the XML's
    path."""
    shapes = []
    for m in range(len(BIG_MATERIALS)):
        verts, faces = indexed(tris[mat_id == m])
        name = f"big_m{m}.{'ply' if fmt == 'ply' else 'serialized'}"
        if fmt == "ply":
            write_ply(os.path.join(directory, name), verts, faces)
        else:
            save_serialized(os.path.join(directory, name), [(verts, faces, None, None, f"m{m}")])
        shapes.append(f'  <shape type="{fmt}"><string name="filename" value="{name}"/>'
                      f'<ref id="m{m}"/></shape>')
    write_ply(os.path.join(directory, "big_light.ply"), *indexed(BIG_LIGHT))
    xml = "\n".join([
        '<?xml version="1.0"?>', '<scene version="0.5.0">',
        f'  <sensor type="perspective"><float name="fov" value="{BIG_FOV}"/>'
        f'<transform name="toWorld">{BIG_CAMERA}</transform></sensor>',
        *(f"  {b}" for b in BIG_MATERIALS), *shapes,
        '  <shape type="ply"><string name="filename" value="big_light.ply"/>'
        '<bsdf type="diffuse"><rgb name="reflectance" value="0 0 0"/></bsdf>'
        f'<emitter type="area"><rgb name="radiance" value="{BIG_LIGHT_RADIANCE}"/></emitter>'
        '</shape>', "</scene>", ""])
    path = os.path.join(directory, f"big_{fmt}.xml")
    with open(path, "w") as f:
        f.write(xml)
    return path
