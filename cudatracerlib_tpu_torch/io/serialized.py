"""Mitsuba `.serialized` mesh loader.

Port of cudatracerlib_tpu/io/serialized.py, numpy only as there; the port keeps its own
copy so that it imports nothing of the JAX package.

Counterpart of the reference's serialized-shape support
(Engine/SceneLoader/Mitsuba/ObjectParser.h:1104+ `serialized` plugin): the
Mitsuba 0.5 binary mesh container — per-mesh chunks tagged 0x041C, a version
uint16, and a zlib stream holding flags, (v4) name, vertex/triangle counts and
arrays. Chunks are located by scanning for the tag and decompressing with a
streaming inflater (robust to missing or corrupt offset tables).
"""
from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

MAGIC = 0x041C

F_NORMALS = 0x0001
F_TEXCOORDS = 0x0002
F_COLORS = 0x0008
F_FACE_NORMALS = 0x0010
F_SINGLE = 0x1000
F_DOUBLE = 0x2000


class SerializedMesh(NamedTuple):
    vertices: np.ndarray          # (T, 3, 3) triangle soup
    normals: Optional[np.ndarray]  # (T, 3, 3) or None
    uvs: Optional[np.ndarray]      # (T, 3, 2) or None
    name: str


def _parse_stream(data: bytes, version: int) -> SerializedMesh:
    off = 0
    (flags,) = struct.unpack_from("<I", data, off)
    off += 4
    name = ""
    if version >= 4:
        end = data.index(b"\x00", off)
        name = data[off:end].decode("utf-8", "replace")
        off = end + 1
    n_vert, n_tri = struct.unpack_from("<QQ", data, off)
    off += 16

    if flags & F_DOUBLE:
        dt, sz = "<f8", 8
    else:
        dt, sz = "<f4", 4

    def take(n):
        nonlocal off
        a = np.frombuffer(data, dt, count=n, offset=off).astype(np.float32)
        off += n * sz
        return a

    pos = take(n_vert * 3).reshape(n_vert, 3)
    nrm = take(n_vert * 3).reshape(n_vert, 3) if flags & F_NORMALS else None
    uv = take(n_vert * 2).reshape(n_vert, 2) if flags & F_TEXCOORDS else None
    if flags & F_COLORS:
        take(n_vert * 3)  # colors unused
    idx = np.frombuffer(data, "<u4", count=n_tri * 3, offset=off).astype(np.int64)
    tris = idx.reshape(n_tri, 3)
    return SerializedMesh(
        vertices=pos[tris],
        normals=nrm[tris] if nrm is not None else None,
        uvs=uv[tris] if uv is not None else None,
        name=name,
    )


def load_serialized(path: str, shape_index: int = 0) -> Optional[SerializedMesh]:
    """Load mesh #shape_index (the plugin's `shapeIndex` parameter)."""
    with open(path, "rb") as f:
        blob = f.read()
    found = 0
    pos = 0
    while pos < len(blob) - 4:
        tag = blob.find(struct.pack("<H", MAGIC), pos)
        if tag < 0:
            return None
        (version,) = struct.unpack_from("<H", blob, tag + 2)
        if version not in (3, 4):
            pos = tag + 2
            continue
        d = zlib.decompressobj()
        try:
            data = d.decompress(blob[tag + 4:])
        except zlib.error:
            pos = tag + 2
            continue
        if found == shape_index:
            try:
                return _parse_stream(data, version)
            except (struct.error, ValueError, IndexError):
                return None
        found += 1
        # continue after this chunk's compressed payload
        consumed = len(blob) - (tag + 4) - len(d.unused_data)
        pos = tag + 4 + max(consumed, 1)
    return None


def save_serialized(path: str, meshes: list) -> None:
    """Write a v4 .serialized file from [(verts (V,3), tris (T,3),
    normals|None, uvs|None, name)] — used by tests and as a compiled-mesh
    interchange format."""
    out = bytearray()
    for verts, tris, normals, uvs, name in meshes:
        flags = F_SINGLE
        body = bytearray()
        if normals is not None:
            flags |= F_NORMALS
        if uvs is not None:
            flags |= F_TEXCOORDS
        body += struct.pack("<I", flags)
        body += name.encode() + b"\x00"
        body += struct.pack("<QQ", len(verts), len(tris))
        body += np.asarray(verts, "<f4").tobytes()
        if normals is not None:
            body += np.asarray(normals, "<f4").tobytes()
        if uvs is not None:
            body += np.asarray(uvs, "<f4").tobytes()
        body += np.asarray(tris, "<u4").tobytes()
        out += struct.pack("<HH", MAGIC, 4)
        out += zlib.compress(bytes(body))
    with open(path, "wb") as f:
        f.write(bytes(out))
