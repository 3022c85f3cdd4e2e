"""PLY mesh loader (ascii + binary_little_endian).

Port of cudatracerlib_tpu/io/ply.py, numpy only as there; the port keeps its own
copy so that it imports nothing of the JAX package.

Counterpart of reference ``Engine/MeshLoader/PlyParser.cpp`` (374 LoC).
Returns triangle-soup arrays for `build_scene`.
"""
from __future__ import annotations

import struct

import numpy as np

_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str):
    """Returns (vertices (T,3,3), normals (T,3,3) or None, uvs (T,3,2) or None)."""
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: missing PLY end_header")
    header = data[:header_end].decode("ascii", errors="ignore").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = "ascii"
    elements = []  # (name, count, [(type, propname) or ('list', ctype, itype, name)])
    cur = None
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            cur = (tok[1], int(tok[2]), [])
            elements.append(cur)
        elif tok[0] == "property" and cur is not None:
            if tok[1] == "list":
                cur[2].append(("list", tok[2], tok[3], tok[4]))
            else:
                cur[2].append((tok[1], tok[2]))

    verts = None
    vnorm = None
    vuv = None
    faces = []

    if fmt == "ascii":
        lines = body.decode("ascii", errors="ignore").split("\n")
        li = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                while li < len(lines) and not lines[li].strip():
                    li += 1
                rows.append(lines[li].strip().split())
                li += 1
            if name == "vertex":
                names = [p[-1] for p in props]
                arr = np.asarray([[float(x) for x in r[: len(names)]] for r in rows])
                verts, vnorm, vuv = _extract_vertex(arr, names)
            elif name == "face":
                for r in rows:
                    n = int(r[0])
                    idx = [int(x) for x in r[1 : 1 + n]]
                    for i in range(1, n - 1):
                        faces.append((idx[0], idx[i], idx[i + 1]))
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                fmt_str = "<" + "".join(_TYPES[p[0]][0] for p in props)
                size = struct.calcsize(fmt_str)
                arr = np.zeros((count, len(props)))
                for i in range(count):
                    arr[i] = struct.unpack_from(fmt_str, body, off)
                    off += size
                names = [p[-1] for p in props]
                verts, vnorm, vuv = _extract_vertex(arr, names)
            elif name == "face":
                for _ in range(count):
                    lp = props[0]
                    cfmt, csz = _TYPES[lp[1]]
                    ifmt, isz = _TYPES[lp[2]]
                    n = struct.unpack_from("<" + cfmt, body, off)[0]
                    off += csz
                    idx = struct.unpack_from("<" + ifmt * n, body, off)
                    off += isz * n
                    for i in range(1, n - 1):
                        faces.append((idx[0], idx[i], idx[i + 1]))
    else:
        raise ValueError(f"unsupported PLY format {fmt}")

    if verts is None or not faces:
        raise ValueError(f"{path}: no geometry")
    fi = np.asarray(faces, np.int64)
    tri_v = verts[fi].astype(np.float32)
    tri_n = vnorm[fi].astype(np.float32) if vnorm is not None else None
    tri_uv = vuv[fi].astype(np.float32) if vuv is not None else None
    return tri_v, tri_n, tri_uv


def _extract_vertex(arr, names):
    def col(n):
        return arr[:, names.index(n)] if n in names else None

    verts = np.stack([col("x"), col("y"), col("z")], axis=1)
    vnorm = None
    if all(n in names for n in ("nx", "ny", "nz")):
        vnorm = np.stack([col("nx"), col("ny"), col("nz")], axis=1)
    vuv = None
    for u_name, v_name in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if u_name in names and v_name in names:
            vuv = np.stack([col(u_name), col(v_name)], axis=1)
            break
    return verts, vnorm, vuv
