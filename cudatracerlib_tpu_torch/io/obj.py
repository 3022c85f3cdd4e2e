"""Wavefront OBJ loader (host side).

Port of cudatracerlib_tpu/io/obj.py, numpy only as there; the port keeps its own
copy so that it imports nothing of the JAX package.

Counterpart of reference ``Engine/MeshLoader/ObjParser.cpp`` (873 LoC OBJ
compiler). Produces triangle-soup arrays ready for `build_scene`; materials
from .mtl files map onto the SoA material table (diffuse/specular/dissolve ->
DIFFUSE/PLASTIC/DIELECTRIC heuristics, as the reference's MTL import does).
Compiled results are cached as npz (counterpart of the binary compiled-mesh
cache, Engine/MeshLoader/MeshCompiler.h:9-11).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class ObjMesh(NamedTuple):
    vertices: np.ndarray   # (T, 3, 3)
    normals: np.ndarray    # (T, 3, 3)
    uvs: np.ndarray        # (T, 3, 2)
    mat_names: list        # per-triangle material name
    materials: dict        # name -> {kd, ks, ke, ns, ni, d}


def _parse_mtl(path: str) -> dict:
    mats: dict = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="ignore") as f:
        for line in f:
            tok = line.strip().split()
            if not tok or tok[0].startswith("#"):
                continue
            k = tok[0].lower()
            if k == "newmtl":
                cur = tok[1]
                mats[cur] = {"kd": [0.7] * 3, "ks": [0.0] * 3, "ke": [0.0] * 3,
                             "ns": 30.0, "ni": 1.5, "d": 1.0, "map_kd": None}
            elif cur is None:
                continue
            elif k == "kd":
                mats[cur]["kd"] = [float(x) for x in tok[1:4]]
            elif k == "ks":
                mats[cur]["ks"] = [float(x) for x in tok[1:4]]
            elif k == "ke":
                mats[cur]["ke"] = [float(x) for x in tok[1:4]]
            elif k == "ns":
                mats[cur]["ns"] = float(tok[1])
            elif k == "ni":
                mats[cur]["ni"] = float(tok[1])
            elif k == "d":
                mats[cur]["d"] = float(tok[1])
            elif k == "map_kd":
                mats[cur]["map_kd"] = tok[-1]
    return mats


def load_obj(path: str, cache: bool = True) -> ObjMesh:
    """Parse an OBJ file into triangle soup (fan-triangulating polygons)."""
    cache_path = path + ".compiled.npz"
    if cache and os.path.exists(cache_path) and os.path.getmtime(cache_path) >= os.path.getmtime(path):
        z = np.load(cache_path, allow_pickle=True)
        return ObjMesh(
            vertices=z["vertices"], normals=z["normals"], uvs=z["uvs"],
            mat_names=list(z["mat_names"]), materials=z["materials"].item(),
        )

    vs: list = []
    vns: list = []
    vts: list = []
    faces: list = []       # list of ([(vi, ti, ni)], mat)
    materials: dict = {}
    cur_mat = ""

    base = os.path.dirname(path)
    with open(path, "r", errors="ignore") as f:
        for line in f:
            tok = line.strip().split()
            if not tok or tok[0].startswith("#"):
                continue
            k = tok[0]
            if k == "v":
                vs.append([float(x) for x in tok[1:4]])
            elif k == "vn":
                vns.append([float(x) for x in tok[1:4]])
            elif k == "vt":
                vts.append([float(x) for x in tok[1:3]])
            elif k == "f":
                idx = []
                for w in tok[1:]:
                    parts = (w.split("/") + ["", ""])[:3]
                    vi = int(parts[0])
                    ti = int(parts[1]) if parts[1] else 0
                    ni = int(parts[2]) if parts[2] else 0
                    idx.append((vi, ti, ni))
                for i in range(1, len(idx) - 1):
                    faces.append(([idx[0], idx[i], idx[i + 1]], cur_mat))
            elif k == "usemtl":
                cur_mat = tok[1] if len(tok) > 1 else ""
            elif k == "mtllib":
                materials.update(_parse_mtl(os.path.join(base, tok[1])))

    v_arr = np.asarray(vs, np.float32) if vs else np.zeros((0, 3), np.float32)
    n_arr = np.asarray(vns, np.float32) if vns else np.zeros((0, 3), np.float32)
    t_arr = np.asarray(vts, np.float32) if vts else np.zeros((0, 2), np.float32)

    def fix(i, n):
        return i - 1 if i > 0 else n + i

    T = len(faces)
    vertices = np.zeros((T, 3, 3), np.float32)
    normals = np.zeros((T, 3, 3), np.float32)
    uvs = np.zeros((T, 3, 2), np.float32)
    mat_names = []
    for t, (corners, mat) in enumerate(faces):
        mat_names.append(mat)
        for c, (vi, ti, ni) in enumerate(corners):
            vertices[t, c] = v_arr[fix(vi, len(v_arr))]
            if ni and len(n_arr):
                normals[t, c] = n_arr[fix(ni, len(n_arr))]
            if ti and len(t_arr):
                uvs[t, c] = t_arr[fix(ti, len(t_arr))]
    # fill missing normals with face normals
    face_n = np.cross(vertices[:, 1] - vertices[:, 0], vertices[:, 2] - vertices[:, 0])
    face_n = face_n / np.maximum(np.linalg.norm(face_n, axis=-1, keepdims=True), 1e-12)
    missing = np.linalg.norm(normals, axis=-1) < 1e-6
    normals[missing] = np.repeat(face_n[:, None, :], 3, axis=1)[missing]

    mesh = ObjMesh(vertices, normals, uvs, mat_names, materials)
    if cache:
        try:
            np.savez_compressed(
                cache_path, vertices=vertices, normals=normals, uvs=uvs,
                mat_names=np.asarray(mat_names, object), materials=np.asarray(materials, object),
            )
        except OSError:
            pass
    return mesh


def obj_to_scene_arrays(mesh: ObjMesh):
    """Map MTL materials onto the SoA material table. Returns
    (vertices, normals, uvs, mat_id, material_records, texture_records)."""
    from ..scene import bsdf as B

    names = sorted(set(mesh.mat_names))
    name_to_id = {n: i for i, n in enumerate(names)}
    mat_records = []
    tex_records = []
    for n in names:
        m = mesh.materials.get(n, {"kd": [0.7] * 3, "ks": [0] * 3, "ke": [0] * 3,
                                    "ns": 30.0, "ni": 1.5, "d": 1.0})
        tex_records.append({"type": 0, "color_a": m["kd"]})
        tid = len(tex_records) - 1
        ks_lum = sum(m["ks"]) / 3
        if m.get("d", 1.0) < 1.0:
            bt = B.DIELECTRIC
        elif ks_lum > 0.5 and sum(m["kd"]) / 3 < 0.1:
            bt = B.ROUGHCONDUCTOR
        elif ks_lum > 1e-3:
            bt = B.PHONG
        else:
            bt = B.DIFFUSE
        rec = {
            "bsdf_type": bt,
            "tex_albedo": tid,
            "eta": m.get("ni", 1.5),
            "exponent": m.get("ns", 30.0),
            "alpha_u": max(0.01, min(1.0, (2.0 / (2.0 + m.get("ns", 30.0))) ** 0.5)),
            "alpha_v": max(0.01, min(1.0, (2.0 / (2.0 + m.get("ns", 30.0))) ** 0.5)),
        }
        if sum(m.get("ke", [0, 0, 0])) > 0:
            rec["emission"] = np.asarray(m["ke"], np.float32)
        mat_records.append(rec)
    mat_id = np.asarray([name_to_id[n] for n in mesh.mat_names], np.int32)
    return mesh.vertices, mesh.normals, mesh.uvs, mat_id, mat_records, tex_records
