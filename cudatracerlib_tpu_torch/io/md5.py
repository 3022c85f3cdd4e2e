"""MD5 skeletal mesh/animation loader (Doom-3 text format).

Port of cudatracerlib_tpu/io/md5.py, numpy only as there; the port keeps its own
copy so that it imports nothing of the JAX package.

Counterpart of reference ``Engine/MeshLoader/MD5Parser.cpp`` (858 LoC) +
``md5Compiler.cpp``: parses ``.md5mesh`` (joints, per-vertex weight spans) and
``.md5anim`` (hierarchy, baseframe, per-frame component streams), and converts
the MD5 weight formulation into the matrix-palette linear-blend skinning the
animation layer consumes (scene/animation.py SkinnedMesh) — the same
conversion the reference's md5Compiler performs for its GPU skinning kernel
(AnimatedMesh.h:10-20 bone-weighted vertices, per-frame matrix palettes).

MD5 stores per-weight positions in joint-local space; LBS wants one bind-pose
vertex + inverse bind matrices. At bind pose both agree by construction:
v_bind = sum_w bias_w * T_bind[j_w] * pos_w, and skinning applies
pose @ inv_bind to v_bind.
"""
from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np

MAX_WEIGHTS = 4  # matches scene/animation.py MAX_WEIGHTS


class MD5Mesh(NamedTuple):
    verts: np.ndarray       # (V, 3) bind-pose positions
    uvs: np.ndarray         # (V, 2)
    tris: np.ndarray        # (T, 3) int32 vertex indices
    bone_ids: np.ndarray    # (V, MAX_WEIGHTS) int32
    weights: np.ndarray     # (V, MAX_WEIGHTS) float32 (renormalized top-4)
    inv_bind: np.ndarray    # (J, 4, 4) inverse bind matrices
    joint_names: list
    joint_parents: np.ndarray  # (J,) int32
    shaders: list           # per sub-mesh shader strings
    mesh_of_tri: np.ndarray  # (T,) int32 sub-mesh index per triangle


class MD5Anim(NamedTuple):
    poses: np.ndarray       # (F, J, 4, 4) world joint transforms per frame
    frame_rate: float
    joint_names: list


_NUM = r"[-+0-9.eE]+"


def _quat_mat(q, t):
    """MD5 quaternion (x, y, z; w = -sqrt(1-|q|^2)) + translation -> 4x4."""
    x, y, z = q
    w2 = 1.0 - (x * x + y * y + z * z)
    w = -np.sqrt(max(w2, 0.0))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    m[:3, 3] = t
    return m


def _strip_comments(text: str) -> str:
    return re.sub(r"//[^\n]*", "", text)


def load_md5mesh(path: str) -> MD5Mesh:
    with open(path) as f:
        text = _strip_comments(f.read())

    # ---- joints ----
    jm = re.search(r"joints\s*\{(.*?)\}", text, re.S)
    joints = []       # (name, parent, world 4x4)
    names, parents = [], []
    for line in jm.group(1).strip().splitlines():
        m = re.match(
            rf'\s*"([^"]*)"\s+(-?\d+)\s*\(\s*({_NUM})\s+({_NUM})\s+({_NUM})\s*\)'
            rf'\s*\(\s*({_NUM})\s+({_NUM})\s+({_NUM})\s*\)', line)
        if not m:
            continue
        name, parent = m.group(1), int(m.group(2))
        t = [float(m.group(i)) for i in (3, 4, 5)]
        q = [float(m.group(i)) for i in (6, 7, 8)]
        names.append(name)
        parents.append(parent)
        joints.append(_quat_mat(q, t))  # MD5 joints are stored in WORLD space
    bind = np.stack(joints)             # (J, 4, 4)
    inv_bind = np.linalg.inv(bind).astype(np.float32)

    # ---- meshes ----
    all_v, all_uv, all_tri, all_bid, all_bw = [], [], [], [], []
    shaders, mesh_of_tri = [], []
    v_off = 0
    for mi, mm in enumerate(re.finditer(r"mesh\s*\{(.*?)\n\}", text, re.S)):
        body = mm.group(1)
        sh = re.search(r'shader\s+"([^"]*)"', body)
        shaders.append(sh.group(1) if sh else "")
        verts = {}
        for vm in re.finditer(
                rf"vert\s+(\d+)\s*\(\s*({_NUM})\s+({_NUM})\s*\)\s+(\d+)\s+(\d+)",
                body):
            verts[int(vm.group(1))] = (
                float(vm.group(2)), float(vm.group(3)),
                int(vm.group(4)), int(vm.group(5)),
            )
        tris = []
        for tm in re.finditer(r"tri\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)", body):
            tris.append((int(tm.group(2)), int(tm.group(3)), int(tm.group(4))))
        wlist = {}
        for wm in re.finditer(
                rf"weight\s+(\d+)\s+(\d+)\s+({_NUM})\s*"
                rf"\(\s*({_NUM})\s+({_NUM})\s+({_NUM})\s*\)", body):
            wlist[int(wm.group(1))] = (
                int(wm.group(2)), float(wm.group(3)),
                np.array([float(wm.group(i)) for i in (4, 5, 6)], np.float32),
            )

        nv = len(verts)
        v = np.zeros((nv, 3), np.float32)
        uv = np.zeros((nv, 2), np.float32)
        bid = np.zeros((nv, MAX_WEIGHTS), np.int32)
        bw = np.zeros((nv, MAX_WEIGHTS), np.float32)
        for vi in range(nv):
            u_, v_, wstart, wcount = verts[vi]
            uv[vi] = (u_, v_)
            # bind-pose position + top-MAX_WEIGHTS influences
            contrib = []
            pos = np.zeros(3, np.float32)
            for wi in range(wstart, wstart + wcount):
                j, bias, wpos = wlist[wi]
                world = bind[j][:3, :3] @ wpos + bind[j][:3, 3]
                pos += bias * world
                contrib.append((bias, j))
            v[vi] = pos
            contrib.sort(reverse=True)
            top = contrib[:MAX_WEIGHTS]
            tot = sum(b for b, _ in top) or 1.0
            for k, (b, j) in enumerate(top):
                bid[vi, k] = j
                bw[vi, k] = b / tot

        all_v.append(v)
        all_uv.append(uv)
        all_bid.append(bid)
        all_bw.append(bw)
        all_tri.append(np.asarray(tris, np.int32) + v_off)
        mesh_of_tri.append(np.full(len(tris), mi, np.int32))
        v_off += nv

    return MD5Mesh(
        verts=np.concatenate(all_v),
        uvs=np.concatenate(all_uv),
        tris=np.concatenate(all_tri),
        bone_ids=np.concatenate(all_bid),
        weights=np.concatenate(all_bw),
        inv_bind=inv_bind,
        joint_names=names,
        joint_parents=np.asarray(parents, np.int32),
        shaders=shaders,
        mesh_of_tri=np.concatenate(mesh_of_tri),
    )


def load_md5anim(path: str) -> MD5Anim:
    with open(path) as f:
        text = _strip_comments(f.read())

    n_joints = int(re.search(r"numJoints\s+(\d+)", text).group(1))
    frame_rate = float(re.search(r"frameRate\s+(\d+)", text).group(1))

    hier = []
    names = []
    hm = re.search(r"hierarchy\s*\{(.*?)\}", text, re.S)
    for line in hm.group(1).strip().splitlines():
        m = re.match(r'\s*"([^"]*)"\s+(-?\d+)\s+(\d+)\s+(\d+)', line)
        if m:
            names.append(m.group(1))
            hier.append((int(m.group(2)), int(m.group(3)), int(m.group(4))))

    bm = re.search(r"baseframe\s*\{(.*?)\}", text, re.S)
    base = []
    for line in bm.group(1).strip().splitlines():
        m = re.match(
            rf"\s*\(\s*({_NUM})\s+({_NUM})\s+({_NUM})\s*\)"
            rf"\s*\(\s*({_NUM})\s+({_NUM})\s+({_NUM})\s*\)", line)
        if m:
            base.append([float(m.group(i)) for i in range(1, 7)])
    base = np.asarray(base, np.float32)  # (J, 6) pos + quat xyz

    poses = []
    for fm in re.finditer(r"frame\s+\d+\s*\{(.*?)\}", text, re.S):
        comps = np.asarray([float(x) for x in fm.group(1).split()], np.float32)
        world = np.zeros((n_joints, 4, 4), np.float32)
        for j in range(n_joints):
            parent, flags, start = hier[j]
            pos = base[j, :3].copy()
            quat = base[j, 3:].copy()
            c = start
            for bit, (arr, k) in enumerate(
                    [(pos, 0), (pos, 1), (pos, 2), (quat, 0), (quat, 1), (quat, 2)]):
                if flags & (1 << bit):
                    arr[k] = comps[c]
                    c += 1
            local = _quat_mat(quat, pos)
            world[j] = local if parent < 0 else world[parent] @ local
        poses.append(world)

    return MD5Anim(poses=np.stack(poses), frame_rate=frame_rate, joint_names=names)


def md5_corner_arrays(mesh: MD5Mesh):
    """Per-triangle-corner arrays for build_scene + make_skinned:
    returns (tris (T,3,3), uvs (T,3,2), bone_ids (T,3,W), weights (T,3,W),
    mat_ids (T,))."""
    t = mesh.tris
    return (
        mesh.verts[t],
        mesh.uvs[t],
        mesh.bone_ids[t],
        mesh.weights[t],
        mesh.mesh_of_tri.copy(),
    )


def leaf_order(data: np.ndarray, tri_index: np.ndarray) -> np.ndarray:
    """Permute per-triangle data into BVH leaf order (same permutation as
    Scene.shading; pad index = last entry repeated)."""
    idx = np.clip(np.asarray(tri_index), 0, len(data) - 1)
    return data[idx]
