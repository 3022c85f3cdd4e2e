"""DynamicScene: the mutable host-side scene database
(port of cudatracerlib_tpu/scene/dynamic.py).

Meshes, instance nodes (a mesh placement with its material, optionally
emissive), lights, the environment map, the camera and textures are staged
on the host; `update()` is the one host -> device boundary and emits an
immutable Scene on the device. The default path flattens the instances
(each node's transform baked into its vertices) and builds one BVH with
`build_scene`; `update(instancing=True)` builds each mesh's BLAS once and
caches it (`_blas_cache`), and emits an instanced scene (scene/instances.py)
whose transforms apply at traversal: O(meshes) memory, and a
transform-only update rebuilds no BVH.

The JAX package registers an instanced scene's specialization in a host
registry keyed by its `shading.mat_id` (scene/_hostcache.py); the port
keeps it on the scene itself (`Scene.spec`) with exactly the fields JAX
registers, so `specialize_config` merges it as JAX merges its registry
entry: the caller's other fields (`sss` among them) stand.

Unlike the JAX package, which returns the last scene it built whenever
nothing changed, whichever path built it, the flattened path's cache is
kept per (path, device): `update(instancing=False)` after an instanced
update returns a flattened scene.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..accel.bvh import build_bvh
from . import bsdf as B
from . import lights as L
from .instances import BlasEntry, build_instance_groups
from .lights import build_lights, light_power
from .scene import Materials, Scene, ShadingData, build_scene
from .sensors import Camera
from .textures import Textures


@dataclass
class MeshHandle:
    mesh_id: int
    vertices: np.ndarray          # (T, 3, 3)
    normals: Optional[np.ndarray]
    uvs: Optional[np.ndarray]


@dataclass
class NodeHandle:
    """An instanced mesh placement (reference Node: mesh index + material)."""

    node_id: int
    mesh_id: int
    to_world: np.ndarray          # (4, 4)
    mat_record: dict
    light_radiance: Optional[np.ndarray] = None  # area emitter on this node


def instanced_spec(bsdf_type, ltype, ttype) -> dict:
    """The specialization JAX registers for an instanced scene, from the
    material, light and texture tables' type columns (numpy): every
    material's, light's and texture's type, shading never flat, no maps
    and no alpha test (and no `sss`, which the caller's config sets)."""
    types = lambda a: tuple(int(x) for x in np.unique(np.asarray(a)))  # noqa: E731
    return dict(bsdf_types=types(bsdf_type), light_types=types(ltype), tex_types=types(ttype),
                flat_shading=False, normal_maps=False, height_maps=False, parallax=False,
                alpha_test=False)


class DynamicScene:
    def __init__(self, device="cuda"):
        """An empty scene database whose scenes go to `device` (the card
        unless the caller asks for the CPU)."""
        self.device = device
        self._meshes: dict[int, MeshHandle] = {}
        self._nodes: dict[int, NodeHandle] = {}
        self._lights: list[dict] = []
        self._env_map: Optional[np.ndarray] = None
        self._camera = Camera.look_at([0, -5, 1], [0, 0, 1])
        self._tex_records: list[dict] = [{"type": 0, "color_a": [0.7] * 3}]
        self._next_id = 0
        self._dirty = True
        self._scene: Optional[Scene] = None
        self._scene_key = None
        self._blas_cache: dict = {}

    # ---- creation API (reference CreateNode / CreateLight / ...) ----

    def create_mesh(self, vertices, normals=None, uvs=None) -> MeshHandle:
        self._next_id += 1
        h = MeshHandle(self._next_id, np.asarray(vertices, np.float32), normals, uvs)
        self._meshes[h.mesh_id] = h
        self._dirty = True
        return h

    def create_node(self, mesh: MeshHandle, to_world=None,
                    mat_record: Optional[dict] = None) -> NodeHandle:
        self._next_id += 1
        h = NodeHandle(
            self._next_id, mesh.mesh_id,
            np.asarray(to_world if to_world is not None else np.eye(4), np.float64),
            dict(mat_record or {"bsdf_type": B.DIFFUSE, "tex_albedo": 0}),
        )
        self._nodes[h.node_id] = h
        self._dirty = True
        return h

    def remove_node(self, node: NodeHandle) -> None:
        self._nodes.pop(node.node_id, None)
        self._dirty = True

    def set_node_transform(self, node: NodeHandle, to_world) -> None:
        node.to_world = np.asarray(to_world, np.float64)
        self._dirty = True

    def create_light(self, record: dict) -> int:
        self._lights.append(dict(record))
        self._dirty = True
        return len(self._lights) - 1

    def make_node_emissive(self, node: NodeHandle, radiance) -> None:
        """Attach an area emitter to a node."""
        node.light_radiance = np.asarray(radiance, np.float32)
        self._dirty = True

    def set_environment_map(self, env: np.ndarray, radiance=(1.0, 1.0, 1.0)) -> None:
        self._env_map = np.asarray(env, np.float32)
        self.create_light({"type": L.INFINITE, "radiance": radiance})

    def set_camera(self, camera: Camera) -> None:
        self._camera = camera
        self._dirty = True

    def add_texture(self, record: dict) -> int:
        self._tex_records.append(dict(record))
        self._dirty = True
        return len(self._tex_records) - 1

    # ---- update cycle (reference UpdateScene) ----

    def update(self, instancing: bool = False, device=None) -> Scene:
        """Flush all mutations into a fresh Scene on `device` (by default
        the one given to the constructor). `instancing=True` builds the
        instanced scene from the cached BLAS; the default flattens."""
        device = self.device if device is None else device
        if instancing:
            return self._update_instanced(device)
        key = ("flat", str(device))
        if not self._dirty and self._scene is not None and self._scene_key == key:
            return self._scene
        parts, norms, uvs, mids = [], [], [], []
        mat_records: list[dict] = []
        light_records = [dict(r) for r in self._lights]
        for node in self._nodes.values():
            mesh = self._meshes[node.mesh_id]
            m = node.to_world
            v = (mesh.vertices.reshape(-1, 3) @ m[:3, :3].T + m[:3, 3]).reshape(
                -1, 3, 3).astype(np.float32)
            n = mesh.normals
            if n is not None:
                nm = np.linalg.inv(m[:3, :3]).T
                n = (np.asarray(n).reshape(-1, 3) @ nm.T).reshape(-1, 3, 3)
                n = (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
                     ).astype(np.float32)
            rec = dict(node.mat_record)
            if node.light_radiance is not None:
                rec["emission"] = node.light_radiance
                rec["light_id"] = len(light_records)
                light_records.append({"type": L.AREA_LIGHT, "radiance": node.light_radiance,
                                      "tris": v})
            mid = len(mat_records)
            mat_records.append(rec)
            parts.append(v)
            norms.append(n)
            uvs.append(mesh.uvs)
            mids.extend([mid] * len(v))
        if not parts:
            raise ValueError("DynamicScene has no nodes")
        vertices = np.concatenate(parts)
        normals = np.concatenate([n if n is not None else _face_n(p)
                                  for n, p in zip(norms, parts)])
        all_uvs = np.concatenate([u if u is not None else _default_uv(len(p))
                                  for u, p in zip(uvs, parts)])
        self._scene = build_scene(
            vertices, normals, all_uvs, np.asarray(mids, np.int32),
            Materials.build(mat_records), Textures.build(self._tex_records),
            light_records, self._camera, env_map=self._env_map, device=device)
        self._scene_key = key
        self._dirty = False
        return self._scene

    def _mesh_blas(self, mesh_id: int, device) -> dict:
        """Mesh `mesh_id`'s BLAS and leaf-ordered object-space shading
        tables, built once per device and cached."""
        key = (mesh_id, str(device))
        cached = self._blas_cache.get(key)
        if cached is not None:
            return cached
        mesh = self._meshes[mesh_id]
        v = mesh.vertices
        bvh, host = build_bvh(v, with_host=True, device=device)
        order = host["order"]
        v_ord = v[order]
        n_ord = (np.asarray(mesh.normals, np.float32)[order] if mesh.normals is not None
                 else _face_n(v_ord))
        uv_ord = (np.asarray(mesh.uvs, np.float32)[order] if mesh.uvs is not None
                  else _default_uv(len(v_ord)))
        nf = np.cross(v_ord[:, 1] - v_ord[:, 0], v_ord[:, 2] - v_ord[:, 0])
        nf = (nf / np.maximum(np.linalg.norm(nf, axis=-1, keepdims=True), 1e-12)
              ).astype(np.float32)
        duv1 = uv_ord[:, 1] - uv_ord[:, 0]
        duv2 = uv_ord[:, 2] - uv_ord[:, 0]
        uv_area = 0.5 * np.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
        w_area = 0.5 * np.linalg.norm(
            np.cross(v_ord[:, 1] - v_ord[:, 0], v_ord[:, 2] - v_ord[:, 0]), axis=-1)
        uvd = np.sqrt(uv_area / np.maximum(w_area, 1e-20)).astype(np.float32)
        cached = dict(bvh=bvh, verts=v_ord, normals=n_ord, uvs=uv_ord, n_face=nf,
                      uv_density=uvd)
        self._blas_cache[key] = cached
        return cached

    def _update_instanced(self, device) -> Scene:
        by_mesh: dict[int, list[NodeHandle]] = {}
        for node in self._nodes.values():
            by_mesh.setdefault(node.mesh_id, []).append(node)
        if not by_mesh:
            raise ValueError("DynamicScene has no nodes")

        shading_parts, prim_bases = [], []
        base = 0
        for mesh_id in by_mesh:
            cached = self._mesh_blas(mesh_id, device)
            shading_parts.append(cached)
            prim_bases.append(base)
            base += cached["verts"].shape[0]

        # per-node materials (+ area emitters with world-space light triangles)
        mat_records: list[dict] = []
        light_records = [dict(r) for r in self._lights]
        inst_records = []
        for mesh_id, nodes in by_mesh.items():
            recs = []
            mesh = self._meshes[mesh_id]
            for node in nodes:
                rec = dict(node.mat_record)
                if node.light_radiance is not None:
                    m = node.to_world
                    v_w = (mesh.vertices.reshape(-1, 3) @ m[:3, :3].T
                           + m[:3, 3]).reshape(-1, 3, 3).astype(np.float32)
                    rec["emission"] = node.light_radiance
                    rec["light_id"] = len(light_records)
                    light_records.append({"type": L.AREA_LIGHT,
                                          "radiance": node.light_radiance, "tris": v_w})
                mid = len(mat_records)
                mat_records.append(rec)
                recs.append((node.to_world, mid))
            inst_records.append(recs)
        obj_bounds = [(self._meshes[k].vertices.reshape(-1, 3).min(0),
                       self._meshes[k].vertices.reshape(-1, 3).max(0)) for k in by_mesh]
        groups = build_instance_groups(inst_records, prim_bases, obj_bounds, device=device)

        # shading tables in object space, concatenated in prim_base order; the
        # mat_id column holds each mesh's first instance's material (the
        # traversal takes each instance's own)
        cat = lambda k: torch.from_numpy(np.concatenate([p[k] for p in shading_parts]))  # noqa: E731
        mids = np.concatenate([np.full(p["verts"].shape[0], recs[0][1], np.int32)
                               for p, recs in zip(shading_parts, inst_records)])
        shading = ShadingData(verts=cat("verts"), normals=cat("normals"), uvs=cat("uvs"),
                              mat_id=torch.from_numpy(mids), n_face=cat("n_face"),
                              uv_density=cat("uv_density"))

        # world bounds: the union of the transformed mesh boxes' corners
        wmin, wmax = np.full(3, np.inf), np.full(3, -np.inf)
        for (lo, hi), nodes in zip(obj_bounds, by_mesh.values()):
            corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            for node in nodes:
                m = node.to_world
                cw = corners @ m[:3, :3].T + m[:3, 3]
                wmin, wmax = np.minimum(wmin, cw.min(0)), np.maximum(wmax, cw.max(0))
        center = 0.5 * (wmin + wmax)
        radius = 0.5 * float(np.linalg.norm(wmax - wmin)) + 1e-4

        lights = build_lights(light_records, center, radius, self._env_map)
        power = light_power(lights)
        if len(light_records) == 0:
            power = torch.zeros_like(power)
        cdf = torch.cumsum(power, 0) / torch.clamp(power.sum(), min=1e-20)
        env_id = -1
        for i, r in enumerate(light_records):
            if r["type"] in (L.INFINITE, L.CONSTANT_ENV):
                env_id = i

        blas = tuple(BlasEntry(bvh=p["bvh"]) for p in shading_parts)
        bvh0 = blas[0].bvh._replace(world_min=wmin.astype(np.float32),
                                    world_max=wmax.astype(np.float32))
        materials, textures = Materials.build(mat_records), Textures.build(self._tex_records)
        self._scene = Scene(
            bvh=bvh0, shading=shading, materials=materials, textures=textures, lights=lights,
            light_cdf=cdf, camera=self._camera, env_light_id=torch.tensor(np.int32(env_id)),
            spec=instanced_spec(materials.bsdf_type.numpy(), lights.ltype.cpu().numpy(),
                                textures.ttype.numpy()),
            blas=blas, instances=groups,
        ).to(device)
        self._scene_key = ("instanced", str(device))
        self._dirty = False
        return self._scene


def _face_n(v):
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return np.repeat(n[:, None, :], 3, axis=1).astype(np.float32)


def _default_uv(t):
    uv = np.zeros((t, 3, 2), np.float32)
    uv[:, 1, 0] = 1.0
    uv[:, 2, 1] = 1.0
    return uv
