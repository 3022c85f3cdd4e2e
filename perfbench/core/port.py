"""The one module of the benchmark that imports the program
(cudatracerlib_tpu_torch): it hands the generated scene arrays to the
program's builders and calls its entry points. Everything else in the
benchmark reaches the program through here."""
from __future__ import annotations

import numpy as np

from cudatracerlib_tpu_torch.render import path_tracer, volpath
from cudatracerlib_tpu_torch.scene import bsdf as B
from cudatracerlib_tpu_torch.scene import lights as L
from cudatracerlib_tpu_torch.scene import media as M
from cudatracerlib_tpu_torch.scene import phase as P
from cudatracerlib_tpu_torch.scene.scene import Materials, build_scene
from cudatracerlib_tpu_torch.scene.sensors import Camera
from cudatracerlib_tpu_torch.scene.textures import Textures

_BSDF = {"diffuse": B.DIFFUSE, "roughconductor": B.ROUGHCONDUCTOR}
_DIST = {"ggx": 1}
_PHASE = {"hg": P.HG, "isotropic": P.ISOTROPIC}


def scene(data: dict, device):
    """The program's Scene of the generated arrays (its SBVH, light tables
    and specialization are built here, by the program)."""
    tex, mats = [], []
    for m in data["materials"]:
        rec = {"bsdf_type": _BSDF[m["bsdf"]], "tex_albedo": len(tex), "tex_specular": len(tex) + 1}
        tex += [{"type": 0, "color_a": m["albedo"]}, {"type": 0, "color_a": m["specular"]}]
        if m["bsdf"] == "roughconductor":
            rec.update(alpha_u=m["alpha"], alpha_v=m["alpha"], dist_type=_DIST[m["distribution"]],
                       cond_eta=m["cond_eta"], cond_k=m["cond_k"])
        if "emission" in m:
            rec.update(emission=np.asarray(m["emission"], np.float32), light_id=m["light_id"])
        mats.append(rec)
    lights = [{"type": L.AREA_LIGHT, "radiance": li["radiance"], "tris": li["tris"]}
              for li in data["lights"]]
    cam = data["camera"]
    camera = Camera.look_at(origin=cam["origin"], target=cam["target"], up=cam["up"],
                            fov_deg=cam["fov_deg"])
    return build_scene(data["vertices"], None, None, data["mat_id"], Materials.build(mats),
                       Textures.build(tex), lights, camera, device=device)


def media(data: dict, device):
    """The program's Media of the generated volumes."""
    recs = [dict(type=M.GRID, sigma_a=v["sigma_a"], sigma_s=v["sigma_s"], box_min=v["box_min"],
                 box_max=v["box_max"], phase_type=_PHASE[v["phase"]], phase_g=v["g"],
                 density=v["density"]) for v in data["media"]]
    return M.Media.build(recs, device=device)


def config(data: dict):
    return path_tracer.PTConfig(max_depth=data["max_depth"], rr_start=data["rr_start"],
                                ray_eps=data["ray_eps"])


def render(sc, width, height, spp, seed, cfg):
    """One surface pass: path_tracer.render, (H, W, 3)."""
    return path_tracer.render(sc, width, height, spp, seed, cfg)


def render_vol(sc, med, width, height, spp, seed, cfg):
    """One volumetric pass: volpath.render_vol, (H, W, 3); differentiable in
    the media's tensors that require grad."""
    return volpath.render_vol(sc, med, width, height, spp, seed, cfg)


def with_params(med, params: dict):
    """The media with the given fields replaced (the optimised leaves)."""
    return med._replace(**params)
