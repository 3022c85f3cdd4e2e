"""Light sources (port of cudatracerlib_tpu/scene/lights.py:105-535).

`build_lights` assembles the same SoA table as the JAX package for every
light type (environment importance tables included). Direct sampling,
emission and emitted-ray sampling (the photon entry point) are ported for
AREA_LIGHT and INFINITE (the equirectangular environment map); a static
light-type set with any other type raises NotImplementedError. `lid` may be
an int or a per-lane tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._tree import tree_to
from ..math import montecarlo as mc
from ..math import warp
from ..math.frame import Frame
from ..math.vecmath import INV_PI, INV_TWOPI, PI, dot
from ..sampling.records import SOLID_ANGLE, DirectSample

POINT = 0
SPOT = 1
DISTANT = 2
AREA_LIGHT = 3
INFINITE = 4     # environment map
CONSTANT_ENV = 5

PORTED = (AREA_LIGHT, INFINITE)
MAX_LIGHT_TRIS = 64   # per-light CDF padding


class Lights(NamedTuple):
    ltype: torch.Tensor        # (NL,) int32
    position: torch.Tensor     # (NL, 3)
    direction: torch.Tensor    # (NL, 3)
    radiance: torch.Tensor     # (NL, 3)
    spot_cos_width: torch.Tensor    # (NL,)
    spot_cos_falloff: torch.Tensor  # (NL,)
    tri_first: torch.Tensor    # (NL,) int32 into the emissive triangle pool
    tri_count: torch.Tensor    # (NL,) int32
    tri_cdf: torch.Tensor      # (NL, W) per-light area CDF, W a power of two
    area: torch.Tensor         # (NL,) total area
    tris: torch.Tensor         # (NTL, 3, 3) emissive triangle pool
    tri_n: torch.Tensor        # (NTL, 3) unit geometric normals
    env_map: torch.Tensor      # (H, W, 3) equirect radiance (1x2 dummy if unused)
    env_w: torch.Tensor        # (H, W) luminance * sin(theta)
    env_row_cdf: torch.Tensor  # (H,)
    env_col_cdf: torch.Tensor  # (H, W)
    env_total: torch.Tensor    # ()
    world_center: torch.Tensor  # (3,)
    world_radius: torch.Tensor  # ()

    @property
    def count(self) -> int:
        return self.ltype.shape[0]

    def to(self, device) -> "Lights":
        return tree_to(self, device)


def check_ported(light_types):
    if light_types is None or not set(light_types) <= set(PORTED):
        raise NotImplementedError(f"light types {light_types}: only {PORTED} are ported")


def build_lights(records: list[dict], world_center, world_radius,
                 env_map: np.ndarray | None = None) -> Lights:
    """Host-side constructor. Each record: {type, position, direction,
    radiance, cos_width, cos_falloff, tris (K,3,3) for area lights}."""
    nl = max(len(records), 1)
    ltype = np.zeros(nl, np.int32)
    pos = np.zeros((nl, 3), np.float32)
    dirn = np.tile(np.array([0, 0, -1], np.float32), (nl, 1))
    rad = np.zeros((nl, 3), np.float32)
    cw = np.full(nl, np.cos(np.radians(20.0)), np.float32)
    cf = np.full(nl, np.cos(np.radians(15.0)), np.float32)
    tri_first = np.zeros(nl, np.int32)
    tri_count = np.zeros(nl, np.int32)
    max_tris = 4
    for r in records:
        if r["type"] == AREA_LIGHT:
            max_tris = max(max_tris, int(np.asarray(r["tris"]).shape[0]))
    width = 1 << (max_tris - 1).bit_length()  # pad CDF rows to the next pow2
    if width > MAX_LIGHT_TRIS:
        raise ValueError(f"an area light has more than {MAX_LIGHT_TRIS} triangles")
    tri_cdf = np.tile((np.arange(width, dtype=np.float32) + 1) / width, (nl, 1))
    area = np.zeros(nl, np.float32)
    pool: list[np.ndarray] = []

    for i, r in enumerate(records):
        ltype[i] = r["type"]
        pos[i] = np.asarray(r.get("position", [0, 0, 0]), np.float32)
        d = np.asarray(r.get("direction", [0, 0, -1]), np.float32)
        dirn[i] = d / max(np.linalg.norm(d), 1e-12)
        rad[i] = np.asarray(r.get("radiance", [1, 1, 1]), np.float32)
        cw[i] = r.get("cos_width", cw[i])
        cf[i] = r.get("cos_falloff", cf[i])
        if r["type"] == AREA_LIGHT:
            tris = np.asarray(r["tris"], np.float32)
            tri_first[i] = sum(p.shape[0] for p in pool)
            tri_count[i] = tris.shape[0]
            pool.append(tris)
            e1 = tris[:, 1] - tris[:, 0]
            e2 = tris[:, 2] - tris[:, 0]
            a = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
            area[i] = a.sum()
            cdf = np.cumsum(a) / max(a.sum(), 1e-12)
            tri_cdf[i, : len(cdf)] = cdf
            tri_cdf[i, len(cdf):] = 1.0

    if pool:
        tris_all = np.concatenate(pool, axis=0)
    else:
        tris_all = np.zeros((1, 3, 3), np.float32)
        tris_all[0, 1, 0] = 1e-6
        tris_all[0, 2, 1] = 1e-6
    e1 = tris_all[:, 1] - tris_all[:, 0]
    e2 = tris_all[:, 2] - tris_all[:, 0]
    n = np.cross(e1, e2)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    env = np.asarray(env_map if env_map is not None else np.zeros((1, 2, 3)), np.float32)
    eh = env.shape[0]
    lum = 0.212671 * env[..., 0] + 0.715160 * env[..., 1] + 0.072169 * env[..., 2]
    sin_rows = np.sin((np.arange(eh, dtype=np.float32) + 0.5) / eh * np.pi)
    env_w = np.maximum(lum * sin_rows[:, None], 1e-12).astype(np.float32)
    row_w = env_w.sum(axis=1)
    env_row_cdf = (np.cumsum(row_w) / max(row_w.sum(), 1e-12)).astype(np.float32)
    env_col_cdf = (np.cumsum(env_w, axis=1)
                   / np.maximum(env_w.sum(axis=1, keepdims=True), 1e-12)).astype(np.float32)

    arrays = dict(
        ltype=ltype, position=pos, direction=dirn, radiance=rad,
        spot_cos_width=cw, spot_cos_falloff=cf, tri_first=tri_first,
        tri_count=tri_count, tri_cdf=tri_cdf, area=area, tris=tris_all,
        tri_n=n.astype(np.float32), env_map=env, env_w=env_w,
        env_row_cdf=env_row_cdf, env_col_cdf=env_col_cdf,
        env_total=np.float32(env_w.sum()),
        world_center=np.asarray(world_center, np.float32),
        world_radius=np.float32(world_radius),
    )
    return Lights(**{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()})


def light_power(lights: Lights):
    """Approximate emitted power per light, for the selection CDF."""
    lum = (0.212671 * lights.radiance[:, 0] + 0.715160 * lights.radiance[:, 1]
           + 0.072169 * lights.radiance[:, 2])
    wr = torch.clamp(lights.world_radius, min=1e-6)
    env = lights.env_map
    env_mean = (0.212671 * env[..., 0] + 0.715160 * env[..., 1]
                + 0.072169 * env[..., 2]).mean()
    t = lights.ltype
    p = torch.where(t == POINT, 4.0 * PI * lum, 0.0)
    p = torch.where(t == SPOT, 2.0 * PI * (1.0 - lights.spot_cos_width) * lum, p)
    p = torch.where(t == DISTANT, PI * wr * wr * lum, p)
    p = torch.where(t == AREA_LIGHT, PI * lights.area * lum, p)
    p_env = 4.0 * PI * PI * wr * wr * torch.where(t == INFINITE, env_mean, lum)
    p = torch.where((t == INFINITE) | (t == CONSTANT_ENV), p_env, p)
    return torch.clamp(p, min=0.0)


def _area_point(lights: Lights, lid, u2):
    """A uniform point on area light `lid` (a triangle from its area CDF,
    then a uniform point on it) and that triangle's normal."""
    cdf_rows = lights.tri_cdf[lid]
    tri_sel, _, u_re = mc.sample_discrete(cdf_rows, u2[..., 0])
    tri_id = torch.clamp(lights.tri_first[lid] + tri_sel, 0, lights.tris.shape[0] - 1)
    v = lights.tris[tri_id]
    bary = warp.square_to_uniform_triangle(torch.stack([u_re, u2[..., 1]], dim=-1))
    p = (v[..., 0, :] * (1.0 - bary[..., 0:1] - bary[..., 1:2])
         + v[..., 1, :] * bary[..., 0:1]
         + v[..., 2, :] * bary[..., 1:2])
    return p, lights.tri_n[tri_id]


def _sample_area(lights: Lights, lid, ref_p, u2):
    """A point on area light `lid`: (p, n, d, dist, pdf, radiance)."""
    p, n = _area_point(lights, lid, u2)
    to_a = p - ref_p
    dist2 = torch.clamp(dot(to_a, to_a), min=1e-12)
    dist = torch.sqrt(dist2)
    d = to_a / dist[..., None]
    cos_l = -dot(d, n)
    pdf = dist2 / torch.clamp(cos_l.abs() * torch.clamp(lights.area[lid], min=1e-12), min=1e-12)
    rad = torch.where((cos_l > 0.0)[..., None], lights.radiance[lid], 0.0)
    return p, n, d, dist, pdf, rad


def _sample_env_direct(lights: Lights, lid, ref_p, u2):
    """A direction of the environment map: (p, n, d, dist, pdf, radiance),
    the point placed beyond the scene at twice its radius."""
    d, pdf, rad = _sample_env(lights, lid, u2)
    dist = (2.0 * torch.clamp(lights.world_radius, min=1e-6)).expand(pdf.shape)
    return ref_p + d * dist[..., None], -d, d, dist, pdf, rad


def sample_direct(lights: Lights, lid, ref_p, u2, active=None):
    """Sample a direction from `ref_p` toward light `lid`: a point on an
    area light, or an importance-sampled direction of the environment map.

    Returns (DirectSample, radiance (..., 3)); the pdf is w.r.t. solid angle
    at ref_p. `active`: the static tuple of light types in the scene; only
    their branches are computed, and with one type its branch is the result
    (every light of the scene has one of the active types)."""
    check_ported(active)
    branches = [(tag, fn(lights, lid, ref_p, u2))
                for tag, fn in ((AREA_LIGHT, _sample_area), (INFINITE, _sample_env_direct))
                if tag in active]
    p, n, d, dist, pdf, rad = branches[0][1]
    for tag, (p_i, n_i, d_i, dist_i, pdf_i, rad_i) in branches[1:]:
        m = lights.ltype[lid] == tag
        p, n, d = (torch.where(m[..., None], a, b) for a, b in ((p_i, p), (n_i, n), (d_i, d)))
        dist, pdf = torch.where(m, dist_i, dist), torch.where(m, pdf_i, pdf)
        rad = torch.where(m[..., None], rad_i, rad)
    ds = DirectSample(
        p=p, n=n, d=d, dist=dist, pdf=pdf,
        measure=torch.full(pdf.shape, SOLID_ANGLE, dtype=torch.int32, device=pdf.device),
        uv=torch.zeros(d.shape[:-1] + (2,), device=d.device),
    )
    return ds, rad


def _env_uv_from_dir(d):
    """Equirectangular (u, v) of a direction; v = 0 at the +z pole."""
    theta = torch.acos(torch.clamp(d[..., 2], -1.0 + 1e-7, 1.0 - 1e-7))
    phi = torch.atan2(d[..., 1], d[..., 0])
    phi = torch.where(phi < 0, phi + 2 * PI, phi)
    return torch.stack([phi * INV_TWOPI, theta * INV_PI], dim=-1)


def _env_texel(lights: Lights, d):
    """(y, x) texel of the environment map that direction d falls in."""
    H, W = lights.env_map.shape[0], lights.env_map.shape[1]
    uv = _env_uv_from_dir(d)
    x = torch.clamp((uv[..., 0] * W).to(torch.int32), 0, W - 1)
    y = torch.clamp((uv[..., 1] * H).to(torch.int32), 0, H - 1)
    return y.long(), x.long(), uv


def eval_env(lights: Lights, lid, d):
    """Environment radiance along direction d (reference EvalEnvironment)."""
    y, x, _ = _env_texel(lights, d)
    env = lights.env_map[y, x] * lights.radiance[lid]
    return torch.where((lights.ltype[lid] == INFINITE)[..., None], env, 0.0)


def pdf_env_dir(lights: Lights, lid, d):
    """Solid-angle pdf of `_sample_env` for direction d (for MIS):
    p(u, v) = w[y, x] H W / total over the map, divided by 2 pi^2 sin(theta)."""
    H, W = lights.env_w.shape[0], lights.env_w.shape[1]
    y, x, uv = _env_texel(lights, d)
    w_yx = lights.env_w[y, x]
    total = torch.clamp(lights.env_total, min=1e-12)
    sin_theta = torch.clamp(torch.sin(uv[..., 1] * PI), min=1e-6)
    pdf_inf = w_yx * H * W / total / (2.0 * PI * PI * sin_theta)
    return torch.where(lights.ltype[lid] == INFINITE, pdf_inf, 0.0)


def _sample_env(lights: Lights, lid, u2):
    """Importance-sample the environment map from its 2-D luminance CDF
    (reference InfiniteLight, Light.h:294-369): a row from the shared row
    CDF, then a column from that row's conditional CDF. The row is a plain
    gather `env_col_cdf[y]`, exact in float32 (the JAX package reads it
    through a one-hot HIGHEST-precision matmul on the TPU, equal by
    construction)."""
    H, W = lights.env_w.shape[0], lights.env_w.shape[1]
    y, pmf_row, uy = mc.sample_discrete(lights.env_row_cdf, u2[..., 1])
    row_cdf = lights.env_col_cdf[y]                      # (..., W)
    u0 = u2[..., 0]
    below = (row_cdf < u0[..., None]) & (torch.arange(W, device=u0.device) < W - 1)
    x = below.sum(-1)
    hi = torch.where(below, torch.inf, row_cdf).amin(-1)
    lo = torch.where(below, row_cdf, 0.0).amax(-1)
    pmf_col = torch.clamp(hi - lo, min=1e-12)
    ux = torch.clamp((u0 - lo) / pmf_col, 0.0, 1.0 - 1e-6)
    # continuous position within the texel
    u = (x.to(torch.float32) + ux) / W
    v = (y.to(torch.float32) + uy) / H
    theta = v * PI
    phi = u * 2.0 * PI
    st = torch.sin(theta)
    d = torch.stack([st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)], dim=-1)
    pdf = pmf_row * pmf_col * H * W / (2.0 * PI * PI * torch.clamp(st, min=1e-6))
    rad = lights.env_map[y, x] * lights.radiance[lid]
    return d, pdf, rad


def eval_area_emission(lights: Lights, lid, n, wo):
    """Radiance leaving an area light surface toward wo (front side only)."""
    front = dot(n, wo) > 0.0
    return torch.where(((lights.ltype[lid] == AREA_LIGHT) & front)[..., None],
                       lights.radiance[lid], 0.0)


def pdf_direct_area(lights: Lights, lid, ref_p, p, n):
    """Solid-angle pdf of sample_direct for a point p on area light lid (MIS)."""
    to_p = p - ref_p
    dist2 = torch.clamp(dot(to_p, to_p), min=1e-12)
    d = to_p / torch.sqrt(dist2)[..., None]
    cos_l = dot(d, n).abs()
    pdf = dist2 / torch.clamp(cos_l * torch.clamp(lights.area[lid], min=1e-12), min=1e-12)
    return torch.where(lights.ltype[lid] == AREA_LIGHT, pdf, 0.0)


def _emit_area(lights: Lights, lid, u_pos, u_dir):
    """Emitted ray of an area light: a uniform point, a cosine-distributed
    direction about its normal, power weight Le A pi."""
    p, n = _area_point(lights, lid, u_pos)
    d = Frame.from_normal(n).to_world(warp.square_to_cosine_hemisphere(u_dir))
    w = lights.radiance[lid] * (PI * lights.area[lid])[..., None]
    return p + n * 1e-4, d, w.expand(d.shape)


def _emit_env(lights: Lights, lid, u_pos, u_dir):
    """Emitted ray of the environment map: an importance-sampled direction,
    its origin on the world-sphere disk facing it."""
    wr = torch.clamp(lights.world_radius, min=1e-6)
    d_env, pdf_env, rad_env = _sample_env(lights, lid, u_dir)
    d = -d_env  # emitted toward the scene
    disk = warp.square_to_uniform_disk_concentric(u_pos) * wr
    on_disk = torch.stack([disk[..., 0], disk[..., 1], torch.zeros_like(disk[..., 0])], dim=-1)
    o = lights.world_center + Frame.from_normal(d).to_world(on_disk) - d * wr
    w = rad_env * (PI * wr * wr / torch.clamp(pdf_env, min=1e-12))[..., None]
    return o, d, w


def sample_emitter_ray(lights: Lights, lid, u_pos, u_dir, active=None):
    """Sample an emitted ray of light `lid` (the photon and light-tracing
    entry point, reference sampleEmitterRay). Returns (origin, direction,
    power weight (..., 3)), the weight being Le cos / (pdf_pos pdf_dir) so a
    particle walk just multiplies. `active`: the static tuple of light types
    in the scene; only their branches are computed, as in sample_direct."""
    check_ported(active)
    branches = [(tag, fn(lights, lid, u_pos, u_dir))
                for tag, fn in ((AREA_LIGHT, _emit_area), (INFINITE, _emit_env))
                if tag in active]
    o, d, w = branches[0][1]
    for tag, (o_i, d_i, w_i) in branches[1:]:
        m = (lights.ltype[lid] == tag)[..., None]
        o, d, w = torch.where(m, o_i, o), torch.where(m, d_i, d), torch.where(m, w_i, w)
    return o, d, w
