"""Light sources (port of cudatracerlib_tpu/scene/lights.py:105-535).

`build_lights` assembles the same SoA table as the JAX package for every
light type (environment importance tables included). Every light type is
ported: direct sampling and emission for POINT, SPOT (with its smooth
falloff), DISTANT, AREA_LIGHT, INFINITE (the equirectangular environment
map) and CONSTANT_ENV, and emitted-ray sampling (the photon and light-tracing
entry point) for all six. The static light-type set is required (None
raises NotImplementedError). `lid` may be an int or a per-lane tensor.
Every emission quantity is differentiable in the light table.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._tree import tree_to
from ..math import montecarlo as mc
from ..math import warp
from ..math.frame import Frame
from ..math.vecmath import INV_FOURPI, INV_PI, INV_TWOPI, PI, dot
from ..ops.shade_gather import gather_rows
from ..sampling.records import DISCRETE, SOLID_ANGLE, DirectSample

POINT = 0
SPOT = 1
DISTANT = 2
AREA_LIGHT = 3
INFINITE = 4     # environment map
CONSTANT_ENV = 5

PORTED = (POINT, SPOT, DISTANT, AREA_LIGHT, INFINITE, CONSTANT_ENV)
DELTA = (POINT, SPOT, DISTANT)            # sampled with a discrete measure
MAX_LIGHT_TRIS = 64   # per-light CDF padding
ENV_RES_Y = 64        # environment CDF resolution (theta); phi = 2*ENV_RES_Y


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
    """The port always passes the static type set; None and unknown types
    are refused."""
    if light_types is None or not set(light_types) <= set(PORTED):
        raise NotImplementedError(f"light types {light_types}: pass the static tuple of "
                                  f"types in {PORTED}")


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
    v = gather_rows(lights.tris, tri_id)
    bary = warp.square_to_uniform_triangle(torch.stack([u_re, u2[..., 1]], dim=-1))
    p = (v[..., 0, :] * (1.0 - bary[..., 0:1] - bary[..., 1:2])
         + v[..., 1, :] * bary[..., 0:1]
         + v[..., 2, :] * bary[..., 1:2])
    return p, gather_rows(lights.tri_n, tri_id)


def _sample_point(lights: Lights, lid, ref_p, u2):
    """Toward point light `lid`: (p, n, d, dist, pdf = 1, intensity /
    dist^2); its measure is discrete."""
    to_l = gather_rows(lights.position, lid) - ref_p
    dist2 = torch.clamp(dot(to_l, to_l), min=1e-12)
    dist = torch.sqrt(dist2)
    d = to_l / dist[..., None]
    rad = gather_rows(lights.radiance, lid) / dist2[..., None]
    return ref_p + d * dist[..., None], -d, d, dist, torch.ones_like(dist), rad


def _spot_falloff(lights: Lights, lid, w):
    """Smooth spot falloff: 0 outside the cone of cos_width, 1 inside the
    cone of cos_falloff, a smoothstep between. `w` points from the light
    toward the shaded point, negated (cd = -w . direction)."""
    cd = -dot(w, gather_rows(lights.direction, lid))
    cw = gather_rows(lights.spot_cos_width, lid)
    cf = gather_rows(lights.spot_cos_falloff, lid)
    t = torch.clamp((cd - cw) / torch.clamp(cf - cw, min=1e-6), 0.0, 1.0)
    return torch.where(cd < cw, 0.0, torch.where(cd > cf, 1.0, t * t * (3.0 - 2.0 * t)))


def _sample_spot(lights: Lights, lid, ref_p, u2):
    """Toward spot light `lid`: the point light's sample times the falloff."""
    p, n, d, dist, pdf, rad = _sample_point(lights, lid, ref_p, u2)
    return p, n, d, dist, pdf, rad * _spot_falloff(lights, lid, d)[..., None]


def _sample_distant(lights: Lights, lid, ref_p, u2):
    """Toward distant light `lid`: against its direction, the point placed
    at twice the scene's radius, the irradiance as radiance, pdf 1."""
    d = (-gather_rows(lights.direction, lid)).expand(ref_p.shape)
    rad = gather_rows(lights.radiance, lid).expand(ref_p.shape)
    return _env_point(lights, ref_p, d, torch.ones(ref_p.shape[:-1], device=ref_p.device), rad)


def _sample_area(lights: Lights, lid, ref_p, u2):
    """A point on area light `lid`: (p, n, d, dist, pdf, radiance)."""
    p, n = _area_point(lights, lid, u2)
    to_a = p - ref_p
    dist2 = torch.clamp(dot(to_a, to_a), min=1e-12)
    dist = torch.sqrt(dist2)
    d = to_a / dist[..., None]
    cos_l = -dot(d, n)
    area = torch.clamp(gather_rows(lights.area, lid), min=1e-12)
    pdf = dist2 / torch.clamp(cos_l.abs() * area, min=1e-12)
    rad = torch.where((cos_l > 0.0)[..., None], gather_rows(lights.radiance, lid), 0.0)
    return p, n, d, dist, pdf, rad


def _env_point(lights: Lights, ref_p, d, pdf, rad):
    """(p, n, d, dist, pdf, radiance) of an environment direction, the
    point placed beyond the scene at twice its radius."""
    dist = (2.0 * torch.clamp(lights.world_radius, min=1e-6)).expand(pdf.shape)
    return ref_p + d * dist[..., None], -d, d, dist, pdf, rad


def _sample_env_direct(lights: Lights, lid, ref_p, u2):
    """A direction of the environment map, importance-sampled."""
    return _env_point(lights, ref_p, *_sample_env(lights, lid, u2))


def _sample_const_env_direct(lights: Lights, lid, ref_p, u2):
    """A uniform direction of the constant environment."""
    d = warp.square_to_uniform_sphere(u2)
    pdf = torch.full(d.shape[:-1], INV_FOURPI, device=d.device)
    return _env_point(lights, ref_p, d, pdf, gather_rows(lights.radiance, lid).expand(d.shape))


_DIRECT = ((POINT, _sample_point), (SPOT, _sample_spot), (DISTANT, _sample_distant),
           (AREA_LIGHT, _sample_area),
           (INFINITE, _sample_env_direct), (CONSTANT_ENV, _sample_const_env_direct))


def sample_direct(lights: Lights, lid, ref_p, u2, active=None):
    """Sample a direction from `ref_p` toward light `lid`: a point or spot
    light, against a distant light's direction, a point on an area light, an importance-sampled direction of the
    environment map or a uniform one of the constant environment.

    Returns (DirectSample, radiance (..., 3)); the pdf is w.r.t. solid angle
    at ref_p, except for the delta lights (point, spot, distant), whose
    measure is DISCRETE with pdf 1
    (the reference convention; MIS treats it as unmatchable). `active`: the
    static tuple of light types in the scene; only their branches are
    computed, and with one type its branch is the result (every light of the
    scene has one of the active types)."""
    check_ported(active)
    branches = [(tag, fn(lights, lid, ref_p, u2)) for tag, fn in _DIRECT if tag in active]
    p, n, d, dist, pdf, rad = branches[0][1]
    measure = torch.full(pdf.shape, DISCRETE if branches[0][0] in DELTA else SOLID_ANGLE,
                         dtype=torch.int32, device=pdf.device)
    for tag, (p_i, n_i, d_i, dist_i, pdf_i, rad_i) in branches[1:]:
        m = lights.ltype[lid] == tag
        p, n, d = (torch.where(m[..., None], a, b) for a, b in ((p_i, p), (n_i, n), (d_i, d)))
        dist, pdf = torch.where(m, dist_i, dist), torch.where(m, pdf_i, pdf)
        rad = torch.where(m[..., None], rad_i, rad)
        measure = torch.where(m, DISCRETE if tag in DELTA else SOLID_ANGLE, measure)
    ds = DirectSample(
        p=p, n=n, d=d, dist=dist, pdf=pdf, measure=measure.to(torch.int32),
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
    """Environment radiance along direction d (reference EvalEnvironment):
    the map's texel times the scale for INFINITE, the radiance for
    CONSTANT_ENV, 0 for any other light."""
    y, x, _ = _env_texel(lights, d)
    rad = gather_rows(lights.radiance, lid)
    t = lights.ltype[lid]
    return torch.where((t == INFINITE)[..., None], lights.env_map[y, x] * rad,
                       torch.where((t == CONSTANT_ENV)[..., None], rad, 0.0))


def pdf_env_dir(lights: Lights, lid, d):
    """Solid-angle pdf of the environment's direct sampling for direction d
    (for MIS): for INFINITE p(u, v) = w[y, x] H W / total over the map,
    divided by 2 pi^2 sin(theta); for CONSTANT_ENV 1 / (4 pi)."""
    H, W = lights.env_w.shape[0], lights.env_w.shape[1]
    y, x, uv = _env_texel(lights, d)
    w_yx = lights.env_w[y, x]
    total = torch.clamp(lights.env_total, min=1e-12)
    sin_theta = torch.clamp(torch.sin(uv[..., 1] * PI), min=1e-6)
    pdf_inf = w_yx * H * W / total / (2.0 * PI * PI * sin_theta)
    t = lights.ltype[lid]
    return torch.where(t == INFINITE, pdf_inf, torch.where(t == CONSTANT_ENV, INV_FOURPI, 0.0))


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
    rad = lights.env_map[y, x] * gather_rows(lights.radiance, lid)
    return d, pdf, rad


def eval_area_emission(lights: Lights, lid, n, wo):
    """Radiance leaving an area light surface toward wo (front side only)."""
    front = dot(n, wo) > 0.0
    return torch.where(((lights.ltype[lid] == AREA_LIGHT) & front)[..., None],
                       gather_rows(lights.radiance, lid), 0.0)


def pdf_direct_area(lights: Lights, lid, ref_p, p, n):
    """Solid-angle pdf of sample_direct for a point p on area light lid (MIS)."""
    to_p = p - ref_p
    dist2 = torch.clamp(dot(to_p, to_p), min=1e-12)
    d = to_p / torch.sqrt(dist2)[..., None]
    cos_l = dot(d, n).abs()
    area = torch.clamp(gather_rows(lights.area, lid), min=1e-12)
    pdf = dist2 / torch.clamp(cos_l * area, min=1e-12)
    return torch.where(lights.ltype[lid] == AREA_LIGHT, pdf, 0.0)


def _emit_area(lights: Lights, lid, u_pos, u_dir):
    """Emitted ray of an area light: a uniform point, a cosine-distributed
    direction about its normal, power weight Le A pi."""
    p, n = _area_point(lights, lid, u_pos)
    d = Frame.from_normal(n).to_world(warp.square_to_cosine_hemisphere(u_dir))
    w = gather_rows(lights.radiance, lid) * (PI * gather_rows(lights.area, lid))[..., None]
    return p + n * 1e-4, d, w.expand(d.shape)


def _emit_from_env(lights: Lights, u_pos, d_env, pdf_env, rad_env):
    """Emitted ray of an environment direction d_env: toward the scene,
    from the world-sphere disk facing it, weight Le pi r^2 / pdf."""
    wr = torch.clamp(lights.world_radius, min=1e-6)
    d = -d_env
    disk = warp.square_to_uniform_disk_concentric(u_pos) * wr
    on_disk = torch.stack([disk[..., 0], disk[..., 1], torch.zeros_like(disk[..., 0])], dim=-1)
    o = lights.world_center + Frame.from_normal(d).to_world(on_disk) - d * wr
    w = rad_env * (PI * wr * wr / torch.clamp(pdf_env, min=1e-12))[..., None]
    return o, d, w


def _emit_env(lights: Lights, lid, u_pos, u_dir):
    """Emitted ray of the environment map: an importance-sampled direction."""
    return _emit_from_env(lights, u_pos, *_sample_env(lights, lid, u_dir))


def _emit_const_env(lights: Lights, lid, u_pos, u_dir):
    """Emitted ray of the constant environment: a uniform direction."""
    d = warp.square_to_uniform_sphere(u_dir)
    pdf = torch.full(d.shape[:-1], INV_FOURPI, device=d.device)
    return _emit_from_env(lights, u_pos, d, pdf, gather_rows(lights.radiance, lid).expand(d.shape))


def _emit_point(lights: Lights, lid, u_pos, u_dir):
    """Emitted ray of a point light: a uniform direction, weight I 4 pi."""
    d = warp.square_to_uniform_sphere(u_dir)
    o = gather_rows(lights.position, lid).expand(d.shape)
    return o, d, (gather_rows(lights.radiance, lid) * (4.0 * PI)).expand(d.shape)


def _emit_spot(lights: Lights, lid, u_pos, u_dir):
    """Emitted ray of a spot light: uniform in its cone of cos_width about
    its direction, weight I falloff / pdf_cone."""
    cw = gather_rows(lights.spot_cos_width, lid)
    d = Frame.from_normal(gather_rows(lights.direction, lid)).to_world(
        warp.square_to_uniform_cone(u_dir, cw))
    fall = _spot_falloff(lights, lid, -d)
    w = (gather_rows(lights.radiance, lid) * fall[..., None]
         / torch.clamp(warp.square_to_uniform_cone_pdf(cw), min=1e-12)[..., None])
    return gather_rows(lights.position, lid).expand(d.shape), d, w


def _emit_distant(lights: Lights, lid, u_pos, u_dir):
    """Emitted ray of a distant light: along its direction, from the disk
    of the world sphere's radius facing it, weight E pi r^2."""
    wr = torch.clamp(lights.world_radius, min=1e-6)
    dirn = gather_rows(lights.direction, lid)
    disk = warp.square_to_uniform_disk_concentric(u_pos) * wr
    on_disk = torch.stack([disk[..., 0], disk[..., 1], torch.zeros_like(disk[..., 0])], dim=-1)
    o = lights.world_center + Frame.from_normal(dirn).to_world(on_disk) - dirn * wr
    w = gather_rows(lights.radiance, lid) * (PI * wr * wr)
    return o, dirn.expand(o.shape), w.expand(o.shape)


_EMIT = ((POINT, _emit_point), (SPOT, _emit_spot), (DISTANT, _emit_distant),
         (AREA_LIGHT, _emit_area), (INFINITE, _emit_env), (CONSTANT_ENV, _emit_const_env))


def sample_emitter_ray(lights: Lights, lid, u_pos, u_dir, active=None):
    """Sample an emitted ray of light `lid` (the photon and light-tracing
    entry point, reference sampleEmitterRay). Returns (origin, direction,
    power weight (..., 3)), the weight being Le cos / (pdf_pos pdf_dir) so a
    particle walk just multiplies. `active`: the static tuple of light types
    in the scene; only their branches are computed, as in sample_direct."""
    check_ported(active)
    branches = [(tag, fn(lights, lid, u_pos, u_dir)) for tag, fn in _EMIT if tag in active]
    o, d, w = branches[0][1]
    for tag, (o_i, d_i, w_i) in branches[1:]:
        m = (lights.ltype[lid] == tag)[..., None]
        o, d, w = torch.where(m, o_i, o), torch.where(m, d_i, d), torch.where(m, w_i, w)
    return o, d, w
