"""What the surface and volume references share: the scene's tables built
from the generated arrays, the perspective camera, the two BSDFs the
configurations use (diffuse and GGX rough conductor, both two-sided), the
area light's sampling and pdf, and the power heuristic."""
from __future__ import annotations

import math

import numpy as np
import torch

from .geometry import Triangles
from .sampler import Stream

INV_PI = 1.0 / math.pi
DIFFUSE, ROUGHCONDUCTOR = 0, 1
BSDF_KINDS = {"diffuse": DIFFUSE, "roughconductor": ROUGHCONDUCTOR}


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def normalize(v):
    return v * torch.rsqrt(torch.clamp(dot(v, v)[..., None], min=1e-20))


def onb(n):
    """Tangents (s, t) of a unit normal, Duff et al. 2017."""
    nx, ny, nz = n.unbind(-1)
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    t = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return s, t


def to_local(s, t, n, v):
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], -1)


def to_world(s, t, n, v):
    return s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]


def mis(a, b):
    return a * a / torch.clamp(a * a + b * b, min=1e-20)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=1e-20))


class RefScene:
    """The generated scene's tables on `device` in `dtype`."""

    def __init__(self, data: dict, device, dtype=torch.float32):
        self.device, self.dtype = device, dtype
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)  # noqa: E731
        verts = np.asarray(data["vertices"], np.float32)
        self.tris = Triangles(verts, device, dtype)
        n = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
        self.n_face = f(n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12))
        self.edge1 = f(verts[:, 1] - verts[:, 0])
        self.mat_id = torch.as_tensor(data["mat_id"], device=device).long()
        mats = data["materials"]
        self.kind = torch.tensor([BSDF_KINDS[m["bsdf"]] for m in mats], device=device)
        self.kinds = {BSDF_KINDS[m["bsdf"]] for m in mats}
        self.albedo = f([m["albedo"] for m in mats])
        self.specular = f([m["specular"] for m in mats])
        self.alpha = f([m.get("alpha", 0.1) for m in mats])
        self.cond_eta = f([m.get("cond_eta", [0.2, 0.92, 1.1]) for m in mats])
        self.cond_k = f([m.get("cond_k", [3.9, 2.45, 2.14]) for m in mats])
        self.light_id = torch.tensor([m.get("light_id", -1) for m in mats], device=device)
        (light,) = data["lights"]            # one area light in every configuration
        lt = np.asarray(light["tris"], np.float32)
        e1, e2 = lt[:, 1] - lt[:, 0], lt[:, 2] - lt[:, 0]
        c = np.cross(e1, e2)
        a = 0.5 * np.linalg.norm(c, axis=-1)
        width = 1 << (max(4, len(lt)) - 1).bit_length()
        cdf = np.ones(width, np.float32)
        cdf[:len(lt)] = np.cumsum(a) / max(a.sum(), 1e-12)
        self.light_cdf = f(cdf)
        self.light_tris = f(lt)
        self.light_n = f(c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-12))
        self.light_area = float(np.float32(a.sum()))
        self.light_radiance = f(light["radiance"])
        cam = data["camera"]
        o, tg, up = (np.asarray(cam[k], np.float64) for k in ("origin", "target", "up"))
        fwd = (tg - o) / max(np.linalg.norm(tg - o), 1e-12)
        right = np.cross(fwd, up)
        right = right / max(np.linalg.norm(right), 1e-12)
        m = np.eye(4)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, np.cross(right, fwd), fwd, o
        self.cam = f(m.astype(np.float32))
        self.tan_half_fov = float(np.float32(np.tan(np.radians(cam["fov_deg"]) / 2)))
        self.max_depth, self.rr_start = data["max_depth"], data["rr_start"]
        self.eps = data["ray_eps"]

    def camera_rays(self, pixel_id, sample_idx, width, height, seed):
        """(o, d, stream) of the camera samples: jitter, then the (unused)
        aperture pair, then a pinhole ray through the jittered position."""
        st = Stream.create(seed, pixel_id, sample_idx, self.dtype)
        jit = st.next(2)
        st.next(2)
        px = (pixel_id % width).to(self.dtype)
        py = (pixel_id // width).to(self.dtype)
        u = (px + jit[:, 0]) / width
        v = (py + jit[:, 1]) / height
        x = (u * 2.0 - 1.0) * self.tan_half_fov
        y = (1.0 - v * 2.0) * self.tan_half_fov
        dc = normalize(torch.stack([x, y, torch.ones_like(x)], -1))
        m = self.cam
        rows = [m[i, 0] * dc[:, 0] + m[i, 1] * dc[:, 1] + m[i, 2] * dc[:, 2] for i in range(3)]
        d = normalize(torch.stack(rows, -1))
        o = m[:3, 3].expand(d.shape).contiguous()
        return o, d, st

    def hit_frame(self, o, d, t, prim):
        """(valid, p, n_geo, mat) at the closest hits."""
        valid = prim >= 0
        pc = prim.clamp(min=0)
        p = o + d * torch.where(valid & torch.isfinite(t), t, 1.0)[:, None]
        return valid, p, self.n_face[pc], torch.where(valid, self.mat_id[pc], 0)

    def uv_frame(self, prim, n):
        """The shading frame whose tangent follows the triangle's default uv
        chart (u along the first edge): (s, t), with normal n."""
        e1 = self.edge1[prim.clamp(min=0)]
        s = e1 - n * dot(n, e1)[:, None]
        s = s / torch.sqrt(torch.clamp(dot(s, s), min=1e-18))[:, None]
        return s, cross(n, s)

    def sample_light(self, p, u_l2):
        """A point on the area light: (direction, distance, solid-angle pdf,
        radiance)."""
        n = self.light_cdf.shape[0]
        u = u_l2[:, 0]
        below = (self.light_cdf[None, :] < u[:, None]) & (torch.arange(n, device=p.device) < n - 1)
        idx = below.sum(-1)
        hi = torch.where(below, torch.inf, self.light_cdf[None, :]).amin(-1)
        lo = torch.where(below, self.light_cdf[None, :], 0.0).amax(-1)
        pmf = torch.clamp(hi - lo, min=0.0)
        u_re = torch.clamp((u - lo) / torch.clamp(pmf, min=1e-20), 0.0, 1.0 - 1e-7)
        tri = idx.clamp(max=self.light_tris.shape[0] - 1)
        v = self.light_tris[tri]
        a = safe_sqrt(1.0 - u_re)
        b0, b1 = (1.0 - a)[:, None], (a * u_l2[:, 1])[:, None]
        q = v[:, 0] * (1.0 - b0 - b1) + v[:, 1] * b0 + v[:, 2] * b1
        to = q - p
        dist2 = torch.clamp(dot(to, to), min=1e-12)
        dist = torch.sqrt(dist2)
        dl = to / dist[:, None]
        cos_l = -dot(dl, self.light_n[tri])
        pdf = dist2 / torch.clamp(cos_l.abs() * self.light_area, min=1e-12)
        rad = torch.where((cos_l > 0)[:, None], self.light_radiance, 0.0)
        return dl, dist, pdf, rad

    def light_pdf_at(self, o, p, n):
        """Solid-angle pdf of `sample_light` from o for the light point p."""
        to = p - o
        dist2 = torch.clamp(dot(to, to), min=1e-12)
        cos_l = dot(to / torch.sqrt(dist2)[:, None], n).abs()
        return dist2 / torch.clamp(cos_l * self.light_area, min=1e-12)

    def emitted(self, mat, valid, n_geo, d, o, p, prev_pdf, prev_delta):
        """Radiance of the light material seen along d, with its MIS weight
        against light sampling (full weight after a delta lobe or the camera)."""
        is_light = valid & (self.light_id[mat] >= 0) & (dot(n_geo, -d) > 0)
        pdf_hit = self.light_pdf_at(o, p, n_geo)
        w = torch.where(prev_delta, 1.0, mis(prev_pdf, pdf_hit))
        return torch.where(is_light[:, None], self.light_radiance * w[:, None], 0.0)

    # ---- BSDFs, in the local frame, two-sided ----

    def bsdf_eval(self, mat, wo, wi):
        """(f cos, pdf) of the lanes' materials for wo -> wi."""
        s = torch.where(wo[:, 2] < 0, -1.0, 1.0).to(wo.dtype)
        wo, wi = _mulz(wo, s), _mulz(wi, s)
        valid = (wo[:, 2] > 0) & (wi[:, 2] > 0)
        f = self.albedo[mat] * (INV_PI * torch.clamp(wi[:, 2], min=0.0))[:, None]
        pdf = torch.clamp(wi[:, 2], min=0.0) * INV_PI
        if ROUGHCONDUCTOR in self.kinds:
            fr_, pr_ = self._conductor(mat, wo, wi)
            rc = self.kind[mat] == ROUGHCONDUCTOR
            f = torch.where(rc[:, None], fr_, f)
            pdf = torch.where(rc, pr_, pdf)
        return torch.where(valid[:, None], f, 0.0), torch.where(valid, pdf, 0.0)

    def bsdf_sample(self, mat, wo, u2):
        """(wi, weight f cos / pdf, pdf) of the lanes' materials."""
        s = torch.where(wo[:, 2] < 0, -1.0, 1.0).to(wo.dtype)
        wo = _mulz(wo, s)
        wi = _cosine_hemisphere(u2)
        pdf = torch.clamp(wi[:, 2], min=0.0) * INV_PI
        f = torch.where(((wo[:, 2] > 0) & (wi[:, 2] > 0))[:, None],
                        self.albedo[mat] * (INV_PI * torch.clamp(wi[:, 2], min=0.0))[:, None], 0.0)
        weight = torch.where((wo[:, 2] > 0)[:, None], f / torch.clamp(pdf, min=1e-12)[:, None], 0.0)
        pdf = torch.where(wo[:, 2] > 0, pdf, 0.0)
        if ROUGHCONDUCTOR in self.kinds:
            a = self.alpha[mat]
            m = _ggx_vndf(wo, a, u2)
            wi_c = 2.0 * dot(wo, m)[:, None] * m - wo
            f_c, p_c = self._conductor(mat, wo, wi_c)
            ok = (wo[:, 2] > 0) & (wi_c[:, 2] > 0) & (p_c > 0)
            w_c = torch.where(ok[:, None], f_c / torch.clamp(p_c, min=1e-12)[:, None], 0.0)
            rc = self.kind[mat] == ROUGHCONDUCTOR
            wi = torch.where(rc[:, None], wi_c, wi)
            weight = torch.where(rc[:, None], w_c, weight)
            pdf = torch.where(rc, torch.where(ok, p_c, 0.0), pdf)
        return _mulz(wi, s), weight, pdf

    def _conductor(self, mat, wo, wi):
        a = self.alpha[mat]
        m = wo + wi
        m = m / torch.clamp(torch.sqrt(dot(m, m)), min=1e-12)[:, None]
        d = _ggx_d(m, a)
        g = _ggx_g1(wo, m, a) * _ggx_g1(wi, m, a)
        F = _fresnel_conductor(dot(wo, m), self.cond_eta[mat], self.cond_k[mat])
        f = self.specular[mat] * F * (d * g / (4.0 * torch.clamp(wo[:, 2], min=1e-6)))[:, None]
        pdf_m = _ggx_g1(wo, m, a) * dot(wo, m).abs() * d / torch.clamp(wo[:, 2].abs(), min=1e-12)
        pdf = pdf_m / torch.clamp(4.0 * dot(wo, m).abs(), min=1e-8)
        valid = (wo[:, 2] > 0) & (wi[:, 2] > 0)
        return torch.where(valid[:, None], f, 0.0), torch.where(valid, pdf, 0.0)


def _mulz(v, s):
    return torch.cat([v[:, :2], v[:, 2:3] * s[:, None]], -1)


def _cosine_hemisphere(u):
    ox, oy = 2.0 * u[:, 0] - 1.0, 2.0 * u[:, 1] - 1.0
    zero = (ox == 0) & (oy == 0)
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, (math.pi / 4.0) * (oy / torch.where(ox == 0, 1.0, ox)),
                        (math.pi / 2.0) - (math.pi / 4.0) * (ox / torch.where(oy == 0, 1.0, oy)))
    r = torch.where(zero, 0.0, r)
    theta = torch.where(zero, 0.0, theta)
    x, y = r * torch.cos(theta), r * torch.sin(theta)
    return torch.stack([x, y, safe_sqrt(1.0 - x * x - y * y)], -1)


def _ggx_d(m, a):
    ct2 = m[:, 2] * m[:, 2]
    a2 = a * a
    e = (m[:, 0] ** 2 / torch.clamp(a2, min=1e-12) + m[:, 1] ** 2 / torch.clamp(a2, min=1e-12)) \
        / torch.clamp(ct2, min=1e-12)
    den = 1.0 + e
    d = 1.0 / torch.clamp(math.pi * a * a * ct2 * ct2 * den * den, min=1e-12)
    return torch.where(m[:, 2] > 0, d, 0.0)


def _ggx_g1(v, m, a):
    c2 = v[:, 2] * v[:, 2]
    tan2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-12)
    a2 = a * a     # isotropic: the projected roughness is alpha^2 at every azimuth
    g = 2.0 / (1.0 + torch.sqrt(1.0 + a2 * tan2))
    return torch.where(dot(v, m) * v[:, 2] > 0, g, 0.0)


def _ggx_vndf(wi, a, u):
    """A visible normal of the isotropic GGX distribution (Heitz 2018)."""
    sign = torch.sign(wi[:, 2])[:, None]
    w = wi * sign
    vh = torch.stack([a * w[:, 0], a * w[:, 1], w[:, 2]], -1)
    vh = vh / torch.clamp(torch.sqrt(dot(vh, vh)), min=1e-12)[:, None]
    lensq = vh[:, 0] ** 2 + vh[:, 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12))
    T1 = torch.where((lensq > 1e-9)[:, None],
                     torch.stack([-vh[:, 1] * inv, vh[:, 0] * inv, torch.zeros_like(inv)], -1),
                     torch.tensor([1.0, 0.0, 0.0], device=vh.device, dtype=vh.dtype).expand(vh.shape))
    T2 = cross(vh, T1)
    r = torch.sqrt(u[:, 0])
    phi = 2.0 * math.pi * u[:, 1]
    t1, t2 = r * torch.cos(phi), r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[:, 2])
    t2 = (1.0 - s) * safe_sqrt(1.0 - t1 * t1) + s * t2
    nh = T1 * t1[:, None] + T2 * t2[:, None] + vh * safe_sqrt(1.0 - t1 * t1 - t2 * t2)[:, None]
    m = torch.stack([a * nh[:, 0], a * nh[:, 1], torch.clamp(nh[:, 2], min=1e-6)], -1)
    return m / torch.clamp(torch.sqrt(dot(m, m)), min=1e-12)[:, None]


def _fresnel_conductor(cos_i, eta, k):
    c = cos_i.abs()[:, None]
    c2 = c * c
    s2 = 1.0 - c2
    e2, k2 = eta * eta, k * k
    t0 = e2 - k2 - s2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12)
    return 0.5 * (rp + rs)


def roulette(tp_max, depth, start):
    """The continuation probability at bounce `depth`."""
    return torch.clamp(tp_max, max=0.95) if depth >= start else torch.ones_like(tp_max)


def offset(p, n, w, eps):
    return p + n * torch.sign(dot(n, w))[:, None] * eps
