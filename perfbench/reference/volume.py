"""The volumetric path tracer the plume cells are held to: each bounce
intersects the surfaces, then samples a medium event along [eps, t_surface]
by delta tracking under the ray's majorant; a lane that scatters in the
medium does next-event estimation with the Henyey-Greenstein phase function
and samples it, any other lane shades the surface. Shadow rays are weighted
by the transmittance along them (32 midpoint steps of the trilinearly
interpolated grid). The decisions' pdfs are detached, the transmittance and
the scattering coefficient stay attached, so the render is differentiable in
the grid and the two coefficient triples.

Every tracking trip draws two numbers in every lane, and the trips go on
until no lane tracks; so a lane's later numbers depend on the trip count T
of the slowest lane of the whole batch, and a pass replays whole: the
reference tracks every lane of the pass, and computes the rest in blocks of
lanes."""
from __future__ import annotations

import math

import numpy as np
import torch

from .common import RefScene, mis, normalize, offset, onb, roulette, safe_sqrt, to_local, to_world
from .sampler import GOLDEN, MASK, pcg_hash

TAU_STEPS = 32
TRACK_CAP = 256
INV_FOURPI = 1.0 / (4.0 * math.pi)


class RefMedium:
    """One grid volume: the box, the base coefficients (1, 3), the flat grid
    (a dummy 1.0 in slot 0, the grid from slot 1, x-major) and its
    resolution, the majorant's grid maximum, the phase function's g."""

    def __init__(self, rec: dict, device, dtype=torch.float32, params=None):
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)  # noqa: E731
        dens = np.asarray(rec["density"], np.float32)
        self.res = dens.shape
        self.lo, self.hi = f(rec["box_min"]), f(rec["box_max"])
        self.maj_grid = float(dens.max(initial=0.0))
        if params is None:
            params = dict(grid_data=np.concatenate([np.ones(1, np.float32), dens.reshape(-1)]),
                          sigma_a=[rec["sigma_a"]], sigma_s=[rec["sigma_s"]])
        self.grid = params["grid_data"] if torch.is_tensor(params["grid_data"]) else f(params["grid_data"])
        self.sigma_a = params["sigma_a"] if torch.is_tensor(params["sigma_a"]) else f(params["sigma_a"])
        self.sigma_s = params["sigma_s"] if torch.is_tensor(params["sigma_s"]) else f(params["sigma_s"])
        if rec["phase"] != "hg":
            raise ValueError(f"phase {rec['phase']}: the reference has Henyey-Greenstein")
        self.g = f(rec["g"])

    def density(self, p):
        """Trilinear density at points p (..., 3), x, then y, then z."""
        r = torch.tensor(self.res, device=p.device)
        rf = r.to(p.dtype)
        q = (p - self.lo) / torch.clamp(self.hi - self.lo, min=1e-9) * (rf - 1)
        q = torch.minimum(torch.clamp(q, min=0.0), torch.clamp(rf - 1, min=0.0) * (1 - 1e-6))
        i0 = torch.floor(q).long()
        f = q - i0
        i1 = torch.minimum(i0 + 1, r - 1)
        ry, rz = self.res[1], self.res[2]

        def at(ix, iy, iz):
            return self.grid[1 + (ix * ry + iy) * rz + iz]

        fx, fy, fz = f.unbind(-1)
        (x0, y0, z0), (x1, y1, z1) = i0.unbind(-1), i1.unbind(-1)
        lx = lambda y, z: at(x0, y, z) * (1 - fx) + at(x1, y, z) * fx  # noqa: E731
        c00, c10, c01, c11 = lx(y0, z0), lx(y1, z0), lx(y0, z1), lx(y1, z1)
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        return c0 * (1 - fz) + c1 * fz

    def inside(self, p):
        return ((p >= self.lo) & (p <= self.hi)).all(-1)

    def sigmas(self, p):
        """(sigma_s, sigma_t) (..., 3) at p."""
        D = self.density(p)[..., None]
        ins = self.inside(p)[..., None]
        base_t = self.sigma_s[0] + self.sigma_a[0]
        return torch.where(ins, self.sigma_s[0] * D, 0.0), torch.where(ins, base_t * D, 0.0)

    def box(self, o, d, t_min, t_max):
        inv = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
        t0, t1 = (self.lo - o) * inv, (self.hi - o) * inv
        near = torch.clamp(torch.minimum(t0, t1).amax(-1), min=t_min)
        far = torch.minimum(torch.maximum(t0, t1).amin(-1), t_max)
        return near, far, near < far

    def transmittance(self, o, d, t_min, t_max, block):
        """(B, 3) transmittance over [t_min, t_max], in blocks of lanes."""
        out = []
        i = torch.arange(TAU_STEPS, dtype=o.dtype, device=o.device)
        for s in range(0, o.shape[0], block):
            sl = slice(s, s + block)
            near, far, hit = self.box(o[sl], d[sl], t_min, t_max[sl])
            dt = torch.clamp(far - near, min=0.0) / TAU_STEPS
            t = near[:, None] + (i + 0.5) * dt[:, None]
            vals = self.density(o[sl, None, :] + d[sl, None, :] * t[..., None])
            acc = torch.zeros_like(near)
            for col in vals.unbind(1):
                acc = acc + col
            tau = (self.sigma_a[0] + self.sigma_s[0]) * (acc * dt)[:, None]
            out.append(torch.where(hit[:, None], torch.exp(-tau), 1.0))
        return torch.cat(out)

    def hg(self, cos_t):
        g = self.g
        den = 1.0 + g * g - 2.0 * g * cos_t
        return INV_FOURPI * (1.0 - g * g) / torch.clamp(den * safe_sqrt(den), min=1e-8)

    def sample_hg(self, wo, u):
        g = self.g
        sq = (1.0 - g * g) / (1.0 + g * (2.0 * u[:, 0] - 1.0))
        ct = torch.clamp((1.0 + g * g - sq * sq) / (2.0 * g), -1.0, 1.0)
        stt = safe_sqrt(1.0 - ct * ct)
        phi = 2.0 * math.pi * u[:, 1]
        n = normalize(-wo)
        s, t = onb(n)
        wi = to_world(s, t, n, torch.stack([stt * torch.cos(phi), stt * torch.sin(phi), ct], -1))
        p = self.hg((-wo * wi).sum(-1))
        return wi, p / torch.clamp(p, min=1e-12), p


def _unit(state, dtype):
    return (pcg_hash(state) >> 8).to(dtype) * (1.0 / 16777216.0)


@torch.no_grad()
def _track(med: RefMedium, o, d, u_near, u_far, maj, tracking, state):
    """Delta tracking of every lane until none tracks: (t, real, T)."""
    t, real = u_near.clone(), torch.zeros_like(tracking)
    T = 0
    while T < TRACK_CAP and bool(tracking.any()):
        T += 1
        state = (state + GOLDEN) & MASK
        u = _unit(state, o.dtype)
        t_new = t + (-torch.log(torch.clamp(1.0 - u, min=1e-12)) / maj)
        esc = tracking & (t_new >= u_far)
        p = o + d * torch.where(tracking, t_new, t)[:, None]
        ratio = torch.clamp(med.sigmas(p)[1].mean(-1) / maj, 0.0, 1.0)
        state = (state + GOLDEN) & MASK
        u2 = _unit(state, o.dtype)
        go = tracking & ~esc
        real_now = go & (u2 < ratio)
        t = torch.where(go, t_new, t)
        tracking = go & ~real_now
        real = real | real_now
    return t, real, T


def radiance(sc: RefScene, med: RefMedium, o, d, st, block):
    B, dev, dt = o.shape[0], o.device, sc.dtype
    tp = torch.ones(B, 3, device=dev, dtype=dt)
    L = torch.zeros(B, 3, device=dev, dtype=dt)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(B, device=dev, dtype=dt)
    prev_delta = torch.ones(B, dtype=torch.bool, device=dev)
    for depth in range(sc.max_depth):
        t, prim = sc.tris.intersect(o, d, 1e-4, torch.inf)
        valid, p, n_geo, mat = sc.hit_frame(o, d, t, prim)
        found = valid & active
        t_surf = torch.where(valid, t, 1e8)
        # ---- the medium event: delta tracking under the ray's majorant ----
        near, far, in_vol = med.box(o, d, sc.eps, t_surf)
        maj = (med.sigma_a[0].mean() * med.maj_grid + med.sigma_s[0].mean() * med.maj_grid)
        maj = torch.clamp(torch.where(in_vol, maj.detach(), 0.0), min=1e-6)
        t_trk, real, T = _track(med, o, d, torch.where(in_vol, near, 0.0),
                                torch.where(in_vol, far, 0.0), maj, in_vol, st.state)
        st.skip(2 * T)
        scat = in_vol & real
        t_far = torch.clamp(t_surf, max=1e7)
        t_s = torch.where(scat, t_trk, t_far)
        p_s = o + d * t_s[:, None]
        tr = torch.where(in_vol[:, None], med.transmittance(o, d, sc.eps, t_s, block), 1.0)
        tr_mean = torch.exp(torch.log(torch.clamp(tr, min=1e-30)).detach().mean(-1))
        ss_p, st_p = med.sigmas(p_s)
        pdf = torch.where(scat, torch.clamp(st_p.mean(-1), min=1e-9).detach() * tr_mean, tr_mean)
        inv_pdf = (1.0 / torch.clamp(pdf, min=1e-12))[:, None]
        w_med = torch.where(scat[:, None], ss_p * tr * inv_pdf, tr * inv_pdf)
        w_med = torch.where(in_vol[:, None], w_med, 1.0)
        st.next(1)                                   # the volume choice (one volume)
        tp0, tp = tp, tp * torch.where(active[:, None], w_med, 1.0)
        me = active & scat
        me3 = me[:, None]
        L = L + torch.where((found & ~scat)[:, None],
                            tp * sc.emitted(mat, valid, n_geo, d, o, p, prev_pdf, prev_delta), 0.0)
        # ---- next-event estimation from the medium point or the surface ----
        s, tt = sc.uv_frame(prim, n_geo)   # the volume engine shades in the uv chart's frame
        wo_w = -d
        wo = to_local(s, tt, n_geo, wo_w)
        nee_p = torch.where(me3, p_s, p)
        u = st.next(3)
        dl, dist, pdf_l, rad = sc.sample_light(nee_p, u[:, 1:3])
        f_s, pdf_b = sc.bsdf_eval(mat, wo, to_local(s, tt, n_geo, dl))
        ph = med.hg((-wo_w * dl).sum(-1))
        f_val = torch.where(me3, ph[:, None], f_s)
        pdf_fwd = torch.where(me, ph, pdf_b)
        sh_o = torch.where(me3, nee_p, offset(p, n_geo, dl, sc.eps))
        t_sh = dist - 2.0 * sc.eps
        _, blk = sc.tris.intersect(sh_o, dl, sc.eps, t_sh, any_hit=True)
        tr_sh = med.transmittance(sh_o, dl, sc.eps, t_sh, block)
        w = mis(pdf_l, pdf_fwd) / torch.clamp(pdf_l, min=1e-12)
        ok = (found | me) & (blk < 0) & (pdf_l > 0)
        L = L + torch.where(ok[:, None], tp * f_val * rad * tr_sh * w[:, None], 0.0)
        # ---- continue: phase sample or BSDF sample, then roulette ----
        u = st.next(5)
        wi_ph, w_ph, pdf_ph = med.sample_hg(wo_w, u[:, 0:2])
        wi_b, w_b, pdf_bs = sc.bsdf_sample(mat, wo, u[:, 2:4])
        wi_sf = to_world(s, tt, n_geo, wi_b)
        new_d = torch.where(me3, wi_ph, wi_sf)
        new_o = torch.where(me3, p_s, offset(p, n_geo, wi_sf, sc.eps))
        new_pdf = torch.where(me, pdf_ph, pdf_bs)
        new_tp = tp * torch.where(me3, w_ph[:, None], w_b)
        cont = (found | me) & (new_pdf > 0) & (new_tp.abs().amax(-1) > 0)
        u_rr = st.next(1)[:, 0]
        p_c = roulette(new_tp.amax(-1), depth, sc.rr_start).detach()
        cont = cont & (u_rr < p_c)
        new_tp = new_tp / torch.clamp(p_c, min=1e-6)[:, None]
        c3 = cont[:, None]
        o = torch.where(c3, new_o, o).detach()
        d = torch.where(c3, new_d, d).detach()
        tp = torch.where(c3, new_tp, tp0)
        prev_pdf = torch.where(cont, new_pdf, prev_pdf).detach()
        prev_delta = torch.where(cont, False, prev_delta)
        active = cont
    return L


def render(sc: RefScene, med: RefMedium, width: int, height: int, spp: int, seed: int,
           block: int = 1 << 18):
    """(H, W, 3): one pass of `seed`, every pixel; differentiable in the
    medium's tensors that require grad."""
    n_px = width * height
    pix = torch.arange(n_px, device=sc.device).repeat(spp)
    smp = torch.arange(spp, device=sc.device).repeat_interleave(n_px)
    o, d, st = sc.camera_rays(pix, smp, width, height, seed)
    L = torch.nan_to_num(radiance(sc, med, o, d, st, block), nan=0.0, posinf=0.0, neginf=0.0)
    return (L.reshape(spp, n_px, 3).sum(0) / spp).reshape(height, width, 3)
