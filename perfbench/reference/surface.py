"""The surface path tracer the bigscene cell is held to: unidirectional
paths with next-event estimation of the area light, MIS against BSDF
sampling, and Russian roulette, one pass of `spp` jittered pinhole samples
a pixel averaged into the pixel (a box filter). A lane's numbers come from
its own stream (seed, pixel, sample), six a bounce (light choice, light
point, BSDF pair, BSDF lobe, roulette), so any subset of pixels replays
alone."""
from __future__ import annotations

import torch

from .common import RefScene, mis, offset, onb, roulette, to_local, to_world


def radiance(sc: RefScene, o, d, st):
    B = o.shape[0]
    dt = sc.dtype
    tp = torch.ones(B, 3, device=o.device, dtype=dt)
    L = torch.zeros(B, 3, device=o.device, dtype=dt)
    active = torch.ones(B, dtype=torch.bool, device=o.device)
    prev_pdf = torch.zeros(B, device=o.device, dtype=dt)
    prev_delta = torch.ones(B, dtype=torch.bool, device=o.device)
    for depth in range(sc.max_depth):
        t, prim = sc.tris.intersect(o, d, 1e-4, torch.inf)
        valid, p, n_geo, mat = sc.hit_frame(o, d, t, prim)
        found = valid & active
        L = L + torch.where(found[:, None],
                            tp * sc.emitted(mat, valid, n_geo, d, o, p, prev_pdf, prev_delta), 0.0)
        s, tt = onb(n_geo)
        wo = to_local(s, tt, n_geo, -d)
        u = st.next(6)           # light choice, light point (2), BSDF (2), lobe
        dl, dist, pdf_l, rad = sc.sample_light(p, u[:, 1:3])
        f_l, pdf_b = sc.bsdf_eval(mat, wo, to_local(s, tt, n_geo, dl))
        sh_t, sh_p = sc.tris.intersect(offset(p, n_geo, dl, sc.eps), dl, sc.eps,
                                       dist - 2.0 * sc.eps, any_hit=True)
        w = mis(pdf_l, pdf_b) / torch.clamp(pdf_l, min=1e-12)
        ok = found & (sh_p < 0) & (pdf_l > 0)
        L = L + torch.where(ok[:, None], tp * f_l * rad * w[:, None], 0.0)
        wi, weight, pdf = sc.bsdf_sample(mat, wo, u[:, 3:5])
        wi_w = to_world(s, tt, n_geo, wi)
        new_o = offset(p, n_geo, wi_w, sc.eps)
        new_tp = tp * weight
        cont = found & (pdf > 0) & (new_tp.abs().amax(-1) > 0)
        u_rr = st.next(1)[:, 0]
        p_c = roulette(new_tp.amax(-1), depth, sc.rr_start)
        new_tp = new_tp / torch.clamp(p_c, min=1e-6)[:, None]
        cont = cont & (u_rr < p_c)
        c3 = cont[:, None]
        o = torch.where(c3, new_o, o)
        d = torch.where(c3, wi_w, d)
        tp = torch.where(c3, new_tp, tp)
        prev_pdf = torch.where(cont, pdf, prev_pdf)
        prev_delta = torch.where(cont, False, prev_delta)
        active = cont
    return L


@torch.no_grad()
def render_pixels(sc: RefScene, pixel_ids, width: int, height: int, spp: int, seed: int,
                  block: int = 1 << 18):
    """(P, 3): the pass of `seed` at the given pixel ids, in blocks of
    `block` lanes."""
    P = pixel_ids.shape[0]
    pix = pixel_ids.repeat(spp)
    smp = torch.arange(spp, device=pix.device).repeat_interleave(P)
    out = []
    for s in range(0, pix.shape[0], block):
        o, d, st = sc.camera_rays(pix[s:s + block], smp[s:s + block], width, height, seed)
        out.append(torch.nan_to_num(radiance(sc, o, d, st), nan=0.0, posinf=0.0, neginf=0.0))
    L = torch.cat(out)
    return L.reshape(spp, P, 3).sum(0) / spp
