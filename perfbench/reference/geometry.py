"""Ray / triangle intersection for the reference: the watertight test of
Woop, Benthin and Wald (JCGT 2013), by brute force over a small triangle
table or through a linear BVH (Morton order, an implicit complete binary
tree of 4-triangle leaves) that the reference builds itself."""
from __future__ import annotations

import numpy as np
import torch

LEAF = 4
STACK = 64


def _shear(d):
    """Per ray the watertight test's projection rows (cx, cy, cz): 3
    coefficients each, so that cx . a = a[kx] - Sx a[kz], cy . a = a[ky] -
    Sy a[kz] and cz . a = Sz a[kz]."""
    ad = d.abs()
    kz = torch.where((ad[:, 0] >= ad[:, 1]) & (ad[:, 0] >= ad[:, 2]), 0,
                     torch.where(ad[:, 1] >= ad[:, 2], 1, 2))
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    dz = d.gather(1, kz[:, None])[:, 0]
    flip = dz < 0
    kx, ky = torch.where(flip, ky, kx), torch.where(flip, kx, ky)
    sx = d.gather(1, kx[:, None])[:, 0] / dz
    sy = d.gather(1, ky[:, None])[:, 0] / dz
    sz = 1.0 / dz
    ar = torch.arange(3, device=d.device)[None, :]
    one, zero = torch.ones_like(d), torch.zeros_like(d)
    cx = torch.where(ar == kx[:, None], one, torch.where(ar == kz[:, None], -sx[:, None], zero))
    cy = torch.where(ar == ky[:, None], one, torch.where(ar == kz[:, None], -sy[:, None], zero))
    cz = torch.where(ar == kz[:, None], sz[:, None], zero)
    return cx, cy, cz


def _edge(Ax, Ay, Bx, By):
    return Ax * By - Ay * Bx


def watertight(v, o, cx, cy, cz, t_min, t_max):
    """(t, hit) of rays against triangles: v (..., 9) vertex rows broadcast
    against the rays' (..., 3) origin and projection rows, t_min / t_max
    broadcasting likewise. A zero edge function is recomputed in float64."""
    def proj(k):
        a = [v[..., 3 * k + i] - o[..., i] for i in range(3)]
        return tuple(c[..., 0] * a[0] + c[..., 1] * a[1] + c[..., 2] * a[2] for c in (cx, cy, cz))

    (Ax, Ay, Az), (Bx, By, Bz), (Cx, Cy, Cz) = proj(0), proj(1), proj(2)
    U, V, W = _edge(Cx, Cy, Bx, By), _edge(Ax, Ay, Cx, Cy), _edge(Bx, By, Ax, Ay)
    Us, Vs, Ws = U, V, W           # the signs that decide; t takes the unrounded U, V, W
    zero = (U == 0) | (V == 0) | (W == 0)
    if bool(zero.any()):
        sel = lambda x: x[zero].double()  # noqa: E731
        Us, Vs, Ws = U.clone(), V.clone(), W.clone()
        Us[zero] = torch.sign(_edge(sel(Cx), sel(Cy), sel(Bx), sel(By))).to(U.dtype)
        Vs[zero] = torch.sign(_edge(sel(Ax), sel(Ay), sel(Cx), sel(Cy))).to(U.dtype)
        Ws[zero] = torch.sign(_edge(sel(Bx), sel(By), sel(Ax), sel(Ay))).to(U.dtype)
    inside = ((Us >= 0) & (Vs >= 0) & (Ws >= 0)) | ((Us <= 0) & (Vs <= 0) & (Ws <= 0))
    inside = inside & ((Us != 0) | (Vs != 0) | (Ws != 0))
    det = U + V + W
    t = (U * Az + V * Bz + W * Cz) / torch.where(det == 0, 1.0, det)
    hit = inside & (det != 0) & (t > t_min) & (t < t_max) & torch.isfinite(t)
    return t, hit


class Triangles:
    """The scene's triangles as (T, 9) vertex rows on a device, with the
    LBVH when there are more than `dense_max` of them."""

    def __init__(self, vertices: np.ndarray, device, dtype=torch.float32, dense_max=4096):
        self.T = vertices.shape[0]
        self.v = torch.from_numpy(vertices.reshape(-1, 9)).to(device=device, dtype=dtype)
        self.bvh = None if self.T <= dense_max else _LBVH(vertices, device, dtype)

    def intersect(self, o, d, t_min, t_max, any_hit=False, chunk=1 << 21):
        """(t (B,), prim (B,) int64, -1 on a miss) of the closest (or any)
        hit in (t_min, t_max); t_max is a float or a (B,) tensor."""
        B = o.shape[0]
        t_max = torch.as_tensor(t_max, dtype=o.dtype, device=o.device).expand(B)
        if self.bvh is not None:
            return self.bvh.intersect(self.v, o, d, t_min, t_max, any_hit)
        cx, cy, cz = _shear(d)
        ts, ps = [], []
        step = max(1, chunk // max(self.T, 1))
        for s in range(0, B, step):
            sl = slice(s, s + step)
            t, hit = watertight(self.v[None], o[sl, None], cx[sl, None], cy[sl, None],
                                cz[sl, None], t_min, t_max[sl, None])
            tt = torch.where(hit, t, torch.inf)
            best = tt.argmin(1)
            tb = tt.gather(1, best[:, None])[:, 0]
            found = torch.isfinite(tb)
            ts.append(torch.where(found, tb, t_max[sl]))
            ps.append(torch.where(found, best, -1))
        return torch.cat(ts), torch.cat(ps)


def _morton(c):
    """30-bit Morton codes of (N, 3) points in [0, 1]."""
    q = np.clip((c * 1024.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


class _LBVH:
    """Triangles sorted by the Morton code of their centroid, LEAF to a leaf,
    leaves padded to a power of two; node i's children are 2i+1 and 2i+2,
    leaf j is node n_inner + j. Boxes are built bottom-up on the host."""

    def __init__(self, vertices, device, dtype):
        T = vertices.shape[0]
        cen = vertices.mean(axis=1).astype(np.float64)
        lo, hi = cen.min(0), cen.max(0)
        order = np.argsort(_morton((cen - lo) / np.maximum(hi - lo, 1e-12)), kind="stable")
        n_leaf = 1 << int(np.ceil(np.log2(max(1, -(-T // LEAF)))))
        prims = np.full(n_leaf * LEAF, -1, np.int64)
        prims[:T] = order
        vmin = vertices.min(axis=1)
        vmax = vertices.max(axis=1)
        pmin = np.where(prims[:, None] >= 0, vmin[np.maximum(prims, 0)], np.inf)
        pmax = np.where(prims[:, None] >= 0, vmax[np.maximum(prims, 0)], -np.inf)
        levels_lo = [pmin.reshape(n_leaf, LEAF, 3).min(1)]
        levels_hi = [pmax.reshape(n_leaf, LEAF, 3).max(1)]
        while levels_lo[-1].shape[0] > 1:
            levels_lo.append(levels_lo[-1].reshape(-1, 2, 3).min(1))
            levels_hi.append(levels_hi[-1].reshape(-1, 2, 3).max(1))
        box_lo = np.concatenate(levels_lo[::-1])
        box_hi = np.concatenate(levels_hi[::-1])
        self.n_inner = n_leaf - 1
        valid = np.isfinite(box_lo).all(1)
        box_lo = np.where(valid[:, None], box_lo, 0.0)
        box_hi = np.where(valid[:, None], box_hi, 0.0)
        f = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
        self.lo = f(box_lo.astype(np.float32)).to(dtype)
        self.hi = f(box_hi.astype(np.float32)).to(dtype)
        self.valid = f(valid)
        self.prims = f(prims.reshape(n_leaf, LEAF))

    def _slab(self, node, o, inv, t_min, t_max):
        t0 = (self.lo[node] - o) * inv
        t1 = (self.hi[node] - o) * inv
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        ok = (torch.clamp(near, min=t_min) <= torch.minimum(far, t_max)) & self.valid[node]
        return ok, near

    def intersect(self, v, o, d, t_min, t_max, any_hit):
        """Lockstep stack walks, nearer child first; each step computes only
        the rays still walking."""
        B, dev = o.shape[0], o.device
        cx, cy, cz = _shear(d)
        inv = 1.0 / torch.where(d.abs() < 1e-12, torch.where(d < 0, -1e-12, 1e-12), d)
        best_t = t_max.clone()
        best_p = torch.full((B,), -1, dtype=torch.int64, device=dev)
        stack = torch.zeros(B, STACK, dtype=torch.int64, device=dev)
        sp = torch.ones(B, dtype=torch.int64, device=dev)
        live = torch.arange(B, device=dev)
        while live.numel() > 0:
            r = live
            top = sp[r] - 1
            node = stack[r, top]
            sp[r] = top
            leaf = node >= self.n_inner
            # leaves: test their LEAF triangles against the ray's current t
            li = r[leaf]
            if li.numel() > 0:
                pr = self.prims[node[leaf] - self.n_inner]            # (n, LEAF)
                vv = v[pr.clamp(min=0)]                                # (n, LEAF, 9)
                t, hit = watertight(vv, o[li, None], cx[li, None], cy[li, None], cz[li, None],
                                    t_min, best_t[li, None])
                hit = hit & (pr >= 0)
                tt = torch.where(hit, t, torch.inf)
                k = tt.argmin(1)
                tk = tt.gather(1, k[:, None])[:, 0]
                upd = torch.isfinite(tk)
                best_t[li] = torch.where(upd, tk, best_t[li])
                best_p[li] = torch.where(upd, pr.gather(1, k[:, None])[:, 0], best_p[li])
                if any_hit:
                    sp[li] = torch.where(upd, 0, sp[li])
            # inner nodes: push the hit children, the nearer on top
            ii, nn = r[~leaf], node[~leaf]
            if ii.numel() > 0:
                c1, c2 = 2 * nn + 1, 2 * nn + 2
                ok1, n1 = self._slab(c1, o[ii], inv[ii], t_min, best_t[ii])
                ok2, n2 = self._slab(c2, o[ii], inv[ii], t_min, best_t[ii])
                first_near = n1 <= n2
                far_c = torch.where(first_near, c2, c1)
                near_c = torch.where(first_near, c1, c2)
                far_ok = torch.where(first_near, ok2, ok1)
                near_ok = torch.where(first_near, ok1, ok2)
                s = sp[ii]
                stack[ii, s.clamp(max=STACK - 1)] = torch.where(far_ok, far_c, stack[ii, s.clamp(max=STACK - 1)])
                s = s + far_ok.long()
                stack[ii, s.clamp(max=STACK - 1)] = torch.where(near_ok, near_c, stack[ii, s.clamp(max=STACK - 1)])
                sp[ii] = s + near_ok.long()
            live = r[sp[r] > 0]
        return best_t, best_p
