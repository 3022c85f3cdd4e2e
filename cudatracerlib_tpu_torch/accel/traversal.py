"""Ray-triangle intersection and the intersector dispatch
(port of cudatracerlib_tpu/accel/traversal.py: Hit, intersect_woop,
intersect, intersect_brute_force, refine_hit, intersect_auto, occluded).

Whether a ray crosses a triangle is decided by the watertight edge test of
Woop, Benthin and Wald (JCGT 2013) on the triangle's vertex rows
(`BVH.tri_verts`), and t, u, v are the Woop rows', as in the JAX package.
The JAX package decides with the Woop rows' u, v, which two triangles round
apart: a ray on a quad's shared diagonal can fail `u + v <= 1` in both and
pass through a closed wall. The port deliberately differs from it there.

Scenes up to DENSE_MAX_TRIS padded triangles go through the dense
intersector (ops/intersect_dense.py), larger ones through the BVH stack walk
(ops/intersect_bvh.py); each runs its CUDA kernel on the card and its plain
version on the CPU. `intersect` is the lockstep stack walk of the JAX
package and the plain version of the BVH kernel. The intersectors run on
detached inputs, as in the JAX package (traversal.py:267-297); `refine_hit`
passes their t/u/v through unchanged and gives them the gradient of the
closed-form Woop re-evaluation with respect to the Woop rows and the ray
(the JAX custom_jvp `_refine_passthrough`, traversal.py:208-255).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.timing import read_bool, spanned

DENSE_MAX_TRIS = 4096
STACK_DEPTH = 48
DONE = -(2 ** 30)   # lane finished
LEAF_SIZE = 4
_CHUNK_ELEMS = {"cpu": 1 << 21}  # (rays x triangles) per brute-force chunk
_CHUNK_ELEMS_DEFAULT = 1 << 25


class Hit(NamedTuple):
    """SoA hit record (reference `traversalResult`)."""

    t: torch.Tensor      # (B,) hit distance (= t_max if miss)
    prim: torch.Tensor   # (B,) int32 padded-triangle index into bvh.woop order, -1 if miss
    bary: torch.Tensor   # (B, 2) barycentric (u, v) of the hit
    valid: torch.Tensor  # (B,) bool


def _shear(d):
    """The watertight test's per-ray frame (Woop, Benthin and Wald, JCGT
    2013), on the 3 components of d: kz the axis of the largest |d[k]| (the
    first on a tie), kx and ky the next two in cyclic order, swapped where
    d[kz] < 0, Sx = d[kx] / d[kz] and Sy = d[ky] / d[kz]. Returns the two
    rows (cx, cy) of the shear, 3 coefficients each: 1 at kx (ky), -Sx (-Sy)
    at kz, 0 at the third axis, so that cx . a is the paper's a[kx] - Sx a[kz]
    (products with 1 and 0 are exact)."""
    ax, ay, az = (c.abs() for c in d)
    kz = torch.where((ax >= ay) & (ax >= az), 0, torch.where(ay >= az, 1, 2))
    kx = torch.where(kz == 2, 0, kz + 1)
    ky = torch.where(kx == 2, 0, kx + 1)

    def pick(k):
        return torch.where(k == 0, d[0], torch.where(k == 1, d[1], d[2]))

    dz = pick(kz)
    flip = dz < 0
    kx, ky = torch.where(flip, ky, kx), torch.where(flip, kx, ky)
    sx, sy = pick(kx) / dz, pick(ky) / dz
    cx = [torch.where(kx == c, 1.0, torch.where(kz == c, -sx, 0.0)) for c in range(3)]
    cy = [torch.where(ky == c, 1.0, torch.where(kz == c, -sy, 0.0)) for c in range(3)]
    return cx, cy


def _edge_functions(p, o, cx, cy):
    """The three edge functions U, V, W of the sheared triangle; p is the 12
    components of a vertex row (`accel/bvh.vertex_rows`), o the ray origin's
    3. Each vertex is translated by -o and sheared, ((c0 a0 + c1 a1) + c2 a2);
    U = Cx By - Cy Bx, V = Ax Cy - Ay Cx, W = Bx Ay - By Ax. Two triangles
    that share an edge share its sheared vertices, so the edge's function is
    the same number in both, or its exact negative."""
    def project(v):
        a = [v[k] - o[k] for k in range(3)]
        return (cx[0] * a[0] + cx[1] * a[1] + cx[2] * a[2],
                cy[0] * a[0] + cy[1] * a[1] + cy[2] * a[2])

    (Ax, Ay), (Bx, By), (Cx, Cy) = project(p[0:3]), project(p[4:7]), project(p[8:11])
    return (Ax, Ay, Bx, By, Cx, Cy), (Cx * By - Cy * Bx, Ax * Cy - Ay * Cx, Bx * Ay - By * Ax)


def _watertight(p, o, d, need):
    """Whether each ray crosses its row's triangle: the watertight test's
    decision with the paper's double-precision fallback. A float32 edge
    function that is not zero has the sign of the exact one (each product is
    rounded the same way); one that is zero is recomputed in float64, where
    the products of float32 values are exact. So the signs are exact, and a
    ray that crosses an edge two triangles share is inside one of them, or
    on the edge of both. Inside means no two signs are opposite and not all
    three are zero (a triangle seen edge-on). `need` masks the lanes whose
    decision is read (the fallback runs only on those)."""
    cx, cy = _shear(d)
    xy, (U, V, W) = _edge_functions(p, o, cx, cy)
    zero = ((U == 0) | (V == 0) | (W == 0)) & need
    if read_bool("traversal.watertight", zero.any()):
        Ax, Ay, Bx, By, Cx, Cy = (torch.broadcast_to(c, zero.shape)[zero].double() for c in xy)
        U, V, W = (torch.broadcast_to(x, zero.shape).clone() for x in (U, V, W))
        U[zero] = torch.sign(Cx * By - Cy * Bx).float()
        V[zero] = torch.sign(Ax * Cy - Ay * Cx).float()
        W[zero] = torch.sign(Bx * Ay - By * Ax).float()
    inside = ((U >= 0) & (V >= 0) & (W >= 0)) | ((U <= 0) & (V <= 0) & (W <= 0))
    return inside & ((U != 0) | (V != 0) | (W != 0))


def woop_tuv(r, o, d):
    """t, u, v of the Woop rows on components: r is 12 broadcastable tensors
    (rows u, v, w of the Woop matrix), o and d 3 each."""
    oz = r[8] * o[0] + r[9] * o[1] + r[10] * o[2] + r[11]
    dz = r[8] * d[0] + r[9] * d[1] + r[10] * d[2]
    inv_dz = 1.0 / torch.where(dz.abs() < 1e-20, 1e-20, dz)
    t = -oz * inv_dz
    u = r[0] * o[0] + r[1] * o[1] + r[2] * o[2] + r[3] + t * (r[0] * d[0] + r[1] * d[1] + r[2] * d[2])
    v = r[4] * o[0] + r[5] * o[1] + r[6] * o[2] + r[7] + t * (r[4] * d[0] + r[5] * d[1] + r[6] * d[2])
    return t, u, v


def _woop_test(r, p, o, d, t_min, t_max):
    """Ray / triangle test on components: r is 12 broadcastable tensors (rows
    u, v, w of the Woop matrix), p the 12 of the vertex row, o and d 3 each.
    t, u and v are the Woop rows' (what `refine_hit` differentiates); whether
    the ray crosses the triangle is the watertight edge test's, so that no
    ray slips between two triangles that share an edge (the Woop test's
    u >= 0, v >= 0, u + v <= 1 rounds each triangle's u and v on its own,
    and both could reject a ray on their shared diagonal)."""
    t, u, v = woop_tuv(r, o, d)
    t_ok = (t > t_min) & (t < t_max) & torch.isfinite(t)
    return t, u, v, t_ok & _watertight(p, o, d, t_ok)


def intersect_woop(woop_rows, o, d, t_min, t_max, verts):
    """Ray / triangle test, broadcast over leading dims.

    woop_rows: (..., 12); verts: their (..., 12) vertex rows
    (`accel/bvh.vertex_rows`); o, d: (..., 3). Returns (t, u, v, hit_mask)."""
    return _woop_test(woop_rows.unbind(-1), verts.unbind(-1), o.unbind(-1), d.unbind(-1),
                      t_min, t_max)


def intersect_brute_force(woop, o, d, t_min=1e-4, t_max=torch.inf, *, verts) -> Hit:
    """O(B*T) all-triangles closest hit over a (T, 12) woop table and its
    (T, 12) vertex rows (`accel/bvh.vertex_rows`); the lowest triangle index
    wins a tie. Rays are swept in chunks so the (rays,
    triangles) temporaries stay bounded."""
    B, T = o.shape[0], woop.shape[0]
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=o.device).expand(B)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(B)
    if B == 0:
        empty = torch.empty(0, device=o.device)
        return Hit(t=empty, prim=empty.to(torch.int32), bary=empty.reshape(0, 2),
                   valid=empty.to(torch.bool))
    # contiguous columns: the (chunk, T) products then read unit-stride rows
    r = [c[None, :] for c in woop.t().contiguous()]
    p = [c[None, :] for c in verts.t().contiguous()]
    oc, dc = o.t().contiguous(), d.t().contiguous()
    chunk = max(1, _CHUNK_ELEMS.get(o.device.type, _CHUNK_ELEMS_DEFAULT) // max(T, 1))
    out_t, out_p, out_b = [], [], []
    for s in range(0, B, chunk):
        sl = slice(s, s + chunk)
        t, u, v, h = _woop_test(r, p, [x[sl, None] for x in oc], [x[sl, None] for x in dc],
                                t_min[sl, None], t_max[sl, None])
        best = torch.where(h, t, torch.inf).argmin(-1, keepdim=True)
        hit_any = h.any(-1)
        out_t.append(torch.where(hit_any, t.gather(-1, best)[:, 0], t_max[sl]))
        out_p.append(torch.where(hit_any, best[:, 0].to(torch.int32), -1))
        out_b.append(torch.cat([u.gather(-1, best), v.gather(-1, best)], -1))
    prim = torch.cat(out_p)
    return Hit(t=torch.cat(out_t), prim=prim, bary=torch.cat(out_b), valid=prim >= 0)


def _slab_test(lo, hi, o, inv_d, t_min, t_max):
    """AABB slab test. lo/hi: (n, 3). Returns (hit, t_near)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    return torch.maximum(near, t_min) <= torch.minimum(far, t_max), near


def intersect(bvh, o, d, t_min=1e-4, t_max=torch.inf, any_hit: bool = False,
              max_steps: int = 100_000, with_counts: bool = False,
              with_overflow: bool = False):
    """The JAX package's lockstep BVH stack walk: every lane keeps a
    STACK_DEPTH stack, descends to the nearer child it hits (the ordering
    rule below), pushes the farther one when both are hit, and tests the
    LEAF_SIZE Woop rows of a leaf against its current t (strict `t < t_hit`;
    within a leaf the lowest row wins a tie). A push on a full stack writes
    the top entry, as the JAX clamped scatter does. Any-hit lanes stop after
    their first leaf with a hit; no lane takes more than `max_steps` steps.

    Lanes are independent, so each step computes only the lanes still
    walking; the result is the JAX oracle's lane for lane. With
    `with_counts` it also returns per-ray counts (int64) of the work the
    walk did: inner-node visits, leaf visits, and leaf rows whose t passed
    the t test (the rows whose u, v the CUDA kernel goes on to compute).
    With `with_overflow` the last element returned is each ray's count
    (int64) of pushes onto a full stack, each of which loses the subtree
    in the top entry."""
    B, dev = o.shape[0], o.device
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(B)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(B)
    inv_d = 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    nodes, woop, verts = bvh.nodes, bvh.woop, bvh.tri_verts
    codes = nodes[:, 12:14].contiguous().view(torch.int32)
    n_rows = woop.shape[0]
    leaf_offsets = torch.arange(LEAF_SIZE, device=dev)

    out_t, out_prim = t_max.clone(), torch.full((B,), -1, dtype=torch.int32, device=dev)
    out_bary = torch.zeros(B, 2, device=dev)
    out_inner = torch.zeros(B, dtype=torch.int64, device=dev)
    out_leaf = torch.zeros(B, dtype=torch.int64, device=dev)
    out_tpass = torch.zeros(B, dtype=torch.int64, device=dev)
    out_over = torch.zeros(B, dtype=torch.int64, device=dev)

    lane = torch.arange(B, device=dev)
    node = torch.full((B,), int(bvh.root_code), dtype=torch.int32, device=dev)
    stack = torch.zeros(B, STACK_DEPTH, dtype=torch.int32, device=dev)
    sp = torch.zeros(B, dtype=torch.int64, device=dev)
    t_hit, prim, bary = t_max.clone(), out_prim.clone(), out_bary.clone()
    n_inner, n_leaf, n_tpass = out_inner.clone(), out_leaf.clone(), out_tpass.clone()
    n_over = out_over.clone()
    lo, ld, linv, ltmin = o, d, inv_d, t_min

    def store(sel):
        idx = lane[sel]
        out_t[idx], out_prim[idx], out_bary[idx] = t_hit[sel], prim[sel], bary[sel]
        out_inner[idx], out_leaf[idx], out_tpass[idx] = n_inner[sel], n_leaf[sel], n_tpass[sel]
        out_over[idx] = n_over[sel]

    steps = 0
    while lane.numel() > 0 and steps < max_steps:
        steps += 1
        n = lane.numel()
        is_inner = node >= 0
        is_leaf = ~is_inner
        n_inner += is_inner
        n_leaf += is_leaf

        # inner-node phase (masked for leaf lanes)
        n_idx = torch.where(is_inner, node, 0).long()
        rows = nodes[n_idx]
        c0_hit, c0_near = _slab_test(rows[:, 0:3], rows[:, 3:6], lo, linv, ltmin, t_hit)
        c1_hit, c1_near = _slab_test(rows[:, 6:9], rows[:, 9:12], lo, linv, ltmin, t_hit)
        c = codes[n_idx]
        swap = c1_hit & (~c0_hit | (c1_near < c0_near))
        near_code = torch.where(swap, c[:, 1], c[:, 0])
        far_code = torch.where(swap, c[:, 0], c[:, 1])
        push = is_inner & c0_hit & c1_hit
        n_over += push & (sp >= STACK_DEPTH)
        r = push.nonzero()[:, 0]
        stack[r, torch.clamp(sp[r], max=STACK_DEPTH - 1)] = far_code[r]
        sp = torch.where(push, torch.clamp(sp + 1, max=STACK_DEPTH), sp)

        # leaf phase (masked for inner lanes)
        first = torch.where(is_leaf, -(node.long() + 1), 0)
        tri_ids = torch.clamp(first[:, None] + leaf_offsets, 0, n_rows - 1)
        t, u, v, h = intersect_woop(woop[tri_ids], lo[:, None], ld[:, None],
                                    ltmin[:, None], t_hit[:, None], verts=verts[tri_ids])
        if with_counts:
            t_ok = (t > ltmin[:, None]) & (t < t_hit[:, None]) & torch.isfinite(t)
            n_tpass += (t_ok & is_leaf[:, None]).sum(-1)
        h = h & is_leaf[:, None]
        best = torch.where(h, t, torch.inf).argmin(-1, keepdim=True)
        leaf_hit = h.any(-1)
        t_hit = torch.where(leaf_hit, t.gather(-1, best)[:, 0], t_hit)
        prim = torch.where(leaf_hit, tri_ids.gather(-1, best)[:, 0].to(torch.int32), prim)
        bary = torch.where(leaf_hit[:, None],
                           torch.cat([u.gather(-1, best), v.gather(-1, best)], -1), bary)

        # next node: the near child if any child is hit, else pop or finish
        descend = is_inner & (c0_hit | c1_hit)
        pop = ~descend & (sp > 0)
        popped = stack[torch.arange(n, device=dev), torch.clamp(sp - 1, min=0)]
        node = torch.where(descend, near_code, torch.where(pop, popped, DONE))
        sp = torch.where(pop, sp - 1, sp)
        if any_hit:
            node = torch.where(leaf_hit, DONE, node)

        done = node == DONE
        if read_bool("traversal.walk", done.any()):
            store(done)
            keep = ~done
            lane, node, stack, sp = lane[keep], node[keep], stack[keep], sp[keep]
            t_hit, prim, bary = t_hit[keep], prim[keep], bary[keep]
            n_inner, n_leaf, n_tpass = n_inner[keep], n_leaf[keep], n_tpass[keep]
            n_over = n_over[keep]
            lo, ld, linv, ltmin = lo[keep], ld[keep], linv[keep], ltmin[keep]
    store(torch.ones_like(lane, dtype=torch.bool))  # lanes cut by max_steps
    hit = Hit(t=out_t, prim=out_prim, bary=out_bary, valid=out_prim >= 0)
    out = (hit, out_inner, out_leaf, out_tpass) if with_counts else (hit,)
    if with_overflow:
        out = out + (out_over,)
    return out if len(out) > 1 else hit


def _woop_vjp(rows, o, d, gt, gu, gv, valid):
    """The vector-Jacobian product of `intersect_woop(rows, o, d)`'s (t, u,
    v) at (gt, gu, gv), in closed form, on (B, 12) rows and (B, 3) rays:
    returns the cotangents of (rows, o, d), 0 on lanes that are not `valid`
    (their recompute may divide by a degenerate dz)."""
    r = rows.unbind(-1)
    ox, oy, oz_ = o.unbind(-1)
    dx, dy, dz_ = d.unbind(-1)
    oz = r[8] * ox + r[9] * oy + r[10] * oz_ + r[11]
    dz = r[8] * dx + r[9] * dy + r[10] * dz_
    live = dz.abs() >= 1e-20     # where the JAX form divides by dz itself
    inv_dz = 1.0 / torch.where(live, dz, 1e-20)
    t = -oz * inv_dz
    du = r[0] * dx + r[1] * dy + r[2] * dz_
    dv = r[4] * dx + r[5] * dy + r[6] * dz_
    g_t = gt + gu * du + gv * dv          # u and v depend on t as well
    g_oz = -g_t * inv_dz
    g_dz = torch.where(live, g_t * oz * inv_dz * inv_dz, 0.0)
    g_du, g_dv = gu * t, gv * t
    p = o + d * t[..., None]              # o + t d, the hit point
    g_rows = torch.stack([
        gu * p[..., 0], gu * p[..., 1], gu * p[..., 2], gu,
        gv * p[..., 0], gv * p[..., 1], gv * p[..., 2], gv,
        g_oz * ox + g_dz * dx, g_oz * oy + g_dz * dy, g_oz * oz_ + g_dz * dz_, g_oz,
    ], dim=-1)
    ru, rv, rz = rows[..., 0:3], rows[..., 4:7], rows[..., 8:11]
    g_o = gu[..., None] * ru + gv[..., None] * rv + g_oz[..., None] * rz
    g_d = g_du[..., None] * ru + g_dv[..., None] * rv + g_dz[..., None] * rz
    v = valid[..., None]
    return (torch.where(v, g_rows, 0.0), torch.where(v, g_o, 0.0), torch.where(v, g_d, 0.0))


class _RefinePassthrough(torch.autograd.Function):
    """Forward: the intersector's own t, u, v, unchanged. Backward: the VJP
    of the closed-form Woop re-evaluation at the hit row, masked by `valid`.
    `woop` is the (T, 12) table with `prim` the hit rows, or, with `prim`
    None, the (B, 12) rows of the hits themselves (the shade pack's Woop
    columns). The table's cotangent is summed by row with the deterministic
    `packed_gather_bwd`."""

    @staticmethod
    def forward(ctx, woop, o, d, t, u, v, prim, valid):
        ctx.save_for_backward(woop, o, d, prim, valid)
        return t.view_as(t), u.view_as(u), v.view_as(v)

    @staticmethod
    def backward(ctx, gt, gu, gv):
        woop, o, d, prim, valid = ctx.saved_tensors
        if not any(ctx.needs_input_grad[:3]):
            return (None,) * 8
        if prim is None:
            rows = woop
        else:
            rows = woop[torch.clamp(prim, min=0).long()]
        g_rows, g_o, g_d = _woop_vjp(rows, o, d, gt, gu, gv, valid)
        if prim is not None and ctx.needs_input_grad[0]:
            from ..ops.shade_gather import packed_gather_bwd

            g_rows = packed_gather_bwd(g_rows.contiguous(), torch.clamp(prim, min=0),
                                       woop.shape[0])
        return (g_rows if ctx.needs_input_grad[0] else None,
                g_o if ctx.needs_input_grad[1] else None,
                g_d if ctx.needs_input_grad[2] else None) + (None,) * 5


def refine_lanes(woop, o, d, hit: Hit, prim=None) -> Hit:
    """`hit` with t / bary made differentiable in (woop, o, d), their values
    unchanged: the JAX package's `_refine_passthrough`. `woop` is the (T,
    12) table indexed by `prim` (int32, -1 on a miss), or, with `prim` None,
    the (B, 12) rows of the hits."""
    sg = lambda x: x.detach()  # noqa: E731
    t, u, v = _RefinePassthrough.apply(woop, o, d, sg(hit.t), sg(hit.bary[..., 0]),
                                       sg(hit.bary[..., 1]), prim, sg(hit.valid))
    return Hit(t=t, prim=sg(hit.prim), bary=torch.stack([u, v], dim=-1), valid=sg(hit.valid))


def refine_hit(bvh, o, d, hit: Hit) -> Hit:
    """Differentiable hit refinement (JAX traversal.py:239-255): the
    intersector's t/u/v pass through, and gradients with respect to the
    Woop rows and the ray flow through the closed-form Woop re-evaluation
    at the hit row. Without a tensor that requires grad, nothing is
    recorded."""
    if not wants_grad(bvh.woop, o, d):
        return hit
    return refine_lanes(bvh.woop, o, d, hit, prim=hit.prim.detach())


def wants_grad(*xs) -> bool:
    """Whether autograd records a graph through any of the tensors `xs`."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


@spanned("ctl.intersect")
def intersect_auto(bvh, o, d, t_min=1e-4, t_max=torch.inf, any_hit: bool = False) -> Hit:
    """Closest-hit (or any-hit) query against the scene BVH's triangles:
    the dense intersector up to DENSE_MAX_TRIS Woop rows (with the BVH's
    chunk boxes and vertex rows), the BVH walk above (each a CUDA kernel for CUDA tensors,
    its plain version for CPU tensors), on detached inputs. A closest hit
    goes through `refine_hit`. Runs inside the span `ctl.intersect`."""
    sg = lambda x: x.detach() if isinstance(x, torch.Tensor) else x  # noqa: E731
    bvh_r = bvh._replace(**{k: sg(v) for k, v in bvh._asdict().items()})
    if bvh.woop.shape[0] <= DENSE_MAX_TRIS:
        from ..ops.intersect_dense import intersect_dense

        raw = intersect_dense(bvh_r.woop, sg(o), sg(d), sg(t_min), sg(t_max), any_hit=any_hit,
                              boxes=bvh_r.chunk_boxes, verts=bvh_r.tri_verts)
    else:
        from ..ops.intersect_bvh import intersect_bvh

        raw = intersect_bvh(bvh_r, sg(o), sg(d), sg(t_min), sg(t_max), any_hit=any_hit)
    if any_hit:  # occlusion queries only consume .valid
        return raw
    return refine_hit(bvh, o, d, raw)


def occluded(bvh, o, d, t_min=1e-4, t_max=torch.inf):
    """Any-hit query: True where the segment is blocked."""
    return intersect_auto(bvh, o, d, t_min, t_max, any_hit=True).valid
