"""Participating media: homogeneous and dense-grid volumes (port of
cudatracerlib_tpu/scene/media.py).

One SoA table of at most MAX_VOLUMES volumes. Grid data lives in one flat
float32 buffer (`grid_data`, slot 0 a dummy 1.0) with per-volume offsets,
channel counts (1, or 3 stored channel-major) and a resolution, so each
volume keeps its own resolution and each of sigma_a / sigma_s / Le may carry
its own scalar or RGB grid. Lookups are trilinear 8-corner gathers from the
flat buffer, in the JAX package's interpolation order (x, then y, then z).

`Media.build` also keeps the host-side structure the hot paths specialise
on: `modes`, a plain tuple (what the JAX package's `static_modes` derives
from its identity-keyed host cache), one entry per volume:
  ('const', -1, le_off, res)  homogeneous or constant fields: no gathers;
  ('scalar', off, le_off, res) one shared scalar grid drives sigma_a and
                              sigma_s (the bench plume): one 8-corner lookup;
  ('gen', -1, le_off, res)    distinct or RGB grids: the generic path.

`transmittance` integrates a grid segment with TAU_STEPS midpoint steps.
The JAX package scans the steps; here a 'scalar' volume's segment is one
kernel of ops/transmittance (a thread a lane), and the eager path looks the
steps' points up as one (B, TAU_STEPS) batch; both sum left to right, the
scan's order, so the sum has the same bits. `sample_distance` is delta (Woodcock)
tracking under a per-ray union majorant. JAX runs it as a while loop until
no lane tracks (at most HARD_TRACK_CAP trips), and each trip draws two
numbers for every lane, so after it every lane's sampler has moved by
2 * T draws, T the trip count of the slowest lane; the sampler is set to its
start plus 2 * T draws. `delta_track` runs the trips one of two ways, by
what its input is: on CUDA tensors whose volumes are all 'scalar' or
'const', the kernel of ops/delta_track (a thread a lane runs the lane's
trips, drawing at its own start state + (2k + 1) and (2k + 2) Weyl steps as
the batch's trip k does; T reduced on the device; no host read); otherwise
(CPU tensors, no modes, a 'gen' volume) the eager loop, trips in blocks of
TRACK_BLOCK with one host read a block, the trips that began with a lane
still tracking counted on the device. A trip leaves stopped lanes as they
are, so the loop's trips past T change nothing else. Both give the same
bits.

Gradients: every differentiable table lookup (the grid's 8 corners, a
volume's sigma_a / sigma_s / Le by a lane's volume id) goes through
ops/shade_gather.gather_rows, so on the card the table's cotangent is summed
by the deterministic gather-backward kernel, not by PyTorch's index
backward. The JAX module stops gradients at these sites: the majorant (JAX
:609) is a `.detach()` here; the tracking ray and its start (:625-627), the
far end of the union extent (:637) and the accept ratio (:640) feed only the
tracking loop, which `delta_track` runs under `torch.no_grad()`; the
collision distance and point (:672-674), the log-transmittance of the
marginal pdf (:685), the mean sigma_t of the pdf (:698) and the per-volume
sigma_s of the volume choice (:724) are `.detach()`s at the same places in
`sample_distance`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import delta_track as dt_op
from ..ops import transmittance as tr_op
from ..ops.shade_gather import gather_rows
from ..sampling.rng import Sampler
from ..utils.timing import count, count_device, read_bool, spanned

HOMOGENEOUS = 0
GRID = 1

GRID_RES = 32      # default resolution of procedurally built grids
MAX_VOLUMES = 16   # aggregate capacity (reference KernelAggregateVolume)
TAU_STEPS = tr_op.TAU_STEPS  # fixed quadrature steps along a segment
HARD_TRACK_CAP = 256  # delta-tracking trips at most (JAX media.py:624)
TRACK_BLOCK = 8    # tracking trips between two host reads of "any lane tracking"


class Media(NamedTuple):
    active: torch.Tensor      # (V,) int32 0/1
    vtype: torch.Tensor       # (V,) int32
    sigma_a: torch.Tensor     # (V, 3) base absorption (a grid multiplies it)
    sigma_s: torch.Tensor     # (V, 3) base scattering
    le: torch.Tensor          # (V, 3) base emission
    phase_type: torch.Tensor  # (V,) int32 (scene/phase.py tags)
    phase_g: torch.Tensor     # (V,)
    box_min: torch.Tensor     # (V, 3)
    box_max: torch.Tensor     # (V, 3)
    grid_data: torch.Tensor   # (TOTAL,) f32; index 0 holds 1.0 (dummy)
    res: torch.Tensor         # (V, 3) int32 grid resolution, (1, 1, 1) if none
    off_a: torch.Tensor       # (V,) int32 offset of the sigma_a grid, -1 = constant
    off_s: torch.Tensor       # (V,) int32 offset of the sigma_s grid
    off_le: torch.Tensor      # (V,) int32 offset of the Le grid
    ch_a: torch.Tensor        # (V,) int32 channels (1 or 3)
    ch_s: torch.Tensor        # (V,) int32
    ch_le: torch.Tensor       # (V,) int32
    maj_a: torch.Tensor       # (V,) f32 largest sigma_a-grid value (1 if constant)
    maj_s: torch.Tensor       # (V,) f32 largest sigma_s-grid value
    modes: tuple = ()         # host-side per-volume structure (module docstring)

    @property
    def count(self) -> int:
        return self.active.shape[0]

    @staticmethod
    def build(records: list[dict], device="cuda") -> "Media":
        """Records: {type, sigma_a, sigma_s, le, phase_type, phase_g,
        box_min, box_max} plus, for GRID volumes, any of
          density      one scalar grid applied to sigma_a AND sigma_s;
          sigma_a_grid / sigma_s_grid / le_grid
                       (rx, ry, rz) scalar or (rx, ry, rz, 3) RGB arrays.
        All grids of one volume share a resolution. The tables are sized by
        the record count (at least 1), on `device` (the card by default)."""
        if len(records) > MAX_VOLUMES:
            raise ValueError(f"{len(records)} volumes; the aggregate holds {MAX_VOLUMES}")
        v = max(len(records), 1)
        out = dict(
            active=np.zeros(v, np.int32),
            vtype=np.zeros(v, np.int32),
            sigma_a=np.zeros((v, 3), np.float32),
            sigma_s=np.zeros((v, 3), np.float32),
            le=np.zeros((v, 3), np.float32),
            phase_type=np.zeros(v, np.int32),
            phase_g=np.zeros(v, np.float32),
            box_min=np.zeros((v, 3), np.float32),
            box_max=np.ones((v, 3), np.float32),
        )
        res = np.ones((v, 3), np.int32)
        off = {k: np.full(v, -1, np.int32) for k in ("a", "s", "le")}
        ch = {k: np.ones(v, np.int32) for k in ("a", "s", "le")}
        maj = {k: np.ones(v, np.float32) for k in ("a", "s")}
        pool = [np.ones(1, np.float32)]  # dummy slot 0
        total = 1

        def push(arr):
            nonlocal total
            a = np.asarray(arr, np.float32)
            if a.ndim == 3:
                nch, rshape, flat = 1, a.shape, a.reshape(-1)
            elif a.ndim == 4 and a.shape[-1] == 3:
                nch, rshape = 3, a.shape[:3]
                flat = np.moveaxis(a, -1, 0).reshape(-1)  # channel-major [c][x][y][z]
            else:
                raise ValueError(f"a grid must be 3-D or 3-D RGB, got shape {a.shape}")
            o = total
            pool.append(flat)
            total += flat.size
            return o, nch, rshape, float(a.max(initial=0.0))

        for i, r in enumerate(records):
            out["active"][i] = 1
            out["vtype"][i] = r.get("type", HOMOGENEOUS)
            out["sigma_a"][i] = r.get("sigma_a", [0.1] * 3)
            out["sigma_s"][i] = r.get("sigma_s", [0.1] * 3)
            out["le"][i] = r.get("le", [0.0] * 3)
            out["phase_type"][i] = r.get("phase_type", 0)
            out["phase_g"][i] = r.get("phase_g", 0.0)
            out["box_min"][i] = r.get("box_min", [0, 0, 0])
            out["box_max"][i] = r.get("box_max", [1, 1, 1])
            rres = None
            fields = [("density", ("a", "s")), ("sigma_a_grid", ("a",)),
                      ("sigma_s_grid", ("s",)), ("le_grid", ("le",))]
            for key, targets in fields:
                if key not in r:
                    continue
                o, nch, rres2, mx = push(r[key])
                if rres is not None and rres != rres2:
                    raise ValueError(f"volume {i}: grids of resolutions {rres} and {rres2}")
                rres = rres2
                for k in targets:
                    off[k][i], ch[k][i] = o, nch
                    if k in maj:
                        maj[k][i] = mx
            if rres is not None:
                res[i] = rres

        arrays = dict(out, grid_data=np.concatenate(pool), res=res,
                      off_a=off["a"], off_s=off["s"], off_le=off["le"],
                      ch_a=ch["a"], ch_s=ch["s"], ch_le=ch["le"],
                      maj_a=maj["a"], maj_s=maj["s"])
        return from_arrays(arrays, device)

    @staticmethod
    def empty(device="cuda") -> "Media":
        return Media.build([], device)


def plume_records(box_min, box_max, res: int = GRID_RES, seed: int = 0) -> list[dict]:
    """Bench config 4's smoke plume (bench.py:261-275): a
    res^3 density grid, the sum of 6 Gaussians drawn from
    np.random.default_rng(seed), as one GRID volume with sigma_a 0.05,
    sigma_s (0.6, 0.7, 0.8) and phase_g 0.3 (no phase_type, so ISOTROPIC,
    which leaves g unused, as in the reference) spanning [box_min + 0.05,
    box_max - 0.05]. Records for `Media.build`."""
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, res)] * 3, indexing="ij"), -1)
    rng = np.random.default_rng(seed)
    dens = np.zeros((res,) * 3, np.float32)
    for _ in range(6):
        c = rng.uniform(0.2, 0.8, 3)
        s = rng.uniform(0.05, 0.2)
        dens += np.exp(-np.sum((g - c) ** 2, -1) / (2 * s * s)).astype(np.float32)
    return [dict(type=GRID, sigma_a=[0.05] * 3, sigma_s=[0.6, 0.7, 0.8],
                 box_min=np.asarray(box_min) + 0.05, box_max=np.asarray(box_max) - 0.05,
                 phase_g=0.3, density=dens)]


def modes_from_arrays(vtype, off_a, off_s, off_le, ch_a, ch_s, res) -> tuple:
    """The per-volume mode tuple (module docstring) from host arrays, as the
    JAX package's `static_modes` derives it."""
    out = []
    for v in range(len(vtype)):
        le_off = int(off_le[v])
        res3 = tuple(int(x) for x in res[v])
        if vtype[v] != GRID or (off_a[v] < 0 and off_s[v] < 0):
            out.append(("const", -1, le_off, res3))
        elif off_a[v] == off_s[v] and ch_a[v] == 1 and ch_s[v] == 1:
            out.append(("scalar", int(off_a[v]), le_off, res3))
        else:
            out.append(("gen", -1, le_off, res3))
    return tuple(out)


def from_arrays(arrays: dict, device="cuda") -> Media:
    """A Media on `device` from its fields as numpy arrays (every field but
    `modes`, which is derived from them)."""
    fields = [f for f in Media._fields if f != "modes"]
    host = {f: np.asarray(arrays[f]) for f in fields}
    modes = modes_from_arrays(host["vtype"], host["off_a"], host["off_s"], host["off_le"],
                              host["ch_a"], host["ch_s"], host["res"])
    return Media(**{f: torch.from_numpy(np.array(host[f])).to(device) for f in fields},
                 modes=modes)


def static_modes(media: Media) -> tuple:
    """The per-volume mode tuple kept by `Media.build` (PTConfig.media_modes)."""
    return media.modes


def _ray_box(box_min, box_max, o, d, t_min, t_max):
    inv = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
    t0 = (box_min - o) * inv
    t1 = (box_max - o) * inv
    near = _max(torch.minimum(t0, t1).amax(-1), t_min)
    far = _min(torch.maximum(t0, t1).amin(-1), t_max)
    return near, far, near < far


def _max(x, y):
    return torch.maximum(x, y) if isinstance(y, torch.Tensor) else torch.clamp(x, min=y)


def _min(x, y):
    return torch.minimum(x, y) if isinstance(y, torch.Tensor) else torch.clamp(x, max=y)


def _trilinear(q, rf, r, corner):
    """Trilinear interpolation at grid coordinates `q` (..., 3) of a grid of
    resolution `r` (int tensor broadcasting against q, `rf` its float).
    `corner(ix, iy, iz)` fetches all 8 corners in one gather: it gets the
    corner indices shaped (..., 2, 1, 1), (..., 1, 2, 1), (..., 1, 1, 2)
    and returns (..., 2, 2, 2) values, or (..., 2, 2, 2, C). The lerps run
    in the JAX package's order, x, then y, then z, four corners at a time."""
    q = torch.minimum(torch.clamp(q, min=0.0), torch.clamp(rf - 1, min=0.0) * (1 - 1e-6))
    i0 = torch.floor(q).to(torch.int64)
    f = q - i0
    ii = torch.stack([i0, torch.minimum(i0 + 1, r - 1)], -1)  # (..., 3, 2)
    c = corner(ii[..., 0, :, None, None], ii[..., 1, None, :, None], ii[..., 2, None, None, :])
    ch = c.dim() - f.dim() - 2  # 1 with a channel axis, else 0

    def lerp(a, axis, t, nd):
        t = t.reshape(t.shape + (1,) * nd)
        return a.select(axis, 0) * (1 - t) + a.select(axis, 1) * t

    fx, fy, fz = f.unbind(-1)
    c = lerp(c, -3 - ch, fx, 2 + ch)  # (..., y, z[, C])
    c = lerp(c, -2 - ch, fy, 1 + ch)  # (..., z[, C])
    return lerp(c, -1 - ch, fz, ch)


def _grid_lookup(media: Media, vid, p, off, nch):
    """Trilinear (..., 3) lookup of one per-volume grid channel set: `vid`,
    `off`, `nch` per ray (int tensors of p's leading shape). Grids with
    off < 0 give 1.0; scalar grids (nch == 1) broadcast with a 0 channel
    stride."""
    vid = vid.long()
    lo, hi = media.box_min[vid], media.box_max[vid]
    r = media.res[vid].long()
    q = (p - lo) / torch.clamp(hi - lo, min=1e-9) * (r.float() - 1)
    has = off >= 0
    corner_dims = lambda x: x[..., None, None, None]  # noqa: E731
    ry, rz = corner_dims(r[..., 1]), corner_dims(r[..., 2])
    base = corner_dims(torch.where(has, off, 0).long())
    cstride = corner_dims(torch.where(nch == 3, r[..., 0] * r[..., 1] * r[..., 2], 0))
    chan = torch.arange(3, device=p.device)

    def corner(ax, ay, az):
        sp = (ax * ry + ay) * rz + az
        return gather_rows(media.grid_data, (base + sp)[..., None] + cstride[..., None] * chan)

    val = _trilinear(q, r.float(), r, corner)
    return torch.where(has[..., None], val, 1.0)


def _inside(media: Media, vid, p):
    vid = vid.long()
    ins = ((p >= media.box_min[vid]) & (p <= media.box_max[vid])).all(-1)
    return ins & (media.active[vid] > 0)


def _inside_v(media: Media, v: int, p):
    ins = ((p >= media.box_min[v]) & (p <= media.box_max[v])).all(-1)
    return ins & (media.active[v] > 0)


def _grid_lookup1(media: Media, v: int, off: int, p):
    """(...,) scalar trilinear lookup of volume v's grid at the statically
    known offset `off`: an 8-corner gather from the flat buffer."""
    lo, hi = media.box_min[v], media.box_max[v]
    r = media.res[v].long()
    rf = r.float()
    q = (p - lo) / torch.clamp(hi - lo, min=1e-9) * (rf - 1)
    ry, rz = r[1], r[2]

    def corner(ax, ay, az):
        return gather_rows(media.grid_data, off + (ax * ry + ay) * rz + az)

    return _trilinear(q, rf, r, corner)


def _sigma_pair_v(media: Media, v: int, p, mode):
    """(sigma_s, sigma_t) (..., 3) of volume v at p through its mode entry;
    the generic gather path only for distinct or RGB grids."""
    ins = _inside_v(media, v, p)[..., None]
    base_s = media.sigma_s[v]
    base_t = media.sigma_s[v] + media.sigma_a[v]
    kind = mode[0]
    if kind == "const":
        zero3 = torch.zeros(p.shape[:-1] + (3,), device=p.device)
        return torch.where(ins, base_s, 0.0) + zero3, torch.where(ins, base_t, 0.0) + zero3
    if kind == "scalar":
        D = _grid_lookup1(media, v, mode[1], p)[..., None]
        return torch.where(ins, base_s * D, 0.0), torch.where(ins, base_t * D, 0.0)
    vid = torch.full(p.shape[:-1], v, dtype=torch.int64, device=p.device)
    s_s = sigma_s_at(media, vid, p)
    return s_s, s_s + sigma_a_at(media, vid, p)


def _le_v(media: Media, v: int, p, mode):
    """Volume emission of volume v at p (a constant needs no gather)."""
    if mode is None or mode[2] >= 0:
        return le_at(media, torch.full(p.shape[:-1], v, dtype=torch.int64, device=p.device), p)
    ins = _inside_v(media, v, p)[..., None]
    return torch.where(ins, media.le[v], 0.0) + torch.zeros(p.shape[:-1] + (3,), device=p.device)


def _mult(media: Media, vid, p, off_field, ch_field):
    """(..., 3) grid multiplier of one quantity; 1 outside GRID volumes."""
    vid = vid.long()
    is_grid = media.vtype[vid] == GRID
    m = _grid_lookup(media, vid, p, off_field[vid], ch_field[vid])
    return torch.where(is_grid[..., None], m, 1.0)


def density_at(media: Media, vid, p):
    """Scalar density multiplier at p: the channel mean of the sigma_a grid
    (the single-grid semantics of the photon-beam estimators)."""
    m = _mult(media, vid, p, media.off_a, media.ch_a).mean(-1)
    return torch.where(_inside(media, vid, p), m, 0.0)


def sigma_a_at(media: Media, vid, p):
    ins = _inside(media, vid, p)[..., None]
    return torch.where(ins, gather_rows(media.sigma_a, vid.long())
                       * _mult(media, vid, p, media.off_a, media.ch_a), 0.0)


def sigma_s_at(media: Media, vid, p):
    ins = _inside(media, vid, p)[..., None]
    return torch.where(ins, gather_rows(media.sigma_s, vid.long())
                       * _mult(media, vid, p, media.off_s, media.ch_s), 0.0)


def sigma_t_at(media: Media, vid, p):
    return sigma_a_at(media, vid, p) + sigma_s_at(media, vid, p)


def le_at(media: Media, vid, p):
    """Volume emission Lve (reference VolumeRegion::Lve)."""
    ins = _inside(media, vid, p)[..., None]
    return torch.where(ins, gather_rows(media.le, vid.long())
                       * _mult(media, vid, p, media.off_le, media.ch_le), 0.0)


def _steps(o, d, t0, dt):
    """The TAU_STEPS midpoints o + d * (t0 + (i + 0.5) dt): (B, TAU_STEPS, 3)."""
    i = torch.arange(TAU_STEPS, dtype=torch.float32, device=o.device)
    t = t0[..., None] + (i + 0.5) * dt[..., None]
    return o[..., None, :] + d[..., None, :] * t[..., None]


def _scan_sum(vals):
    """Sum over dim 1 from left to right: the JAX scan's order, bit for bit
    (`unbind`: one backward node for the columns, not one per column)."""
    acc = torch.zeros(vals.shape[:1] + vals.shape[2:], device=vals.device)
    for col in vals.unbind(1):
        acc = acc + col
    return acc


def tau_segment(media: Media, vid, o, d, t0, t1):
    """Per-channel optical depth along [t0, t1]: closed form for homogeneous
    volumes, TAU_STEPS midpoint steps for grids (reference VolumeRegion::tau)."""
    vid = vid.long()
    seg = torch.clamp(t1 - t0, min=0.0)
    st = gather_rows(media.sigma_a, vid) + gather_rows(media.sigma_s, vid)
    tau_h = st * seg[..., None]
    dt = seg / TAU_STEPS
    pts = _steps(o, d, t0, dt)
    vs = vid[..., None].expand(pts.shape[:-1])
    st_p = (gather_rows(media.sigma_a, vs) * _mult(media, vs, pts, media.off_a, media.ch_a)
            + gather_rows(media.sigma_s, vs) * _mult(media, vs, pts, media.off_s, media.ch_s))
    tau_g = _scan_sum(st_p) * dt[..., None]
    return torch.where((media.vtype[vid] == GRID)[..., None], tau_g, tau_h)


def segment_in_media(media: Media, o, d, t_min, t_max):
    """True where the ray segment overlaps any active volume's box."""
    inside = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
    for v in range(media.count):
        _, _, hit = _ray_box(media.box_min[v], media.box_max[v], o, d, t_min, t_max)
        inside = inside | (hit & (media.active[v] > 0))
    return inside


def sigma_at(media: Media, p, modes=None):
    """(sigma_s (..., 3), sigma_t (..., 3)) summed over the active volumes
    at p (the aggregate's union). `modes`: the per-volume mode tuple."""
    ss = torch.zeros(p.shape[:-1] + (3,), device=p.device)
    st = torch.zeros(p.shape[:-1] + (3,), device=p.device)
    for v in range(media.count):
        if modes is not None:
            s_s, s_t = _sigma_pair_v(media, v, p, modes[v])
        else:
            vid = torch.full(p.shape[:-1], v, dtype=torch.int64, device=p.device)
            s_s = sigma_s_at(media, vid, p)
            s_t = s_s + sigma_a_at(media, vid, p)
        ss = ss + s_s
        st = st + s_t
    return ss, st


def _carries_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                           for x in xs)


def _eager_factor(media: Media, v: int, kind, modes, o, d, t_min, t_max):
    """Volume v's factor where(act, exp(-tau), 1) in eager PyTorch: every
    mode, and rays whose positions carry a gradient."""
    near, far, hit = _ray_box(media.box_min[v], media.box_max[v], o, d, t_min, t_max)
    seg = torch.clamp(far - near, min=0.0)
    if kind == "const":
        tau = (media.sigma_a[v] + media.sigma_s[v]) * seg[..., None]
    elif kind == "scalar":
        # the quadrature of the shared scalar field, scaled by each
        # channel's base sigma_t
        dt = seg / TAU_STEPS
        acc = _scan_sum(_grid_lookup1(media, v, modes[v][1], _steps(o, d, near, dt)))
        tau = (media.sigma_a[v] + media.sigma_s[v]) * (acc * dt)[..., None]
    else:
        vid = torch.full(o.shape[:-1], v, dtype=torch.int64, device=o.device)
        tau = tau_segment(media, vid, o, d, near, torch.maximum(far, near))
    act = hit & (media.active[v] > 0)
    return torch.where(act[..., None], torch.exp(-tau), 1.0)


@spanned("ctl.media.transmittance")
def transmittance(media: Media, o, d, t_min, t_max, modes=None):
    """Transmittance over all active volumes along [t_min, t_max]
    (KernelAggregateVolume union semantics), the product of each volume's
    factor. `modes`: the mode tuple. A 'scalar' volume goes to the kernel
    of ops/transmittance (the plain version on the CPU, the same bits as
    the eager path) unless the rays or the box carry a gradient; every other
    volume runs the eager path, counted in `media.transmittance.eager`.
    Runs inside the span `ctl.media.transmittance`."""
    tr = None
    for v in range(media.count):
        kind = None if modes is None else modes[v][0]
        if kind == "scalar" and not _carries_grad(o, d, t_min, t_max, media.box_min,
                                                  media.box_max):
            vol = tr_op.Grid(media.box_min[v], media.box_max[v], media.active[v], modes[v][1],
                             modes[v][3])
            f = tr_op.transmittance(vol, media.grid_data, media.sigma_a[v] + media.sigma_s[v],
                                    o, d, t_min, t_max)
        else:
            count("media.transmittance.eager")
            f = _eager_factor(media, v, kind, modes, o, d, t_min, t_max)
        tr = f if tr is None else tr * f
    return torch.ones(o.shape[:-1] + (3,), device=o.device) if tr is None else tr


class _Track(NamedTuple):
    t: torch.Tensor         # the tracking position
    tracking: torch.Tensor  # still marching
    real: torch.Tensor      # stopped at a real collision
    state: torch.Tensor     # the sampler's state words


def _track(media, modes, o, d, maj, u_far, c: _Track) -> _Track:
    """One delta-tracking trip for every lane (JAX media.py:633-651); the
    caller records no graph."""
    s, u = Sampler(state=c.state).next_1d()
    dt = -torch.log(torch.clamp(1.0 - u, min=1e-12)) / maj
    t_new = c.t + dt
    esc_now = c.tracking & (t_new >= u_far)
    p = o + d * torch.where(c.tracking, t_new, c.t)[..., None]
    _, st = sigma_at(media, p, modes)
    ratio = torch.clamp(st.mean(-1) / maj, 0.0, 1.0)
    s, u2 = s.next_1d()
    go_on = c.tracking & ~esc_now
    real_now = go_on & (u2 < ratio)
    return _Track(t=torch.where(go_on, t_new, c.t), tracking=go_on & ~real_now,
                  real=c.real | real_now, state=s.state)


def _track_eager(media, modes, o, d, u_near, u_far, maj, in_vol, state):
    """The batch loop: blocks of TRACK_BLOCK trips, T counted on the device,
    one host read a block (`host_reads.media.delta_track`, ceil(T /
    TRACK_BLOCK) + 1 a call). Returns (the final _Track, T)."""
    c = _Track(t=u_near, tracking=in_vol, real=torch.zeros_like(in_vol), state=state)
    trips = torch.zeros((), dtype=torch.int64, device=o.device)
    done = 0
    while done < HARD_TRACK_CAP and read_bool("media.delta_track", c.tracking.any()):
        for _ in range(min(TRACK_BLOCK, HARD_TRACK_CAP - done)):
            trips = trips + c.tracking.any()
            c = _track(media, modes, o, d, maj, u_far, c)
        done += TRACK_BLOCK
    return c, trips


def _kernel_tracks(o, modes) -> bool:
    """The tracking kernel takes CUDA tensors whose volumes are all of the
    modes it computes ('scalar', 'const')."""
    return (o.device.type == "cuda" and modes is not None
            and all(m[0] in dt_op.KINDS for m in modes))


@spanned("ctl.media.track")
@torch.no_grad()
def delta_track(media: Media, modes, o, d, u_near, u_far, maj, in_vol, state):
    """The tracking loop of `sample_distance`: returns (t, real, T), T an
    int64 0-dim device tensor. On CUDA tensors whose volumes are all 'scalar'
    or 'const' the kernel of ops/delta_track runs the trips (no host read);
    on CPU tensors, with no modes or with a 'gen' volume, the eager loop
    (`_track_eager`, counted in `media.track.eager`). It records no graph:
    JAX's while loop carries no tangent (its inputs are stop-gradient values,
    media.py:625-651), and a graph here would save every trip's lookups for
    a backward that never reads them. Runs inside the span
    `ctl.media.track`; counts `media.track_calls` and, while a profiler
    records, T (`media.trips`, read after the trace)."""
    count("media.track_calls")
    if _kernel_tracks(o, modes):
        vols = dt_op.Volumes(media.box_min, media.box_max, media.active, media.sigma_a,
                             media.sigma_s, media.grid_data, modes)
        t, real, trips = dt_op.delta_track(vols, o, d, u_near, u_far, maj, in_vol, state)
    else:
        count("media.track.eager")
        c, trips = _track_eager(media, modes, o, d, u_near, u_far, maj, in_vol, state)
        t, real = c.t, c.real
    count_device("media.trips", trips)
    return t, real, trips


def sample_distance(media: Media, o, d, t_min, t_max, sampler: Sampler, modes=None):
    """Sample a scattering distance along [t_min, t_max] (t_max per ray, a
    tensor) against the union of all volumes
    (KernelAggregateVolume::sampleDistance semantics) by delta tracking
    under a per-ray union majorant: a candidate is a real collision with
    probability mean sigma_t(p) / majorant, else tracking goes on.

    Returns (sampler, t, scatter, weight (..., 3), vid, p_scatter, emit):
    weight = sigma_s * Tr / pdf for a medium event, Tr / pdf(pass) for a
    pass-through; `emit` = Tr * Le / pdf at the collision. The decisions'
    pdf is detached while Tr and the sigmas stay attached."""
    B = o.shape[:-1]
    dev = o.device
    u_near = torch.full(B, torch.inf, device=dev)
    u_far = torch.zeros(B, device=dev)
    maj = torch.zeros(B, device=dev)
    any_hit = torch.zeros(B, dtype=torch.bool, device=dev)
    for v in range(media.count):
        near, far, hitb = _ray_box(media.box_min[v], media.box_max[v], o, d, t_min, t_max)
        act = hitb & (media.active[v] > 0)
        u_near = torch.where(act, torch.minimum(u_near, near), u_near)
        u_far = torch.where(act, torch.maximum(u_far, far), u_far)
        is_grid = media.vtype[v] == GRID
        bound_v = (media.sigma_a[v].mean() * torch.where(is_grid, media.maj_a[v], 1.0)
                   + media.sigma_s[v].mean() * torch.where(is_grid, media.maj_s[v], 1.0))
        maj = maj + torch.where(act, bound_v, 0.0)
        any_hit = any_hit | act

    in_vol = any_hit
    # no inf sentinel may enter differentiable math (inf * 0 is NaN in a backward)
    u_near = torch.where(in_vol, u_near, 0.0)
    u_far = torch.where(in_vol, u_far, 0.0)
    maj = torch.clamp(maj, min=1e-6).detach()

    t_trk, real, trips = delta_track(media, modes, o, d, u_near, u_far, maj, in_vol,
                                     sampler.state)
    sampler = sampler.skip(2 * trips)

    scatter = in_vol & real
    t_far = torch.clamp(t_max, max=1e7)
    t_s = torch.where(scatter, t_trk.detach(), t_far.detach())
    p_s = o.detach() + d.detach() * t_s[..., None]

    # Delta tracking draws the collision from the exact marginal of the
    # channel-mean sigma_t and passes with probability exp(-tau_mean): weight
    # by the attached per-channel Tr over the detached marginal pdfs.
    t_end = torch.where(scatter, t_s, t_far)
    tr = transmittance(media, o, d, t_min, t_end, modes)
    tr = torch.where(in_vol[..., None], tr, 1.0)
    log_tr_det = torch.log(torch.clamp(tr, min=1e-30)).detach()
    tr_det_mean = torch.exp(log_tr_det.mean(-1))

    # sigma_s and emission summed over the volumes overlapping at p; Lve is
    # per unit length with no sigma_a factor (reference PointStorage.h:185)
    ss_p, st_p = sigma_at(media, p_s, modes)
    emit_p = torch.zeros(p_s.shape[:-1] + (3,), device=dev)
    for v in range(media.count):
        emit_p = emit_p + _le_v(media, v, p_s, None if modes is None else modes[v])

    st_mean_det = torch.clamp(st_p.mean(-1), min=1e-9).detach()
    pdf = torch.where(scatter, st_mean_det * tr_det_mean, tr_det_mean)
    inv_pdf = (1.0 / torch.clamp(pdf, min=1e-12))[..., None]
    weight = torch.where(scatter[..., None], ss_p * tr * inv_pdf, tr * inv_pdf)
    weight = torch.where(in_vol[..., None], weight, 1.0)
    emit = torch.where(scatter[..., None], emit_p * tr * inv_pdf, 0.0)

    # the volume whose phase function scatters: where volumes overlap, one
    # chosen in proportion to its sigma_s at p (the aggregate's mixture)
    sampler, u_vid = sampler.next_1d()
    ss_total = torch.clamp(ss_p.mean(-1), min=1e-20)
    acc = torch.zeros(B, device=dev)
    vid = torch.zeros(B, dtype=torch.int64, device=dev)
    chosen = torch.zeros(B, dtype=torch.bool, device=dev)
    for v in range(media.count):
        if modes is not None:
            w_v = _sigma_pair_v(media, v, p_s, modes[v])[0].mean(-1)
        else:
            vv = torch.full(B, v, dtype=torch.int64, device=dev)
            w_v = torch.where(_inside(media, vv, p_s), sigma_s_at(media, vv, p_s).mean(-1), 0.0)
        acc = acc + w_v.detach() / ss_total
        take = ~chosen & (u_vid < acc + 1e-7) & (w_v > 0)
        vid = torch.where(take, v, vid)
        chosen = chosen | take
    return sampler, t_s, scatter, weight, vid, p_s, emit
