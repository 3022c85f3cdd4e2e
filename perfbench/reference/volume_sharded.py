"""A rank's share of the sharded volumetric render and of its gradient, for
the sharded grad cell: the plain reference of volume.py run on the lanes a
rank of a ("dp", "sp") layout owns.

The lanes, by this module's own rule: the pass's sample grid, pixel ids
tile(arange(n_px), spp) and sample indices repeat(arange(spp), n_px), read
as an (n_sp, spp / n_sp, n_dp, n_px / n_dp) array; rank r, at dp = r // n_sp
and sp = r % n_sp (sp innermost), owns block [sp, :, dp, :] and traces it as
one batch through volume.radiance, from RefScene.camera_rays.

Delta tracking couples the lanes of a batch: every lane draws two numbers
a trip until no lane of the batch tracks, so its later numbers depend on the
slowest lane's trip count T (volume.py). The rank's lanes are therefore
traced whole once without a graph, which records each bounce's skip of 2 T;
the gradient is then taken in blocks of lanes, each block replaying those
skips, so that every lane draws what it drew in the whole batch. Summing
the blocks' gradients gives the whole batch's, to float rounding.

`medium` is volume.RefMedium with its grid's lookups gathered by
index_select: the same values, but their gradient is summed by index_add_
(atomic adds on the card) where indexing's backward sorts every lookup
(91% of the device time of a block's gradient, profiled on the card)."""
from __future__ import annotations

import torch

from . import volume
from .sampler import Stream


class _Rows:
    """A flat grid whose lookups `grid[idx]` gather with index_select."""

    def __init__(self, grid):
        self.grid = grid

    def __getitem__(self, idx):
        return torch.index_select(self.grid, 0, idx.reshape(-1)).reshape(idx.shape)


def medium(rec: dict, device, dtype=torch.float32, params=None) -> volume.RefMedium:
    """volume.RefMedium of `rec`, its grid looked up through `_Rows`."""
    med = volume.RefMedium(rec, device, dtype, params=params)
    med.grid = _Rows(med.grid)
    return med


def rank_lanes(n_dp: int, n_sp: int, rank: int, width: int, height: int, spp: int, device):
    """(pixel_id, sample_idx) of rank `rank`'s lanes, in batch order."""
    n_px = width * height
    if n_px % n_dp or spp % n_sp:
        raise ValueError(f"{n_px} pixels over dp = {n_dp}, {spp} spp over sp = {n_sp}")
    dp, sp = divmod(rank, n_sp)
    grid = (n_sp, spp // n_sp, n_dp, n_px // n_dp)
    pix = torch.arange(n_px, device=device).repeat(spp).reshape(grid)[sp, :, dp]
    smp = torch.arange(spp, device=device).repeat_interleave(n_px).reshape(grid)[sp, :, dp]
    return pix.reshape(-1), smp.reshape(-1)


class _Recorded(Stream):
    """A stream that keeps the skips it makes (one a bounce: tracking's 2 T)."""

    def __init__(self, state, dtype):
        super().__init__(state, dtype)
        self.skips = []

    def skip(self, n):
        self.skips.append(int(n))
        super().skip(n)


class _Replayed(Stream):
    """A stream that skips as a recorded whole batch did, bounce by bounce."""

    def __init__(self, state, dtype, skips):
        super().__init__(state, dtype)
        self.skips = list(skips)

    def skip(self, n):
        super().skip(self.skips.pop(0))


def radiance_whole(sc, med, pixel_id, sample_idx, width, height, seed, block):
    """(L (B, 3) with no graph, non-finite samples as 0; the skips of each
    bounce): the lanes traced as one batch."""
    with torch.no_grad():
        o, d, st = sc.camera_rays(pixel_id, sample_idx, width, height, seed)
        rec = _Recorded(st.state, st.dtype)
        L = volume.radiance(sc, med, o, d, rec, block)
    return torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0), rec.skips


def lane_gradient(sc, med, params: dict, pixel_id, sample_idx, width, height, seed, block,
                  skips, cot, grad_block):
    """{leaf: sum over the lanes of cot[lane] . dL[lane]/dleaf}, with the
    lanes' graph built `grad_block` lanes at a time, each block replaying the
    whole batch's `skips`; `med` holds `params`, which require grad."""
    total = {k: torch.zeros_like(v) for k, v in params.items()}
    for s in range(0, pixel_id.shape[0], grad_block):
        sl = slice(s, s + grad_block)
        o, d, st = sc.camera_rays(pixel_id[sl], sample_idx[sl], width, height, seed)
        L = volume.radiance(sc, med, o, d, _Replayed(st.state, st.dtype, skips), block)
        L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        grads = torch.autograd.grad((L * cot[sl]).sum(), list(params.values()), allow_unused=True)
        for k, g in zip(params, grads):
            if g is not None:
                total[k] += g
    return total
