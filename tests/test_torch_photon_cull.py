"""The photon density kernel's warp x chunk cull, in its plain emulation
`warp_chunk_cull`, on the CPU.

The kernel skips, for each warp of 32 cell-sorted queries, the 32-photon
chunks of a staged tile none of whose photons lies within the radius of the
warp's valid queries' box. These tests hold that cull to the plain pair
weights (`pair_weights`, the kernel's float32 arithmetic) of every (query,
photon) pair: every pair with w > 0 lies in a kept (warp, chunk), and every
pair of a dropped one weighs exactly +0.0, bit for bit, so skipping it
leaves each sum unchanged. Cases: the cloud and hotspot of
tests/test_torch_photon_gather.py (a cloud whose first block no tile
reaches), and a boundary case with photons at exactly the radius from
queries and on the faces of the warps' boxes, an all-invalid warp, and a
query count that is no multiple of 32.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import numpy as np
import pytest
import torch

from cudatracerlib_tpu_torch.ops import photon_gather as tpg
from test_torch_photon_gather import CASES, RADIUS, _photons, _queries, _t, _tiles

R_EDGE = 0.0625   # a power of two: q + r and r^2 are exact in float32


def _boundary():
    """Queries on a 1/64 grid of the floor (300, not a multiple of 32; the
    warp of queries 64-95 all invalid), photons at exactly R_EDGE from
    queries along each axis, one float step inside and outside, on the
    faces of warp boxes, and a random floor cloud; 10% of photons invalid."""
    rng = np.random.default_rng(5)
    n_q = 300
    ij = np.stack(np.meshgrid(np.arange(20), np.arange(15), indexing="ij"), -1).reshape(-1, 2)
    q = np.zeros((n_q, 3), np.float32)
    q[:, :2] = (16 + ij[:n_q]).astype(np.float32) / np.float32(64)
    qv = rng.random(n_q) >= 0.1
    qv[64:96] = False
    anchors = q[rng.choice(n_q, 120, replace=False)]
    offs = []
    for axis in (0, 1):
        for sign in (1.0, -1.0):
            e = np.zeros(3, np.float32)
            e[axis] = sign * R_EDGE
            at = anchors + e
            step = np.nextafter(at[:, axis], np.float32(sign * np.inf)).astype(np.float32)
            out, inn = at.copy(), at.copy()
            out[:, axis] = step
            inn[:, axis] = np.nextafter(at[:, axis], np.float32(-sign * np.inf))
            offs += [at, out, inn]
    faces = []
    for w in range(0, n_q - n_q % 32, 32):   # photons on each warp box's faces and r beyond
        lo, hi = q[w:w + 32].min(0), q[w:w + 32].max(0)
        for x in (lo[0], hi[0], lo[0] - R_EDGE, hi[0] + R_EDGE):
            faces.append([x, (lo[1] + hi[1]) / 2, 0.0])
    cloud = np.zeros((900, 3), np.float32)
    cloud[:, :2] = rng.uniform(0.2, 0.6, (900, 2))
    pos = np.concatenate(offs + [np.float32(faces), cloud]).astype(np.float32)
    n = pos.shape[0]
    normal = np.tile(np.float32([[0, 0, 1]]), (n, 1))
    wi = rng.normal(size=(n, 3)).astype(np.float32) + 1.5 * normal
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    power = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    valid = rng.random(n) >= 0.1
    tiles, aabbs = tpg.build_photon_tiles(_t(pos), _t(power), _t(normal), _t(valid),
                                          np.zeros(3, np.float32), np.ones(3, np.float32), 14,
                                          wi=_t(wi.astype(np.float32)))
    qn = np.tile(np.float32([[0, 0, 1]]), (n_q, 1))
    return tiles, aabbs, _t(q), _t(qn), _t(qv), R_EDGE


@pytest.fixture(scope="module", params=sorted(CASES) + ["boundary"])
def cull_case(request):
    if request.param == "boundary":
        return request.param, _boundary()
    n_ph, n_q, hot = CASES[request.param]
    q, qn, qv = _queries(2, n_q, hot)
    tiles, aabbs = _tiles(_photons(1, n_ph, hot))
    return request.param, (tiles, aabbs, _t(q), _t(qn), _t(qv), RADIUS)


def _all_pairs(tiles, aabbs, q, qn, qv, radius):
    """Per pair (query, photon slot): the plain weight (B, n_tiles * PT) and
    whether the kernel weighs it (its (warp, chunk) is kept)."""
    _, inv_r2 = tpg._radius2(radius)
    ph = tiles.transpose(0, 1).reshape(16, -1)                     # (16, n_tiles * PT)
    w = tpg.pair_weights(ph[None], q[:, :, None], qn[:, :, None], inv_r2)
    keep, pairs = tpg.warp_chunk_cull(tiles, aabbs, q, qv, radius)
    B = q.shape[0]
    kept = keep[torch.arange(B) // tpg.WARP].repeat_interleave(tpg.CHUNK, dim=-1).reshape(B, -1)
    return w, kept, keep, pairs


def test_cull_keeps_every_pair_with_weight(cull_case):
    name, (tiles, aabbs, q, qn, qv, radius) = cull_case
    w, kept, keep, _ = _all_pairs(tiles, aabbs, q, qn, qv, radius)
    positive = (w > 0) & qv[:, None]
    assert positive.any(1).float()[qv].mean() > 0.5
    assert not (positive & ~kept).any()
    assert (~keep).any(), "the cull drops nothing here"
    if name == "boundary":
        # photons at exactly r weigh 0, one float step inside weighs > 0
        assert ((w == 0) & kept & qv[:, None]).any() and positive.any()
        assert not keep[2].any(), "a warp with no valid query keeps a chunk"
        assert keep[0].any() and keep[9].any()               # the last, partial warp too


def test_cull_drops_only_exact_zero_weights(cull_case):
    _, (tiles, aabbs, q, qn, qv, radius) = cull_case
    w, kept, _, _ = _all_pairs(tiles, aabbs, q, qn, qv, radius)
    dropped = w[~kept & qv[:, None]]     # an invalid query's sums are 0 whatever it weighs
    assert dropped.numel() > 0
    assert (dropped.view(torch.int32) == 0).all(), "a dropped pair's weight is not +0.0"
    # and the kernel's sums over kept pairs equal the plain version's over
    # its block-culled pairs, up to the order of the sums
    flux, sw = tpg.photon_density_plain(tiles, aabbs, q, qn, qv, radius)
    wk = torch.where(kept & qv[:, None], w, 0.0).double()
    rows = tiles.transpose(0, 1).reshape(16, -1).double()
    ref = torch.stack([wk @ rows[4], wk @ rows[5], wk @ rows[6], wk.sum(1)], -1)
    np.testing.assert_allclose(sw.numpy(), ref[:, 3].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(flux.numpy(), ref[:, :3].numpy(), rtol=1e-5, atol=1e-6)


def test_cull_pairs_below_block_tile_pairs(cull_case):
    _, (tiles, aabbs, q, qn, qv, radius) = cull_case
    _, kept, keep, pairs = _all_pairs(tiles, aabbs, q, qn, qv, radius)
    assert pairs == int((kept & qv[:, None]).sum())
    block_tile = tpg.surviving_pairs(aabbs, q, qv, radius)
    assert 0 < pairs <= block_tile
    # a kept chunk lies in a tile its block keeps
    blocks = tpg.block_cull(aabbs, q, qv, radius)
    per_warp = blocks.repeat_interleave(tpg.BQ // tpg.WARP, dim=0)[:keep.shape[0]]
    assert not (keep.any(-1) & ~per_warp).any()


def test_cull_counts_are_nested(cull_case):
    _, (tiles, aabbs, q, qn, qv, radius) = cull_case
    w, kept, _, pairs = _all_pairs(tiles, aabbs, q, qn, qv, radius)
    c = tpg.cull_counts(tiles, aabbs, q, qn, qv, radius)
    assert c["warp_chunk"] == pairs and c["block_tile"] == tpg.surviving_pairs(aabbs, q, qv, radius)
    assert c["positive"] == int(((w > 0) & qv[:, None]).sum()) > 0
    assert c["positive"] <= c["within_r"] <= c["warp_chunk"] <= c["block_tile"]
    assert int(c["tiles_per_block"].sum()) == int(tpg.block_cull(aabbs, q, qv, radius).sum())
