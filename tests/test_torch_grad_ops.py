"""Gradient parity of the port's differentiable pieces below the render,
against the JAX package on the CPU: `packed_gather`'s backward against
`jax.vjp` of JAX's `packed_gather` (its CPU path: `gather_rows` and the
custom VJP), the backward kernels' summation order (`packed_gather_bwd_emulated`)
against the plain version, `refine_hit` against JAX's `_refine_passthrough`
VJP, and the shade-pack interaction (a pack forced on the CPU with the plain
gather) against JAX's `pack_interaction` + `packed_gather`.

Tolerances, stated once:
  * gather forward: bit-equal; gather backward 1e-6 relative + 1e-6 of the
    largest row (JAX adds in float32 in lane order, the plain version in
    float64);
  * the emulation of the kernels' order against the float64 plain version:
    1e-5 relative + 1e-6 of the largest row (float32 folds of up to 40,000
    lanes, at most 32 terms a fold below the tile);
  * refine and pack-path VJPs: 1e-3 relative + 1e-5 of the largest entry
    (the JAX pack recomputes t / u / v from the Woop columns, the port keeps
    the intersector's, so the derivatives are taken a few ulps apart).
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.accel import traversal as jtrav
from cudatracerlib_tpu.ops import shade_gather as jsg
from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.scene import shade_pack as jsp
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu_torch.accel import traversal as ttrav
from cudatracerlib_tpu_torch.convert import flatten, scene_from_numpy
from cudatracerlib_tpu_torch.ops import shade_gather as tsg
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.scene import scene as tscene_mod
from cudatracerlib_tpu_torch.scene import shade_pack as tsp


def _close(got, ref, rtol, frac):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=frac * max(np.abs(ref).max(), 1e-30))


def _gather_inputs(n_rows=37, n=3000, cols=64, seed=0):
    """A table, indices with duplicates, out-of-range ids (negative and past
    the end) and long runs of one row, and a cotangent."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n_rows, cols)).astype(np.float32)
    idx = rng.integers(0, n_rows, n).astype(np.int32)
    idx[rng.random(n) < 0.3] = 5                       # one row hit by ~900 lanes
    idx[:7] = [-5, -1, n_rows, n_rows + 100, 0, n_rows - 1, -(2 ** 31)]
    g = rng.normal(size=(n, cols)).astype(np.float32)
    return table, idx, g


def test_packed_gather_vjp_matches_jax():
    table, idx, g = _gather_inputs()
    jout, vjp = jax.vjp(lambda t: jsg.packed_gather(t, jnp.asarray(idx)), jnp.asarray(table))
    (jgrad,) = vjp(jnp.asarray(g.T))              # JAX's output is (C, B)
    tt = torch.from_numpy(table).requires_grad_()
    tout = tsg.packed_gather(tt, torch.from_numpy(idx))
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout).T)
    tout.backward(torch.from_numpy(g))
    _close(tt.grad, jgrad, 1e-6, 1e-6)
    # rows no lane hit get exactly zero; every lane's cotangent lands once
    hit = np.zeros(table.shape[0], bool)
    hit[np.clip(idx, 0, table.shape[0] - 1)] = True
    assert (tt.grad.numpy()[~hit] == 0).all()
    np.testing.assert_allclose(tt.grad.numpy().sum(0), g.sum(0), rtol=1e-4, atol=1e-3)


def _edge_inputs(n_rows=37, cols=64):
    """Indices whose runs start and end on the kernels' edges: row 0 fills
    one 32-position block exactly, row 1 crosses two blocks, row 2 fills the
    rest of the first tile and all of the second (a row over two tiles of
    one group), row 3 starts on the next tile's first lane; the lanes are
    shuffled within each tile, rows past 4 get none."""
    T = tsg.BWD_TILE
    idx = np.repeat(np.arange(3, dtype=np.int32), [32, 44, 2 * T - 76])
    idx = np.concatenate([idx, np.full(T // 2, 3, np.int32)])
    rng = np.random.default_rng(1)
    for t0 in range(0, idx.size, T):
        rng.shuffle(idx[t0:t0 + T])
    return None, idx, rng.normal(size=(idx.size, cols)).astype(np.float32)


def _few_hot_inputs(n_rows=5, n=40000, cols=3):
    """A texture lookup's shape at a small size: C = 3 onto 5 rows, one row
    hit by half the lanes, runs of one row as coherent pixels give, over 157
    tiles (five ranges of the range kernel)."""
    rng = np.random.default_rng(2)
    idx = np.repeat(rng.integers(0, n_rows, n // 8), 8).astype(np.int32)
    idx[rng.random(n) < 0.5] = 1
    return None, idx, rng.normal(size=(n, cols)).astype(np.float32)


def _range_inputs(n_tiles, n_rows=37, cols=64):
    """`n_tiles` tiles of lanes (and a ragged one), so rows fold across ranges
    of the range kernel; row 4 is hit only in the last range."""
    n = n_tiles * tsg.BWD_TILE + 3000
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 4, n).astype(np.int32)
    idx[-500:] = 4
    return None, idx, rng.normal(size=(n, cols)).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "hot", "edges", "few_hot_c3", "ranges_of_32",
                                  "wide_ranges"])
def test_packed_gather_bwd_emulation(case):
    """The kernels' summation order (runs within 32-position blocks of a
    tile's (row, lane) order, then a row's blocks, tiles within a range and
    ranges, each folded in order) gives the plain version's sums, with rows
    crossing blocks, tiles and ranges (of 32 tiles, and of 33 past 1,024
    tiles), rows starting on a block or tile edge and rows no lane hit."""
    _, idx, g = {"random": lambda: _gather_inputs(),
                 "hot": lambda: _gather_inputs(n=9000, seed=1),
                 "edges": _edge_inputs,
                 "few_hot_c3": _few_hot_inputs,
                 "ranges_of_32": lambda: _range_inputs(256),
                 "wide_ranges": lambda: _range_inputs(1040)}[case]()
    n_rows = 5 if case == "few_hot_c3" else 37
    emu = tsg.packed_gather_bwd_emulated(torch.from_numpy(g), torch.from_numpy(idx), n_rows)
    plain = tsg.packed_gather_bwd_plain(torch.from_numpy(g), torch.from_numpy(idx), n_rows)
    _close(emu, plain.numpy(), 1e-5, 1e-6)
    hit = np.bincount(np.clip(idx, 0, n_rows - 1), minlength=n_rows) > 0
    assert (emu.numpy()[~hit] == 0).all()


def test_packed_gather_bwd_scratch_and_checks():
    """The scratch the kernels take, counted from the tile and range sizes,
    and the wrapper's refusals before any launch."""
    assert [tsg.bwd_range_tiles(t) for t in (1, 1024, 1025, 4096, 1 << 20)] == [
        32, 32, 33, 128, 1024]
    # 2^20 x 64 onto 6,624 rows: 4,096 tiles of 256 slots, 207 words, 32 ranges
    assert tsg.bwd_scratch_floats(64, 1 << 20, 6624) == (
        4096 * 256 * 64 + 2 * 4096 * 207 + 32 * 6624 * 64 + 6624)
    # 2^27 x 1 onto 32,769 rows (1,025 words, past 32 a column: row lists):
    # 524,288 tiles of 256 slots (partials and row lists), a row count a
    # tile, 512 ranges (16 words of range masks a row)
    assert tsg.bwd_scratch_floats(1, 1 << 27, 32769) == (
        2 * 524288 * 256 + 524288 + 512 * 32769 + 16 * 32769)
    # no lanes: only the range partials' and masks' rounding
    assert tsg.bwd_scratch_floats(3, 0, 5) == 0
    with pytest.raises(ValueError):
        tsg.bwd_launch_args(torch.zeros(4, 3), torch.zeros(4, dtype=torch.int32), 1 << 24)


# (lanes, columns, rows) of the gather backward's main-path shapes (PERF.md
# rows 5a-5j): pack, texture, Woop, pose Woop, verts, BDPT and light-tracer
# splats, the volume grid, a per-volume table, the filter splat, the atlas,
# the guiding deposit
_BWD_SHAPES = {"5a": (1 << 20, 64, 6624), "5b": (1 << 20, 3, 5), "5c": (1 << 20, 12, 6624),
               "5c_pose": (1 << 20, 12, 19796), "5i": (1 << 20, 9, 19796),
               "5d": (327_680, 3, 16_384), "5d_lt": (393_216, 3, 16_384),
               "5e": (134_217_728, 1, 32_769), "5f": (524_288, 3, 1),
               "5g": (9 << 20, 4, 65_537), "5h": (1 << 20, 3, 87_381),
               "5j": (655_360, 1, 32_768)}


@pytest.mark.parametrize("shape", sorted(_BWD_SHAPES))
def test_packed_gather_bwd_scratch_has_no_tiles_times_rows_term(shape):
    """At each main-path shape and at 1,000 and 100,000 more table rows, the
    scratch is at most the tile partials, a row list and count per tile, a
    quarter of g's words (the word masks, where the rule takes them) and
    ranges x rows x (C + 1): no term grows with tiles x rows past g (the
    tiles' row masks took 2 x tiles / 32 words a row at every shape). At
    the volume grid the whole scratch is under 1.2 GB (4.905 GB with the
    masks)."""
    n, cols, n_rows = _BWD_SHAPES[shape]
    n_tiles = -(-n // tsg.BWD_TILE)
    n_ranges = -(-n_tiles // tsg.bwd_range_tiles(n_tiles))
    for rows in (n_rows, n_rows + 1000, n_rows + 100_000):
        cap = min(tsg.BWD_TILE, rows)
        most = (n_tiles * cap * (cols + 1) + n_tiles + n * cols // 4
                + n_ranges * rows * (cols + 1) + 16)
        assert tsg.bwd_scratch_floats(cols, n, rows) <= most
    if shape == "5e":
        assert not tsg.bwd_word_masks(n_rows, cols)
        assert tsg.bwd_scratch_floats(cols, n, n_rows) * 4 < 1.2e9


@pytest.mark.parametrize("shape", sorted(_BWD_SHAPES))
def test_packed_gather_bwd_bands_cover_rows_and_fit(shape):
    """The range kernel's bands (`bwd_bands`, the .cu's `bands`) at each
    main-path shape and at tables of 1 to 2^23 rows: every row in exactly
    one band, a band's accumulators and hit bytes within BWD_BAND_WORDS (its
    shared memory, with a chunk's counts, tags and items and the tiles' offsets,
    within the 227 KB a block may take), and where 32 ranges
    leave SMs idle the bands raise the CTAs to BWD_FILL_CTAS while a band
    keeps BWD_MIN_BAND_ROWS rows."""
    n, cols, n_rows = _BWD_SHAPES[shape]
    for rows in (n_rows, 1, 255, 4097, 1 << 23):
        n_tiles = -(-n // tsg.BWD_TILE)
        n_bands, band_rows = tsg.bwd_bands(n_tiles, rows, cols)
        n_ranges = -(-n_tiles // tsg.bwd_range_tiles(n_tiles))
        covered = np.zeros(rows, np.int64)
        for b in range(n_bands):
            covered[b * band_rows:min((b + 1) * band_rows, rows)] += 1
        assert (covered == 1).all() and (n_bands - 1) * band_rows < rows
        words = band_rows * cols + -(-band_rows // 4)
        assert words <= tsg.BWD_BAND_WORDS
        rt = tsg.bwd_range_tiles(n_tiles)
        assert (words + 2 * 8 * 256 + 2 * 2048 + 2 * rt + 1) * 4 <= 232_448
        if rows >= tsg.BWD_MIN_BAND_ROWS * -(-tsg.BWD_FILL_CTAS // n_ranges):
            assert n_bands * n_ranges >= tsg.BWD_FILL_CTAS


def test_packed_gather_bwd_cpu_is_plain_and_checks():
    table, idx, g = _gather_inputs(cols=12)
    tg, ti = torch.from_numpy(g), torch.from_numpy(idx)
    assert torch.equal(tsg.packed_gather_bwd(tg, ti, 37), tsg.packed_gather_bwd_plain(tg, ti, 37))
    with pytest.raises(TypeError):
        tsg.packed_gather_bwd(tg, ti.long(), 37)
    with pytest.raises(ValueError):
        tsg.packed_gather_bwd(tg, ti, 0)


def test_gather_rows_backward_is_the_row_sum():
    """`gather_rows` (the per-lane lookups of small scene tables) gives the
    gradient of plain indexing, for (T,), (T, 3) and (T, 3, 3) tables, a 0-d
    index and no lanes; without a graph it is plain indexing."""
    rng = np.random.default_rng(6)
    idx = torch.from_numpy(rng.integers(0, 7, 5000))
    for shape in [(7,), (7, 3), (7, 3, 3)]:
        table = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        g = torch.from_numpy(rng.normal(size=(5000,) + shape[1:]).astype(np.float32))
        for ids in (idx, idx[0], idx[:0]):
            a, b = table.clone().requires_grad_(), table.clone().requires_grad_()
            out = tsg.gather_rows(a, ids)
            assert torch.equal(out, b[ids])
            out.backward(g[:ids.numel()].reshape(out.shape))
            b[ids].backward(g[:ids.numel()].reshape(out.shape))
            _close(a.grad, b.grad.numpy(), 1e-6, 1e-6)
    assert tsg.gather_rows(table, idx).grad_fn is None


def test_smith_g1_gradient_finite_along_the_normal():
    """At v = m = +z (tan^2 = 0) the masking term is 1 and its roughness
    gradient 0; the JAX form's sqrt(0) gives a NaN gradient there."""
    from cudatracerlib_tpu_torch.math import microfacet as tmf

    z = torch.tensor([[0.0, 0.0, 1.0]])
    for dist in (tmf.BECKMANN, tmf.GGX):
        a = torch.tensor([0.3], requires_grad=True)
        g1 = tmf.smith_g1(torch.tensor([dist], dtype=torch.int32), z, z, a, a)
        g1.sum().backward()
        assert float(g1.detach()) == 1.0 and torch.isfinite(a.grad).all() and float(a.grad) == 0.0


@pytest.fixture(scope="module")
def cornell():
    js = jcornell()
    return js, scene_from_numpy(flatten(js), device="cpu")


def _rays(ts, width=24, height=24, spp=2, seed=3):
    """Camera rays of a small pass: most hit, those through the light's gap
    and the room's edges miss or graze."""
    o, d, _, _ = tpt.camera_rays(ts, width, height, spp, seed)
    return o.numpy(), d.numpy()


def test_refine_hit_vjp_matches_jax(cornell):
    """refine_hit's backward (the closed-form Woop VJP, the table cotangent
    summed by row) against jax.vjp of JAX's refine_hit, with respect to the
    Woop rows and the ray, on the first hits of camera rays."""
    js, ts = cornell
    o, d = _rays(ts)
    rng = np.random.default_rng(4)
    gt, gb = rng.normal(size=o.shape[0]).astype(np.float32), rng.normal(
        size=(o.shape[0], 2)).astype(np.float32)
    jhit = jtrav.intersect_auto(js.bvh, jnp.asarray(o), jnp.asarray(d))

    def jf(woop, o_, d_):
        h = jtrav.refine_hit(js.bvh._replace(woop=woop), o_, d_, jhit)
        return h.t, h.bary

    _, vjp = jax.vjp(jf, js.bvh.woop, jnp.asarray(o), jnp.asarray(d))
    jw, jo, jd = vjp((jnp.asarray(gt), jnp.asarray(gb)))

    woop = ts.bvh.woop.clone().requires_grad_()
    to, td = torch.from_numpy(o).requires_grad_(), torch.from_numpy(d).requires_grad_()
    raw = ttrav.intersect_auto(ts.bvh, to.detach(), td.detach())
    h = ttrav.refine_hit(ts.bvh._replace(woop=woop), to, td, raw)
    np.testing.assert_array_equal(h.t.detach().numpy(), raw.t.numpy())   # forward untouched
    np.testing.assert_array_equal(h.prim.numpy(), np.asarray(jhit.prim))
    torch.autograd.backward([h.t, h.bary], [torch.from_numpy(gt), torch.from_numpy(gb)])
    valid = raw.valid.numpy()
    assert 0.5 < valid.mean() < 1.0
    _close(woop.grad, jw, 1e-3, 1e-5)
    _close(to.grad[valid], np.asarray(jo)[valid], 1e-3, 1e-5)
    _close(td.grad[valid], np.asarray(jd)[valid], 1e-3, 1e-5)
    assert (to.grad[~valid] == 0).all() and (td.grad[~valid] == 0).all()


def test_refine_hit_records_nothing_without_grad(cornell):
    _, ts = cornell
    o = torch.tensor([[0.0, -3.0, 1.0]])
    d = torch.tensor([[0.0, 1.0, 0.0]])
    raw = ttrav.intersect_auto(ts.bvh, o, d)
    assert ttrav.refine_hit(ts.bvh, o, d, raw) is raw


def test_pack_path_gradients_match_jax(cornell):
    """The shade-pack interaction, a pack forced on the CPU with the plain
    gather: gradients of a seeded linear function of (p, n_geo, frame, uv,
    t) with respect to the table (the Woop columns included) and the ray,
    against JAX's `pack_interaction` on JAX's `packed_gather`. The Woop rows'
    gradient through `build_shade_pack` equals the table's Woop columns'."""
    js, ts = cornell
    o, d = _rays(ts)
    n = o.shape[0]
    rng = np.random.default_rng(5)
    ws = {k: rng.normal(size=(n,) + s).astype(np.float32)
         for k, s in (("p", (3,)), ("n_geo", (3,)), ("s", (3,)), ("t_vec", (3,)), ("n", (3,)),
                      ("uv", (2,)), ("t", ()))}

    def loss(it, valid, xp):
        """Over the lanes that hit (the render masks the others, and there
        the JAX recompute differentiates row 0 while the port gives 0)."""
        w = {k: xp.asarray(v) if xp is jnp else torch.from_numpy(v) for k, v in ws.items()}
        parts = [it.p * w["p"], it.n_geo * w["n_geo"], it.frame.s * w["s"],
                 it.frame.t * w["t_vec"], it.frame.n * w["n"], it.uv * w["uv"]]
        total = sum(xp.where(valid[:, None], x, 0.0).sum() for x in parts)
        return total + xp.where(valid, it.t * w["t"], 0.0).sum()

    jpack = jsp.build_shade_pack(js)
    jhit = jtrav.intersect_auto(js.bvh, jnp.asarray(o), jnp.asarray(d))
    idx = jnp.maximum(jhit.prim, 0)

    def jf(table, o_, d_):
        it = jsp.pack_interaction(jsg.packed_gather(table, idx), o_, d_, jhit)
        return loss(it, jhit.valid, jnp)

    jgt, jgo, jgd = jax.grad(jf, argnums=(0, 1, 2))(jpack, jnp.asarray(o), jnp.asarray(d))

    woop = ts.bvh.woop.clone().requires_grad_()
    tscene = ts._replace(bvh=ts.bvh._replace(woop=woop))
    pack = tsp.build_shade_pack(tscene)
    table = pack.detach().requires_grad_()
    np.testing.assert_array_equal(table.detach().numpy(), np.asarray(jpack))
    to, td = torch.from_numpy(o).requires_grad_(), torch.from_numpy(d).requires_grad_()
    hit = tscene_mod.scene_intersect(ts, to, td)
    it, _ = tsp.hit_shading(ts, to, td, hit, table, (0,), flat=False)
    lt = loss(it, hit.valid, torch)
    lt.backward()
    valid = hit.valid.numpy()
    _close(table.grad, jgt, 1e-3, 1e-5)
    _close(to.grad[valid], np.asarray(jgo)[valid], 1e-3, 1e-5)
    _close(td.grad[valid], np.asarray(jgd)[valid], 1e-3, 1e-5)
    assert np.abs(table.grad[:, tsp.WOOP].numpy()).max() > 0

    # through the pack's build: the Woop rows get the table's Woop columns
    it, _ = tsp.hit_shading(ts, to.detach(), td.detach(), hit, pack, (0,), flat=False)
    loss(it, hit.valid, torch).backward()
    assert torch.equal(woop.grad, table.grad[:, tsp.WOOP])
