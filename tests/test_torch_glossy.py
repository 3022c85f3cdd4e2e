"""The glossy scene (bench config 2) in the port against the JAX package:
the scene arrays, the BVH stack-walk oracle, the shade pack and the pack
path of `surface_bounce`, all on the CPU.

Tolerances:
  * scene and shade-pack arrays exactly equal (one numpy construction, the
    same native SBVH builder);
  * oracle hits: `valid` equal on every ray, `prim` equal or pointing at
    identical Woop rows (leaf padding duplicates triangles); on equal rows t
    within 1e-5 relative and the barycentrics within 1e-4: XLA fuses the JAX
    Woop test and may contract its products into FMAs, and u = (r0.o + w) +
    t (r0.d) cancels terms of order ten on the 12-unit floor;
  * the pack path and the per-lane-gather path of `surface_bounce`: equal
    outputs (the same values, read from another table); the per-lane
    state that the engines keep only where the path continues (o, d,
    throughput, pdf, delta flag, eta scale) is compared on those lanes,
    since a missed lane reads triangle 0's material from the pack and
    material 0 from the gathers, as in the JAX package.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.accel import traversal as jtrav
from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.scene import shade_pack as jsp
from cudatracerlib_tpu.scene.shapes import glossy_scene as jglossy
from cudatracerlib_tpu_torch.accel import traversal as ttrav
from cudatracerlib_tpu_torch.convert import flatten
from cudatracerlib_tpu_torch.ops import intersect_bvh as tbvh
from cudatracerlib_tpu_torch.ops import shade_gather as tsg
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import wavefront as twf
from cudatracerlib_tpu_torch.sampling.rng import Sampler as TSampler
from cudatracerlib_tpu_torch.scene import scene as tscene_mod
from cudatracerlib_tpu_torch.scene import shade_pack as tsp
from cudatracerlib_tpu_torch.scene.shapes import glossy_scene as tglossy


@pytest.fixture(scope="module")
def scenes():
    return jglossy(), tglossy(device="cpu")


@pytest.fixture(scope="module")
def rays(scenes):
    """Camera rays of a 48x48 pass and the first-bounce rays they spawn."""
    _, ts = scenes
    cfg = tpt.specialize_config(ts, tpt.PTConfig(max_depth=5))
    ids = torch.arange(48 * 48 * 2)
    _, o, d, state = twf._camera_ray(ts, ids, 3, 48, 48)
    n = o.shape[0]
    out = tpt.surface_bounce(ts, cfg, o=o, d=d, active=torch.ones(n, dtype=torch.bool),
                             throughput=torch.ones(n, 3), prev_pdf=torch.zeros(n),
                             prev_delta=torch.ones(n, dtype=torch.bool), eta_scale=torch.ones(n),
                             sampler=TSampler(state=state), depth=0)
    c = out.cont
    return torch.cat([o, out.o[c]]), torch.cat([d, out.d[c]])


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def test_glossy_arrays_exactly_equal(scenes):
    js, ts = scenes
    a, b = flatten(js), flatten(ts)
    assert set(b) <= set(a)
    for k in sorted(b):
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)
    assert ts.bvh.woop.shape == (6624, 12) and ts.bvh.nodes.shape == (1655, 16)
    assert ts.bvh.woop.shape[0] > ttrav.DENSE_MAX_TRIS
    assert ts.lights.env_map.shape == (64, 128, 3)


def test_glossy_specialization(scenes):
    js, ts = scenes
    want = jpt.specialize_config(js, jpt.PTConfig(max_depth=5))
    got = tpt.specialize_config(ts, tpt.PTConfig(max_depth=5))
    for f in tpt.PTConfig._fields:
        assert getattr(got, f) == getattr(want, f), f
    assert got.bsdf_types == (4, 5, 6, 8) and got.light_types == (4,)
    assert got.tex_types == (0, 1) and got.flat_shading


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_oracle_matches_jax(scenes, rays, any_hit):
    js, ts = scenes
    o, d = rays
    t_max = 1e30 if not any_hit else 4.0
    want = jtrav.intersect(js.bvh, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                           1e-4, t_max, any_hit=any_hit)
    got, n_inner, n_leaf, n_tpass = ttrav.intersect(ts.bvh, o, d, 1e-4, t_max,
                                                    any_hit=any_hit, with_counts=True)
    v = got.valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(want.valid))
    assert 0.1 < v.mean() < 0.99
    woop = ts.bvh.woop.numpy()
    gp, wp = got.prim.numpy(), np.asarray(want.prim)
    assert (gp[~v] == -1).all()
    diff = v & (gp != wp)
    assert (woop[gp[diff]] == woop[wp[diff]]).all(), "prim differs at distinct Woop rows"
    if not any_hit:
        same = v & (gp == wp)
        np.testing.assert_allclose(got.t.numpy()[same], np.asarray(want.t)[same], rtol=1e-5)
        np.testing.assert_allclose(got.bary.numpy()[same], np.asarray(want.bary)[same],
                                   rtol=0, atol=1e-4)
    # every ray visits the root; the counts are what the bound in PERF.md reads
    assert (n_inner >= 1).all() and (n_leaf >= got.valid.long()).all()
    # a hit row passed the t test; no leaf has more than LEAF_SIZE such rows
    assert (n_tpass >= got.valid.long()).all()
    assert (n_tpass <= ttrav.LEAF_SIZE * n_leaf).all()


def test_intersect_bvh_cpu_takes_the_oracle_and_counts_no_launch(scenes, rays):
    _, ts = scenes
    o, d = rays[0][:512], rays[1][:512]
    before = dict(tbvh.launches)
    for any_hit in (False, True):
        got = tbvh.intersect_bvh(ts.bvh, o, d, 1e-4, torch.inf, any_hit=any_hit)
        want = ttrav.intersect(ts.bvh, o, d, 1e-4, torch.inf, any_hit=any_hit)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert tbvh.launches == before
    assert torch.isinf(got.t[~got.valid]).all()  # misses keep t_max unclamped
    with pytest.raises(TypeError):
        tbvh.intersect_bvh(ts.bvh, o.double(), d.double())
    with pytest.raises(ValueError):
        tbvh.intersect_bvh(ts.bvh, o[:, :2], d[:, :2])


def test_shade_pack_equals_jax(scenes):
    js, ts = scenes
    want = np.asarray(jsp.build_shade_pack(js))
    got = tsp.build_shade_pack(ts)
    assert got.shape == (6624, tsp.COLS) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    for name in ("VERTS", "NORMALS", "UVS", "N_FACE", "WOOP", "COND_ETA", "COND_K"):
        assert getattr(tsp, name) == getattr(jsp, name), name
    assert (tsp.MAT_ID, tsp.LIGHT_ID, tsp.N_USED, tsp.COLS) == (
        jsp.MAT_ID, jsp.LIGHT_ID, jsp.N_USED, jsp.COLS)
    # on the CPU the pack path is off, as it is in the JAX package
    assert not tsp.pack_enabled(ts)


def test_packed_gather_plain_and_cpu_wrapper(scenes):
    _, ts = scenes
    pack = tsp.build_shade_pack(ts)
    idx = torch.tensor([0, 5, -3, 6623, 6624, 10 ** 6, 17], dtype=torch.int32)
    before = dict(tsg.launches)
    got = tsg.packed_gather(pack, idx)
    assert tsg.launches == before
    assert torch.equal(got, pack[torch.tensor([0, 5, 0, 6623, 6623, 6623, 17])])
    assert torch.equal(tsg.packed_gather_plain(pack, idx), got)
    assert tsp.cols(got, tsp.WOOP).shape == (7, 12)
    with pytest.raises(TypeError):
        tsg.packed_gather(pack, idx.long())
    with pytest.raises(ValueError):
        tsg.packed_gather(pack[:, :63], idx)


@pytest.mark.parametrize("depth", [0, 5])
def test_pack_path_equals_take_path(scenes, rays, depth):
    """`surface_bounce` with the shade pack (what the card runs for glossy)
    against the per-lane gathers (what the CPU runs), on the same rays."""
    _, ts = scenes
    cfg = tpt.specialize_config(ts, tpt.PTConfig(max_depth=5))
    o, d = rays
    n = o.shape[0]
    rng = np.random.default_rng(depth)
    kw = dict(o=o, d=d, active=torch.from_numpy(rng.random(n) < 0.9),
              throughput=torch.from_numpy(rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)),
              prev_pdf=torch.from_numpy(rng.uniform(0, 2, n).astype(np.float32)),
              prev_delta=torch.from_numpy(rng.random(n) < 0.5), eta_scale=torch.ones(n),
              sampler=TSampler.create(5, torch.arange(n), 0), depth=depth)
    take = tpt.surface_bounce(ts, cfg, pack=None, **kw)
    packed = tpt.surface_bounce(ts, cfg, pack=tsp.build_shade_pack(ts), **kw)
    c = take.cont
    for f in tpt.BounceOut._fields:
        a, b = getattr(packed, f), getattr(take, f)
        if f == "sampler":
            a, b = a.state, b.state
        if f in ("o", "d", "throughput", "bs_pdf", "delta_now", "eta_scale"):
            a, b = a[c], b[c]
        assert torch.equal(a, b), f
    assert 0.1 < take.cont.float().mean() < 0.99
    assert (take.L_add > 0).any()

    # the interaction itself against make_interaction: equal when flat; not
    # flat, the pack's n_geo is the stored face normal (as in the JAX pack
    # path) where make_interaction normalizes a cross product: within 1e-6
    hit = tscene_mod.scene_intersect(ts, o, d)
    rows = tsg.packed_gather(tsp.build_shade_pack(ts), torch.clamp(hit.prim, min=0))
    for flat in (True, False):
        a = tsp.pack_interaction(rows, o, d, hit, flat=flat)
        b = tscene_mod.make_interaction(ts, o, d, hit, flat=flat)
        for x, y in zip(a, b):
            for xx, yy in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
                if flat:
                    assert torch.equal(xx, yy)
                else:
                    torch.testing.assert_close(xx, yy, rtol=0, atol=1e-6)
