"""The 'scalar' volume transmittance op (ops/transmittance.py) on the CPU,
against the eager path of scene/media.py it replaces.

Tolerances, stated once: the plain forward is bit-equal to the eager
'scalar' branch (the same float32 operations in the same order), and so is
`transmittance` over the media; the plain backward's gradients of grid_data,
sigma_a and sigma_s are within 1e-6 of the field's largest entry of the
gradients autograd takes through the eager branch (the sums of the lanes run
in another order where the corners meet).
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import numpy as np
import pytest
import torch

from cudatracerlib_tpu_torch.convert import with_grad
from cudatracerlib_tpu_torch.ops import transmittance as tr_op
from cudatracerlib_tpu_torch.scene import media as tm
from cudatracerlib_tpu_torch.utils.timing import counters, reset_counters

N = 4096
PATHS = ["grid_data", "sigma_a", "sigma_s"]


def _plume(res=8):
    return tm.Media.build(tm.plume_records(np.array([-1.0, -1.0, -1.0]), np.array([1.0, 1.0, 1.0]),
                                           res=res), device="cpu")


def _boxy():
    """A scalar grid of another resolution on each axis, with sigma_a and
    sigma_s of their own per channel."""
    dens = np.random.default_rng(4).uniform(0.1, 2.0, (9, 6, 5)).astype(np.float32)
    return tm.Media.build([dict(type=tm.GRID, sigma_a=[0.3, 0.2, 0.1], sigma_s=[0.5, 0.6, 0.7],
                                box_min=[-0.8, 0.2, 0.1], box_max=[0.7, 1.7, 1.9],
                                density=dens)], device="cpu")


MEDIA = {"plume8": _plume, "plume32": lambda: _plume(32), "boxy": _boxy}


def _rays(seed, n=N):
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-1.5, 2.0, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    t_max = torch.from_numpy(rng.uniform(0.0, 4.0, n).astype(np.float32))
    return o, d, t_max


def _eager(media, o, d, t_min, t_max):
    """The eager 'scalar' branch over the media, as `transmittance` ran it."""
    tr = torch.ones(o.shape[:-1] + (3,))
    for v in range(media.count):
        tr = tr * tm._eager_factor(media, v, media.modes[v][0], media.modes, o, d, t_min, t_max)
    return tr


def _vol(media, v=0):
    return tr_op.Grid(media.box_min[v], media.box_max[v], media.active[v], media.modes[v][1],
                      media.modes[v][3])


@pytest.mark.parametrize("name", sorted(MEDIA))
@pytest.mark.parametrize("t_min", [1e-3, "tensor"])
def test_plain_forward_bit_equal_to_eager(name, t_min):
    media = MEDIA[name]()
    assert media.modes[0][0] == "scalar"
    o, d, t_max = _rays(1)
    if t_min == "tensor":
        t_min = torch.from_numpy(np.random.default_rng(2).uniform(0, 0.5, N).astype(np.float32))
    ref = _eager(media, o, d, t_min, t_max)
    st = media.sigma_a[0] + media.sigma_s[0]
    out, acc = tr_op.transmittance_plain(_vol(media), media.grid_data, st, o, d, t_min, t_max)
    assert torch.equal(out, ref)
    assert torch.equal(tr_op.transmittance(_vol(media), media.grid_data, st, o, d, t_min, t_max),
                       ref)
    assert torch.equal(tm.transmittance(media, o, d, t_min, t_max, media.modes), ref)
    assert bool((ref < 1).any()) and bool((ref == 1).any())
    assert acc.shape == (N,) and bool((acc > 0).any())


def test_batched_lanes_keep_their_shape():
    media = _plume()
    o, d, t_max = _rays(3, 1024)
    ref = _eager(media, o, d, 1e-3, t_max)
    got = tm.transmittance(media, o.view(32, 32, 3), d.view(32, 32, 3), 1e-3,
                           t_max.view(32, 32), media.modes)
    assert got.shape == (32, 32, 3) and torch.equal(got.view(-1, 3), ref)


def test_qmax_rounds_as_the_eager_path():
    for r in (1, 2, 5, 6, 9, 32, 64, 127, 1000, 4097):
        rf = torch.tensor([float(r)])
        want = torch.clamp(rf - 1, min=0.0) * (1 - 1e-6)
        assert tr_op.qmax((r,)) == [float(want)], r


@pytest.mark.parametrize("name", sorted(MEDIA))
@pytest.mark.parametrize("seed", [5, 6])
def test_plain_backward_matches_eager_autograd(name, seed):
    media = MEDIA[name]()
    o, d, t_max = _rays(seed)
    w = torch.from_numpy(np.random.default_rng(seed + 10).normal(size=(N, 3)).astype(np.float32))
    got_m, ref_m = with_grad(media, PATHS), with_grad(media, PATHS)
    (tm.transmittance(got_m, o, d, 1e-3, t_max, media.modes) * w).sum().backward()
    (_eager(ref_m, o, d, 1e-3, t_max) * w).sum().backward()
    for p in PATHS:
        got, ref = getattr(got_m, p).grad, getattr(ref_m, p).grad
        scale = float(ref.abs().max())
        assert scale > 0, p
        assert float((got - ref).abs().max()) <= 1e-6 * scale, p


def test_backward_of_sigma_alone_and_of_grid_alone():
    media = _plume()
    o, d, t_max = _rays(7)
    for paths in (["sigma_a"], ["grid_data"]):
        got_m, ref_m = with_grad(media, paths), with_grad(media, paths)
        tm.transmittance(got_m, o, d, 1e-3, t_max, media.modes).sum().backward()
        _eager(ref_m, o, d, 1e-3, t_max).sum().backward()
        for p in paths:
            ref = getattr(ref_m, p).grad
            err = float((getattr(got_m, p).grad - ref).abs().max())
            assert err <= 1e-6 * float(ref.abs().max()), p


def test_plain_backward_sums_the_grid_through_the_gather_backward(monkeypatch):
    """The grid's cotangent reaches packed_gather_bwd as (B * 32 * 8, 1)
    lanes in the eager layout (lane, step, corners x, y, z)."""
    from cudatracerlib_tpu_torch.ops import shade_gather

    media = _plume()
    o, d, t_max = _rays(8, 256)
    seen, real = [], shade_gather.packed_gather_bwd

    def record(g, idx, n_rows):
        seen.append((g.clone(), idx.clone(), n_rows))
        return real(g, idx, n_rows)

    monkeypatch.setattr(shade_gather, "packed_gather_bwd", record)
    for fn in (lambda m: tm.transmittance(m, o, d, 1e-3, t_max, media.modes),
               lambda m: _eager(m, o, d, 1e-3, t_max)):
        m = with_grad(media, ["grid_data"])
        fn(m).sum().backward()
    (g_op, i_op, n_op), (g_eager, i_eager, n_eager) = seen
    assert g_op.shape == (256 * tr_op.TAU_STEPS * 8, 1) and n_op == n_eager
    assert torch.equal(i_op, i_eager)
    assert float((g_op - g_eager).abs().max()) <= 1e-6 * float(g_eager.abs().max())


def _counted_eager(fn):
    reset_counters()
    fn()
    return counters().get("media.transmittance.eager", 0)


def test_dispatch_sends_other_modes_to_the_eager_path():
    o, d, t_max = _rays(9, 512)
    plume = _plume()
    assert _counted_eager(lambda: tm.transmittance(plume, o, d, 1e-3, t_max, plume.modes)) == 0
    # no modes: the generic path
    assert _counted_eager(lambda: tm.transmittance(plume, o, d, 1e-3, t_max)) == 1
    const = tm.Media.build([dict(type=tm.HOMOGENEOUS, sigma_a=[0.2] * 3, sigma_s=[0.1] * 3)],
                           device="cpu")
    assert const.modes[0][0] == "const"
    assert _counted_eager(lambda: tm.transmittance(const, o, d, 1e-3, t_max, const.modes)) == 1
    rng = np.random.default_rng(1)
    gen = tm.Media.build([dict(type=tm.GRID, sigma_a_grid=rng.random((4, 4, 4)).astype(np.float32),
                               sigma_s_grid=rng.random((4, 4, 4)).astype(np.float32))],
                         device="cpu")
    assert gen.modes[0][0] == "gen"
    assert _counted_eager(lambda: tm.transmittance(gen, o, d, 1e-3, t_max, gen.modes)) == 1
    both = tm.Media.build(tm.plume_records([-1] * 3, [1] * 3, res=8)
                          + [dict(type=tm.HOMOGENEOUS, box_min=[0, 0, 0], box_max=[2, 2, 2])],
                          device="cpu")
    got = []
    assert _counted_eager(lambda: got.append(tm.transmittance(both, o, d, 1e-3, t_max,
                                                              both.modes))) == 1
    assert torch.equal(got[0], _eager(both, o, d, 1e-3, t_max))


@pytest.mark.parametrize("which", ["o", "d", "t_max", "box_min"])
def test_dispatch_sends_rays_that_carry_a_gradient_to_the_eager_path(which):
    o, d, t_max = _rays(10, 512)
    media = _plume()
    args = {"o": o.clone(), "d": d.clone(), "t_max": t_max.clone()}
    if which == "box_min":
        media = with_grad(media, ["box_min"])
    else:
        args[which].requires_grad_()
    got = []
    assert _counted_eager(lambda: got.append(tm.transmittance(
        media, args["o"], args["d"], 1e-3, args["t_max"], media.modes))) == 1
    assert torch.equal(got[0].detach(), _eager(_plume(), o, d, 1e-3, t_max))
    got[0].sum().backward()
    grad = media.box_min.grad if which == "box_min" else args[which].grad
    assert grad is not None and bool(torch.isfinite(grad).all())
    with torch.no_grad():  # no graph recorded: the op
        assert _counted_eager(lambda: tm.transmittance(
            media, args["o"], args["d"], 1e-3, args["t_max"], media.modes)) == 0


def _edge_rays():
    """Rays against the plume's box [-0.95, 0.95]^3: one that misses it, one
    that starts inside it, a zero-length segment at its centre, t_max <
    t_min, one along an axis (d components 0), one ending inside the box."""
    o = torch.tensor([[-2.0, 3.0, 0.0], [0.1, -0.2, 0.3], [0.0, 0.0, 0.0], [-2.0, 0.0, 0.0],
                      [-2.0, 0.1, 0.2], [-2.0, 0.1, 0.2]])
    d = torch.nn.functional.normalize(torch.tensor(
        [[1.0, 0.0, 0.0], [0.3, 0.5, -0.8], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0],
         [1.0, 0.2, 0.0]]), dim=-1)
    t_min = torch.tensor([0.0, 0.0, 0.5, 3.0, 0.0, 0.0])
    t_max = torch.tensor([5.0, 5.0, 0.5, 1.0, 5.0, 1.5])
    return o, d, t_min, t_max


def test_edge_rays():
    media = _plume()
    o, d, t_min, t_max = _edge_rays()
    ref = _eager(media, o, d, t_min, t_max)
    got = tm.transmittance(media, o, d, t_min, t_max, media.modes)
    assert torch.equal(got, ref)
    miss, inside, zero, reversed_, axis, ends = got
    assert torch.equal(miss, torch.ones(3)) and torch.equal(zero, torch.ones(3))
    assert torch.equal(reversed_, torch.ones(3))
    for tr in (inside, axis, ends):
        assert bool((tr < 1).all()) and bool((tr > 0).all())
    assert bool((axis < ends).all())  # the whole box against part of it
    m = with_grad(media, PATHS)
    (tm.transmittance(m, o, d, t_min, t_max, media.modes) * torch.arange(1.0, 4.0)).sum().backward()
    r = with_grad(media, PATHS)
    (_eager(r, o, d, t_min, t_max) * torch.arange(1.0, 4.0)).sum().backward()
    for p in PATHS:
        ref_g = getattr(r, p).grad
        assert float((getattr(m, p).grad - ref_g).abs().max()) <= 1e-6 * float(ref_g.abs().max())


def test_inactive_volume_passes_everything():
    media = _plume()
    media = media._replace(active=torch.zeros_like(media.active))
    o, d, t_max = _rays(11, 256)
    assert torch.equal(tm.transmittance(media, o, d, 1e-3, t_max, media.modes),
                       torch.ones(256, 3))


def test_kernel_wrapper_refuses_other_devices():
    media = _plume()
    o, d, t_max = _rays(12, 16)
    with pytest.raises(ValueError):
        tr_op._forward(_vol(media), media.grid_data, media.sigma_a[0], o.to("meta"),
                       d.to("meta"), 1e-3, t_max.to("meta"), keep_acc=False)
