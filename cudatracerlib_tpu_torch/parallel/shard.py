"""Multi-rank rendering and differentiable training over torch.distributed
(port of cudatracerlib_tpu/parallel/shard.py).

  * rays shard over a ("dp", "sp") rank mesh (parallel/distributed.py):
    `dp` splits the pixels, `sp` the samples per pixel, with the JAX
    package's lanes: the (spp, n_px) sample grid, reshaped to (n_sp,
    spp / n_sp, n_dp, n_px / n_dp), gives rank (dp, sp) the block [sp, :,
    dp, :]. This is not `render`'s block-ordered layout, so a sharded image
    is `render`'s estimator on other lanes;
  * the scene is replicated: every rank holds all of it on its own device
    (`replicate_scene` broadcasts rank 0's);
  * each rank's film (rgb, weight) and ray count go into one flat float64
    buffer, summed over the mesh by one all-reduce (JAX: `psum` over `dp`,
    then `sp`). float64 carries the ray count exactly; a float32 sum of two
    ranks rounds as the float32 add would;
  * gradients: that all-reduce's backward is the identity, so each rank's
    backward gives the gradient of the (replicated) loss through its own
    lanes, and one all-reduce of the parameters' gradients after the
    backward sums them: the gradient of the whole image's loss, the same on
    every rank count, as `jax.grad` of the JAX package's psum gives.

The film adds samples with `index_add_`, atomic on the card: images of
different rank counts agree to float rounding, and their ray counts exactly.
Configs are specialized per scene (`specialize_config`), as the JAX
package's `make_sharded_ppm` does and as its bench runs `make_sharded_render`.

The volume engine shards too (`make_sharded_render_vol`, beyond the JAX
package's surface-only module): a rank traces its block of lanes as one
batch through volpath's own body, so delta tracking's trip count is the
rank's; its samples are summed per pixel into the whole image's flat
float64 film, summed over the mesh by one all-reduce whose backward is the
identity; `all_reduce_grads` then sums the optimised leaves' gradients in
one flat all-reduce after the backward, so an optimizer moves the same
parameters on every rank.

Each all-reduce runs under the span `ctl.shard.allreduce` and is counted
(`shard.allreduce.calls`, `shard.allreduce.bytes`: the buffer's bytes); a
sharded volume pass counts its rank's lanes (`shard.lanes`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .._tree import tree_map
from ..image import film as film_mod
from ..render import ppm as ppm_mod
from ..render import volpath
from ..render.path_tracer import PTConfig, specialize_config, trace_radiance
from ..sampling.rng import MASK, Sampler
from ..scene import media as media_mod
from ..scene import sensors
from ..scene.scene import Scene
from ..utils.timing import count, span, spanned
from .distributed import host_mesh

PHOTON_SEED_STRIDE = 0x9E3779B9   # rank r traces its photons at seed ^ (r * stride) (uint32)


def make_mesh(n_dp: int | None = None, n_sp: int = 1, device="cuda"):
    """("dp", "sp") DeviceMesh of n_dp x n_sp ranks over the live process
    group, which it must span (n_dp defaults to world // n_sp)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_dp is not None and n_dp * n_sp != n:
        raise ValueError(f"a {n_dp} x {n_sp} mesh does not span the {n} ranks of the group")
    return host_mesh(n_sp, device)


def _mesh_layout(mesh):
    """(dp, sp, n_dp, n_sp) of this rank; the mesh must span the group."""
    n_dp, n_sp = mesh.shape
    if n_dp * n_sp != dist.get_world_size():
        raise ValueError("the mesh must span every rank of the process group")
    dp, sp = mesh.get_coordinate()
    return dp, sp, n_dp, n_sp


def _shard_lanes(mesh, width: int, height: int, spp: int, device):
    """This rank's (pixel_id, sample_idx): block [sp, :, dp, :] of the
    (n_sp, spp / n_sp, n_dp, n_px / n_dp) reshape of the sample grid
    pixel_id = tile(arange(n_px), spp), sample_idx = repeat(arange(spp), n_px)."""
    dp, sp, n_dp, n_sp = _mesh_layout(mesh)
    n_px = width * height
    if n_px % n_dp or spp % n_sp:
        raise ValueError(f"{n_px} pixels must divide over dp = {n_dp} and {spp} spp over "
                         f"sp = {n_sp}")
    m, k = n_px // n_dp, spp // n_sp
    pixel_id = torch.arange(dp * m, (dp + 1) * m, device=device).repeat(k)
    sample_idx = torch.arange(sp * k, (sp + 1) * k, device=device).repeat_interleave(m)
    return pixel_id, sample_idx


def _all_reduce(x):
    """x summed over the process group in place (one all-reduce, under the
    span `ctl.shard.allreduce`, counted by call and buffer bytes)."""
    count("shard.allreduce.calls")
    count("shard.allreduce.bytes", x.numel() * x.element_size())
    with span("ctl.shard.allreduce"):
        dist.all_reduce(x)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Sum over the process group whose backward is the identity: the loss
    above it is replicated, so each rank's cotangent is already the whole
    one (an all-reduce of it would scale the gradient by the rank count)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g


def _film_sum(film: film_mod.Film, n_rays=None):
    """The mesh's summed (rgb, weight[, n_rays]) from this rank's film: one
    all-reduce of one flat float64 buffer."""
    H, W = film.weight.shape
    parts = [film.rgb.reshape(-1), film.weight.reshape(-1)]
    if n_rays is not None:
        parts.append(n_rays.detach().reshape(1).to(film.rgb.dtype))
    total = _AllReduceSum.apply(torch.cat([p.double() for p in parts]))
    rgb = total[:H * W * 3].float().reshape(H, W, 3)
    weight = total[H * W * 3:H * W * 4].float().reshape(H, W)
    if n_rays is None:
        return rgb, weight
    return rgb, weight, total[-1].round().to(torch.int64)


def _render_shard(scene: Scene, pixel_id, sample_idx, seed, width: int, height: int,
                  config: PTConfig):
    """This rank's lanes -> the mesh's summed (rgb, weight, n_rays)."""
    sampler = Sampler.create(int(seed) & MASK, pixel_id, sample_idx)
    px = (pixel_id % width).to(torch.float32)
    py = (pixel_id // width).to(torch.float32)
    sampler, jitter = sampler.next_2d()
    film_uv = torch.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
    sampler, u_ap = sampler.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, film_uv, u_ap)
    L, _, n_rays, _ = trace_radiance(scene, o, d, sampler, config, with_stats=True)
    film = film_mod.Film.create(height, width, device=o.device)
    film = film_mod.add_samples(film, pixel_id, L * w_cam)
    return _film_sum(film, n_rays)


def make_sharded_render(mesh, width: int, height: int, spp: int,
                        config: PTConfig = PTConfig(), with_stats: bool = False):
    """fn(scene, seed) -> the (H, W, 3) image, summed over the mesh (with
    `with_stats`: (image, rays traced over every rank, an int64 tensor)), on
    the scene's device. Pixels shard over `dp`, samples over `sp`; every
    rank gets the same result. Differentiable in the scene's tensors that
    require grad (see `make_train_step`)."""
    def render_fn(scene: Scene, seed):
        cfg = specialize_config(scene, config)
        pixel_id, sample_idx = _shard_lanes(mesh, width, height, spp, scene.light_cdf.device)
        rgb, weight, n_rays = _render_shard(scene, pixel_id, sample_idx, seed, width, height, cfg)
        img = rgb / torch.clamp(weight, min=1e-8)[..., None]
        return (img, n_rays) if with_stats else img

    return render_fn


def make_train_step(mesh, width: int, height: int, spp: int, target_image, lr: float = 0.05,
                    config: PTConfig = PTConfig(max_depth=4, rr_start=99)):
    """One sharded SGD step of inverse rendering: fn(scene, seed) ->
    (scene with textures.color_a and lights.radiance moved by -lr times the
    gradient of mean((render - target)^2), the loss). The gradient flows
    through the sharded render and is summed over the mesh once; every rank
    ends with the same parameters."""
    render_fn = make_sharded_render(mesh, width, height, spp, config)

    def step(scene: Scene, seed):
        params = tuple(p.detach().requires_grad_()
                       for p in (scene.textures.color_a, scene.lights.radiance))
        s = scene._replace(textures=scene.textures._replace(color_a=params[0]),
                           lights=scene.lights._replace(radiance=params[1]))
        loss = ((render_fn(s, seed) - target_image) ** 2).mean()
        grads = torch.autograd.grad(loss, params)
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        new = [(p - lr * g.view_as(p)).detach()
               for p, g in zip(params, flat.split([p.numel() for p in params]))]
        new_scene = scene._replace(textures=scene.textures._replace(color_a=new[0]),
                                   lights=scene.lights._replace(radiance=new[1]))
        return new_scene, loss.detach()

    return step


def make_sharded_render_vol(mesh, width: int, height: int, spp: int,
                            config: PTConfig = PTConfig()):
    """fn(scene, media, seed) -> the (H, W, 3) volumetric image, the same on
    every rank, on the scene's device. Rank (dp, sp) traces exactly its
    `_shard_lanes` block through `volpath.lane_radiance`, as one batch (its
    delta tracking's trip count is its own), and sums its samples per pixel
    into the whole image's flat float64 film, which one all-reduce sums over
    the mesh. On a 1 x 1 mesh the lanes and the reshape-sum film are
    `volpath.render_vol`'s, so the image equals it bit for bit.
    Differentiable in the scene's and media's tensors that require grad, the
    film's all-reduce passing the cotangent through unchanged: after the
    backward, `all_reduce_grads` sums the leaves' gradients over the mesh."""
    def render_fn(scene: Scene, media: media_mod.Media, seed):
        cfg = volpath._specialize(scene, media, config)
        return _render_vol_shard(mesh, scene, media, width, height, spp, seed, cfg)

    return render_fn


@spanned("ctl.pass")
def _render_vol_shard(mesh, scene, media, width, height, spp, seed, config):
    dp, _, n_dp, n_sp = _mesh_layout(mesh)
    pixel_id, sample_idx = _shard_lanes(mesh, width, height, spp, scene.light_cdf.device)
    count("shard.lanes", pixel_id.numel())
    L = volpath.lane_radiance(scene, media, pixel_id, sample_idx, width, height, seed, config)
    m = width * height // n_dp
    part = volpath.sample_sum(L, spp // n_sp, m).reshape(-1).double()
    film = torch.nn.functional.pad(part, (3 * m * dp, 3 * m * (n_dp - 1 - dp)))
    return (_AllReduceSum.apply(film).float() / spp).reshape(height, width, 3)


def all_reduce_grads(params) -> None:
    """Sum the leaves' gradients over the process group, in place, with one
    all-reduce of one flat buffer (a leaf without a gradient adds zeros and
    receives the sum). Called after the backward of a loss of a sharded
    render, it leaves on every rank the gradient of the whole image's loss,
    so an optimizer then moves the same parameters on every rank."""
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    _all_reduce(flat)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def _gather_photons(pm: ppm_mod.PhotonMap, n_ranks: int) -> ppm_mod.PhotonMap:
    """The union photon map on every rank: one all-gather of each rank's
    slots packed as (P, 14) float32, concatenated in rank order."""
    fields = (pm.p, pm.power, pm.wi, pm.n, pm.valid[:, None].float(), pm.caustic[:, None].float())
    local = torch.cat(fields, 1).contiguous()
    slots = [torch.empty_like(local) for _ in range(n_ranks)]
    dist.all_gather(slots, local)
    p, power, wi, n, valid, caustic = torch.split(torch.cat(slots), (3, 3, 3, 3, 1, 1), 1)
    return ppm_mod.PhotonMap(p=p, power=power, wi=wi, n=n, valid=valid[:, 0] > 0.5,
                             caustic=caustic[:, 0] > 0.5)


def make_sharded_ppm(mesh, width: int, height: int, spp: int, config=None):
    """The multi-rank progressive photon mapping pass (bench config 5's
    light-tracing pass sharded): fn(scene, seed, radius) -> (H, W, 3) image.

    Rank r = dp * n_sp + sp traces n_photons / n_ranks photons at seed ^ (r *
    0x9E3779B9) (uint32); the photon maps are all-gathered in rank order
    (each rank's slots depth-major), so every rank holds the union map, its
    power divided by the rank count; the grids are built on every rank and
    the eye pass shards over the mesh with the summed film. `config.grid_res`
    is used as given (`render_ppm_pass` clamps it to the radius, the JAX
    package's sharded pass does not). The base config is specialized lazily
    per scene, each specialization's lanes built once per device."""
    if config is None:
        config = ppm_mod.PPMConfig()
    dp, sp, n_dp, n_sp = _mesh_layout(mesh)
    n_ranks = n_dp * n_sp
    if config.n_photons % n_ranks:
        raise ValueError(f"{config.n_photons} photons must divide over {n_ranks} ranks")
    photon_seed_xor = ((dp * n_sp + sp) * PHOTON_SEED_STRIDE) & MASK

    def _build(cfg: ppm_mod.PPMConfig, device):
        pixel_id, sample_idx = _shard_lanes(mesh, width, height, spp, device)

        def run(scene: Scene, seed, radius):
            pm = ppm_mod.trace_photons(scene, cfg.n_photons // n_ranks,
                                       (int(seed) & MASK) ^ photon_seed_xor, cfg.base)
            pm = _gather_photons(pm, n_ranks)
            # the local pass divided the power by the local count
            pm = pm._replace(power=pm.power / n_ranks)
            grids = ppm_mod.build_photon_grids(scene, pm, cfg)
            film = ppm_mod.ppm_eye_pass(scene, pm, grids, pixel_id, sample_idx, seed, radius,
                                        width, height, cfg)
            rgb, weight = _film_sum(film)
            return rgb / torch.clamp(weight, min=1e-8)[..., None]

        return run

    cache: dict = {}

    @torch.no_grad()
    def ppm_fn(scene: Scene, seed, radius):
        base = specialize_config(scene, config.base)
        key = (base, str(scene.light_cdf.device))
        if key not in cache:
            cache[key] = _build(config._replace(base=base), scene.light_cdf.device)
        return cache[key](scene, seed, radius)

    return ppm_fn


def replicate_scene(scene: Scene, mesh) -> Scene:
    """Every tensor leaf of `scene` broadcast from rank 0 of the mesh; each
    rank's copy stays on its own device. Every rank passes a scene of the
    same structure (host leaves, such as the specialization, stay its own)."""
    _mesh_layout(mesh)

    def bcast(t):
        x = t.detach().clone().contiguous()
        dist.broadcast(x, 0)
        return x

    return tree_map(bcast, scene)
