"""Entry points of the port: the forward Cornell render step and one step of
inverse rendering.

`entry` is the counterpart of the JAX package's `__graft_entry__.entry`
(__graft_entry__.py:6-21): the Cornell box of bench config 1's geometry,
rendered at 64x64, 2 spp, depth 5. `inverse_step` is one step of
examples/inverse_rendering.py:36-55: the L2 loss of a render against a
target image, its value and gradient with respect to the wall albedos
(`textures.color_a`, clipped to [0, 1]) and the light radiance
(`lights.radiance`, taken by absolute value), and one SGD step with the
example's learning rates. `dryrun_multichip` is the counterpart of
`__graft_entry__.dryrun_multichip` (:24): one sharded train step on spawned
ranks. All run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .parallel import shard
from .parallel.distributed import run_ranks
from .render.path_tracer import PTConfig, render, specialize_config
from .scene.shapes import cornell_box

ENTRY_SIZE, ENTRY_SPP = 64, 2
INVERSE_LR = (0.4, 4.0)   # SGD rates of (color_a, radiance), as in the example


def entry(device="cuda"):
    """(fn, example_args): `fn(scene, seed)` renders the Cornell box at
    64x64, 2 spp, depth 5 and returns the (64, 64, 3) image."""
    scene = cornell_box(device=device)
    cfg = specialize_config(scene, PTConfig(max_depth=5))

    def fn(scene, seed):
        return render(scene, ENTRY_SIZE, ENTRY_SIZE, ENTRY_SPP, seed, cfg)

    return fn, (scene, 0)


def grey_start(device="cuda"):
    """The example's start scene: grey walls and a dim light."""
    return cornell_box(light_radiance=(5.0, 5.0, 5.0), white=(0.5, 0.5, 0.5),
                       red=(0.5, 0.5, 0.5), green=(0.5, 0.5, 0.5), device=device)


def inverse_loss(scene, params, target, width: int, height: int, spp: int, seed,
                 config: PTConfig):
    """mean((render - target)^2) with textures.color_a = clip(params[0], 0,
    1) and lights.radiance = |params[1]|."""
    color_a, radiance = params
    s = scene._replace(textures=scene.textures._replace(color_a=torch.clamp(color_a, 0.0, 1.0)),
                       lights=scene.lights._replace(radiance=radiance.abs()))
    return ((render(s, width, height, spp, seed, config) - target) ** 2).mean()


class InverseStep(NamedTuple):
    loss: torch.Tensor    # () the loss at the step's input parameters
    grads: tuple          # its gradient with respect to (color_a, radiance)
    params: tuple         # the parameters after the SGD step


def inverse_step(scene, params, target, seed, width: int = 64, height: int = 64,
                 spp: int = 8, config: PTConfig = PTConfig(max_depth=4, rr_start=99)
                 ) -> InverseStep:
    """One gradient step of inverse rendering from `params` = (color_a,
    radiance) against `target` (H, W, 3); the defaults are the example's."""
    config = specialize_config(scene, config)
    params = tuple(p.detach().requires_grad_() for p in params)
    loss = inverse_loss(scene, params, target, width, height, spp, seed, config)
    grads = torch.autograd.grad(loss, params)
    new = tuple((p - rate * g).detach() for p, g, rate in zip(params, grads, INVERSE_LR))
    return InverseStep(loss=loss.detach(), grads=grads, params=new)


DRYRUN_SIZE = 16


def _dryrun_rank(rank, device, n_ranks):
    """One rank of `dryrun_multichip`: its loss."""
    n_sp = 2 if n_ranks % 2 == 0 else 1
    mesh = shard.make_mesh(n_ranks // n_sp, n_sp, device=device)
    scene = shard.replicate_scene(cornell_box(device=device), mesh)
    target = torch.zeros(DRYRUN_SIZE, DRYRUN_SIZE, 3, device=device)
    step = shard.make_train_step(mesh, DRYRUN_SIZE, DRYRUN_SIZE, 2 * n_sp, target,
                                 config=PTConfig(max_depth=2, rr_start=99))
    _, loss = step(scene, 0)
    return float(loss)


def dryrun_multichip(n_ranks: int, device="cuda") -> float:
    """The full sharded differentiable training step on `n_ranks` spawned
    ranks (pixels over dp, samples over sp = 2 when n_ranks is even; the
    scene replicated from rank 0; the film all-reduce and the gradient
    all-reduce), once at 16x16, depth 2. Raises unless the loss is finite
    and equal on every rank; returns it."""
    losses = run_ranks(_dryrun_rank, n_ranks, (n_ranks,), device=device)
    if not all(math.isfinite(v) for v in losses) or len(set(losses)) != 1:
        raise RuntimeError(f"dryrun_multichip({n_ranks}): losses by rank {losses}")
    print(f"dryrun_multichip({n_ranks}) OK: loss={losses[0]:.6f}")
    return losses[0]
