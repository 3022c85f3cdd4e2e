"""The benchmark's one module that imports the program's parallel/ code
(cudatracerlib_tpu_torch.parallel): the process group, the rank mesh, the
sharded volume render and the gradients' all-reduce. The rest of the program
is reached through port.py.

`require()` looks the sharded entry points up; a driver calls it before any
rank starts, so a program without them fails at once, in this process."""
from __future__ import annotations

import torch
import torch.distributed as dist

from cudatracerlib_tpu_torch.parallel import distributed, shard

ENTRY_POINTS = ("make_mesh", "make_sharded_render_vol", "all_reduce_grads")


def require() -> None:
    """Raise unless the program has every sharded entry point the sharded
    cells call."""
    missing = [name for name in ENTRY_POINTS if not callable(getattr(shard, name, None))]
    if missing:
        raise RuntimeError("the program lacks parallel/shard." + ", parallel/shard.".join(missing)
                           + ": it cannot run a sharded cell")


def free_port() -> int:
    return distributed.free_port()


def start(rank: int, n_ranks: int, port: int, device: str, backend: str, timeout: float):
    """Join the local job as `rank` (each rank on card `rank`, or the CPU):
    the rank's torch.device."""
    distributed.init_distributed(rank, n_ranks, "127.0.0.1", port, rank, device=device,
                                 backend=backend, timeout=timeout)
    if device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def stop() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh(layout: dict, device):
    """The program's ("dp", "sp") mesh of the configuration's layout."""
    return shard.make_mesh(layout["dp"], layout["sp"], device=device.type)


def render_vol(mesh, width, height, spp, cfg):
    """fn(scene, media, seed) -> (H, W, 3): the sharded volumetric pass,
    the same image on every rank; differentiable in the media's leaves."""
    return shard.make_sharded_render_vol(mesh, width, height, spp, cfg)


def all_reduce_grads(params) -> None:
    """The leaves' gradients summed over the mesh, in place."""
    shard.all_reduce_grads(params)
