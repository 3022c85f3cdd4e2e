"""Inverse rendering over a mesh of ranks: a closed loop of sharded Adam
steps, one in flight. The configuration's `mesh` lays the ranks out
("dp" splits the pixels, "sp" the samples), one card a rank, over its
`backend` (NCCL; gloo on the CPU, where tests drive the harness at tiny
sizes). The program's sharded entry points are looked up before any rank
starts (port_shard.require), so a program without them fails at once.

This process is rank 0; the others are spawned (core/ranks.py). Every rank
builds the scene and the media, renders the target with the sharded render
at seed + target_seed_offset without a graph, perturbs the traffic's leaves
from the seed as grad_steps.initial_params does, and drives its step object
through the checked steps in set-up. A step: the sharded forward (the
film's all-reduce inside it), the replicated L2 loss, the backward, the
gradients' all-reduce, Adam, the loss read on the host.

The window: the ranks step in lockstep (the collectives join them); rank
0's clock closes the window, and after each step rank 0 broadcasts whether
it has. `grad_step_ms` is rank 0's window over its steps; the peak memory is
the fullest card's. Traced, every rank profiles the same steps and reduces
its own trace: rank 0's is the run's trace, and each rank's collective
kernels, in launch order, go to the readers of the collectives' metrics.

The check: set-up keeps the losses, the first gradient as Adam holds it and
the leaves' change after the checked steps, as grad_steps does. After the
window every rank frees the program's state, and the reference
(reference/volume_sharded.py) follows the same checked steps over the lanes
its own rule gives the rank; its partial images and gradients are summed
with torch.distributed directly, and rank 0 compares."""
from __future__ import annotations

import gc
import json
import sys
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

from perfbench.core import collectives, compare, port, port_shard, program_counters, ranks, window
from perfbench.core.collectives import ShardedRecord
from perfbench.core.record import Record
from perfbench.drivers import grad_steps
from perfbench.reference import volume_sharded as VS
from perfbench.reference.common import RefScene

MASK = 0xFFFFFFFF
CPU_MAX_LANES = 1 << 16   # a CPU run (the tests') traces at most this many lanes a rank


class ShardedSteps:
    """A rank's step object: the program's scene and media, its sharded
    render, the target, the optimised leaves and their Adam."""

    first_gradient = grad_steps.Steps.first_gradient

    def __init__(self, cell, data, seed, device, p0):
        t = cell.traffic
        self.seed = seed
        self.sc, self.cfg = port.scene(data, device), port.config(data)
        self.med = port.media(data, device)
        mesh = port_shard.mesh(cell.config["mesh"], device)
        self.render = port_shard.render_vol(mesh, t["width"], t["height"], t["spp"], self.cfg)
        with torch.no_grad():
            self.target = self.render(self.sc, self.med, (seed + t["target_seed_offset"]) & MASK)
        self.leaves = {n: p.clone().requires_grad_() for n, p in p0.items()}
        a = t["adam"]
        self.opt = torch.optim.Adam(list(self.leaves.values()), lr=a["lr"], betas=tuple(a["betas"]),
                                    eps=a["eps"])

    def __call__(self, i: int) -> float:
        """Step i (1, 2, ...): the loss, read on the host."""
        img = self.render(self.sc, port.with_params(self.med, self.leaves), (self.seed + i) & MASK)
        loss = ((img - self.target) ** 2).mean()
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        port_shard.all_reduce_grads(list(self.leaves.values()))
        self.opt.step()
        return float(loss.detach())


def checked_steps(steps, n: int, p0: dict) -> dict:
    """Steps 1 .. n of `steps`: the losses, the first gradient as Adam holds
    it and the leaves' change after the last (compare.train_numbers)."""
    prog = {"losses": []}
    for i in range(1, n + 1):
        prog["losses"].append(steps(i))
        if i == 1:
            prog["grad1"] = steps.first_gradient()
    prog["change3"] = {k: x.detach().clone() - p0[k] for k, x in steps.leaves.items()}
    return prog


def lockstep(unit, seconds: float, sync, rank: int, device):
    """Run unit(0), unit(1), ... on every rank until rank 0's clock has
    passed `seconds` (the step in flight completes and counts): this rank's
    (walls, window_s)."""
    walls = []
    stop = torch.zeros(1, dtype=torch.int32, device=device)
    sync()
    t_start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        unit(i)
        sync()
        now = time.perf_counter()
        walls.append(now - t)
        i += 1
        if rank == 0:
            stop.fill_(int(now - t_start >= seconds))
        dist.broadcast(stop, 0)
        if int(stop.item()):
            return walls, now - t_start


def reference_steps(cell, data, seed, device, p0, rank, dtype=torch.float32) -> dict:
    """The reference's losses, first gradient and leaves' change over the
    checked steps, on this rank's lanes, with its own Adam; a collective
    call of every rank."""
    t, layout = cell.traffic, cell.config["mesh"]
    W, H, spp, n = t["width"], t["height"], t["spp"], t["checked_steps"]
    block, grad_block = t["check"]["block_lanes"], t["check"]["grad_block_lanes"]
    b1, b2 = t["adam"]["betas"]
    lr, eps = t["adam"]["lr"], t["adam"]["eps"]
    pix, smp = VS.rank_lanes(layout["dp"], layout["sp"], rank, W, H, spp, device)
    rs = RefScene(data, device, dtype)
    rec = data["media"][0]

    def image(L):
        film = torch.zeros(W * H, 3, dtype=torch.float64, device=device)
        film.index_add_(0, pix, L.double())
        dist.all_reduce(film)
        return film / spp

    target = image(VS.radiance_whole(rs, VS.medium(rec, device, dtype), pix, smp, W, H,
                                     (seed + t["target_seed_offset"]) & MASK, block)[0])
    p = {k: v.detach().to(dtype).clone().requires_grad_() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": []}
    for i in range(1, n + 1):
        s = (seed + i) & MASK
        med = VS.medium(rec, device, dtype, params=p)
        L, skips = VS.radiance_whole(rs, med, pix, smp, W, H, s, block)
        img = image(L)
        out["losses"].append(float(((img - target) ** 2).mean()))
        cot = (2.0 / img.numel() / spp * (img - target))[pix].to(dtype)
        g = VS.lane_gradient(rs, med, p, pix, smp, W, H, s, block, skips, cot, grad_block)
        flat = torch.cat([g[k].float().reshape(-1) for k in p])
        dist.all_reduce(flat)
        g = dict(zip(p, (x.view_as(p[k]).to(dtype)
                         for k, x in zip(p, flat.split([v.numel() for v in p.values()])))))
        with torch.no_grad():
            for k, x in p.items():
                if i == 1:
                    out.setdefault("grad1", {})[k] = g[k].float().clone()
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                denom = (v2[k].sqrt() / (1 - b2 ** i) ** 0.5).add_(eps)
                x.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** i))
    out["change3"] = {k: (x.detach().float() - p0[k].float()) for k, x in p.items()}
    return out


def _rank_run(rank, cell, seed, seconds, trace, device, t0_wall) -> dict:
    t = cell.traffic
    data = cell.scene()
    sync = window.sync_of(device)
    on_card = device.type == "cuda"
    n_chk = t["checked_steps"]
    med0 = port.media(data, device)
    p0 = grad_steps.initial_params(cell, med0, seed, device)
    del med0
    steps = ShardedSteps(cell, data, seed, device, p0)
    prog = checked_steps(steps, n_chk, p0)
    sync()
    dist.barrier()
    setup_s = time.time() - t0_wall
    losses = []

    def unit(i):
        losses.append(steps(n_chk + 1 + i))

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        walls, win, tr = window.traced(unit, t["trace_steps"], sync)
    else:
        (walls, win), tr = lockstep(unit, seconds, sync, rank, device), None
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    counts = program_counters.traced(SimpleNamespace(trace=tr)) or {}
    out = dict(setup_s=setup_s, walls=walls, window_s=win, peak_bytes=peak,
               failed=sum(1 for x in losses if not x == x or x in (float("inf"), float("-inf"))),
               busy_s=tr.busy_s if tr is not None else None,
               collectives=collectives.collective_seconds(tr.kernels) if tr is not None else [],
               counted={k: counts.get(k) for k in ("shard.allreduce.calls", "shard.allreduce.bytes",
                                                   "shard.lanes")})
    del steps, unit
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = reference_steps(cell, data, seed, device, p0, rank)
    if rank == 0:
        out["trace"] = tr
        out["numbers"] = compare.train_numbers(prog, ref)
    return out


def rank_main(rank, cell, seed, seconds, trace, device, backend, t0_wall, port_no, prepare):
    """One rank of the job: joins the group, runs, leaves it. `prepare`
    (tests) is called first with the rank and may return an undo."""
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // cell.chips))   # the ranks share the host's cores
    dev = port_shard.start(rank, cell.chips, port_no, device, backend,
                           cell.traffic["rank_timeout_s"])
    undo = prepare(rank) if prepare is not None else None
    try:
        return _rank_run(rank, cell, seed, seconds, trace, dev, t0_wall)
    finally:
        if undo is not None:
            undo()
        port_shard.stop()
        torch.set_num_threads(threads)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float, prepare=None) -> Record:
    port_shard.require()
    layout, t = cell.config["mesh"], cell.traffic
    n = layout["dp"] * layout["sp"]
    if n != cell.chips:
        raise ValueError(f"the mesh {layout} holds {n} ranks, the cell {cell.chips} cards")
    kind = torch.device(device).type
    lanes = t["width"] * t["height"] * t["spp"] // n
    if kind == "cpu" and lanes > CPU_MAX_LANES:
        raise ValueError(f"{lanes} lanes a rank: the CPU runs a sharded cell only at test sizes "
                         f"(at most {CPU_MAX_LANES})")
    backend = cell.config["backend"] if kind == "cuda" else "gloo"
    t0_wall = time.time() - (time.perf_counter() - t0)
    outs = ranks.run(n, __name__, "rank_main",
                     (cell, seed, seconds, trace, kind, backend, t0_wall, port_shard.free_port(),
                      prepare), timeout=t["rank_timeout_s"], watch=kind == "cuda")
    r0 = outs[0]
    rec = ShardedRecord(unit="step", setup_s=r0["setup_s"], window_s=r0["window_s"],
                        unit_walls=r0["walls"], peak_bytes=max(o["peak_bytes"] for o in outs),
                        trace=r0["trace"], attempted=len(r0["walls"]),
                        failed=sum(o["failed"] for o in outs), numbers=r0["numbers"],
                        collectives=[o["collectives"] for o in outs],
                        collective_bytes=collectives.step_bytes(cell),
                        link_bytes_per_s=cell.config["link"]["per_direction_bytes_per_s"])
    units = len(r0["walls"])
    print(json.dumps({"ranks": [
        {"rank": r, "peak_bytes": o["peak_bytes"], "setup_s": o["setup_s"],
         "units": len(o["walls"]),
         "busy_s_per_unit": None if o["busy_s"] is None else o["busy_s"] / len(o["walls"]),
         "collective_ms": [x * 1e3 for x in o["collectives"]],
         "counted_per_unit": {k: None if v is None else v / units for k, v in o["counted"].items()}}
        for r, o in enumerate(outs)], "collective_bytes_per_step": rec.collective_bytes}),
        file=sys.stderr, flush=True)
    return rec
