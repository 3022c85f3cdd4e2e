"""Inverse rendering: a closed loop of optimisation steps. Set-up renders
the target once from the configuration's medium; the parameters start from
the medium's fields named by the traffic, each scaled by (1 + noise) drawn
from the seed on the device. A step renders the program's volpath.render_vol
at the traffic's size (the step's seed is seed + step), takes the L2 loss
against the target, runs the backward, takes one torch.optim.Adam step and
reads the loss on the host.

The check: set-up drives the same step object through its first
`checked_steps` steps (they warm every shape up), keeping the losses, the
first gradient as Adam holds it (exp_avg / (1 - beta1) after one step) and
the parameters after the last; the window continues from there. Once it has
closed and the program's state is freed, the reference follows the same
steps from the same initial parameters, target and seeds."""
from __future__ import annotations

import gc
import time

import torch

from perfbench.core import compare, port, window
from perfbench.core.record import Record
from perfbench.reference import volume
from perfbench.reference.common import RefScene

MASK = 0xFFFFFFFF


def initial_params(cell, med, seed: int, device) -> dict:
    """The benchmark's inputs: each optimised field times (1 + U(lo, hi))."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name in cell.traffic["params"]:
        base = getattr(med, name).detach()
        lo, hi = cell.traffic["perturb"][name]
        u = torch.rand(base.shape, generator=gen, device=device)
        out[name] = base * (1.0 + (lo + (hi - lo) * u))
    return out


class Steps:
    """The step object: the program's scene and media, the target, the
    optimised leaves and their Adam."""

    def __init__(self, cell, data, seed, device, p0):
        t = cell.traffic
        self.W, self.H, self.spp, self.seed = t["width"], t["height"], t["spp"], seed
        self.sc, self.cfg = port.scene(data, device), port.config(data)
        self.med = port.media(data, device)
        with torch.no_grad():
            self.target = port.render_vol(self.sc, self.med, self.W, self.H, self.spp,
                                          (seed + t["target_seed_offset"]) & MASK, self.cfg)
        self.leaves = {n: p.clone().requires_grad_() for n, p in p0.items()}
        a = t["adam"]
        self.opt = torch.optim.Adam(list(self.leaves.values()), lr=a["lr"], betas=tuple(a["betas"]),
                                    eps=a["eps"])
        self.spans = {"backward": []}
        self.sync = window.sync_of(device)
        self.time_backward = False

    def first_gradient(self) -> dict:
        """The gradient as Adam holds it after one step, exp_avg / (1 - beta1)
        (zeros where it holds none)."""
        b1 = self.opt.defaults["betas"][0]
        return {n: self.opt.state.get(x, {}).get("exp_avg", torch.zeros_like(x)).detach().clone()
                / (1 - b1) for n, x in self.leaves.items()}

    def __call__(self, i: int) -> float:
        """Step i (1, 2, ...): the loss, read on the host."""
        m = port.with_params(self.med, self.leaves)
        img = port.render_vol(self.sc, m, self.W, self.H, self.spp, (self.seed + i) & MASK, self.cfg)
        loss = ((img - self.target) ** 2).mean()
        self.opt.zero_grad(set_to_none=True)
        if self.time_backward:
            self.sync()
            t = time.perf_counter()
            loss.backward()
            self.sync()
            self.spans["backward"].append(time.perf_counter() - t)
        else:
            loss.backward()
        self.opt.step()
        return float(loss.detach())


def reference_steps(cell, data, seed, device, p0, dtype=torch.float32) -> dict:
    """The reference's losses, first gradient and parameter change over the
    checked steps, with its own Adam."""
    t = cell.traffic
    W, H, spp, n = t["width"], t["height"], t["spp"], t["checked_steps"]
    block = t["check"]["block_lanes"]
    b1, b2 = t["adam"]["betas"]
    lr, eps = t["adam"]["lr"], t["adam"]["eps"]
    rs = RefScene(data, device, dtype)
    rec = data["media"][0]
    with torch.no_grad():
        target = volume.render(rs, volume.RefMedium(rec, device, dtype), W, H, spp,
                               (seed + t["target_seed_offset"]) & MASK, block)
    p = {k: v.detach().to(dtype).clone().requires_grad_() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": []}
    for i in range(1, n + 1):
        med = volume.RefMedium(rec, device, dtype, params=p)
        img = volume.render(rs, med, W, H, spp, (seed + i) & MASK, block)
        loss = ((img - target) ** 2).mean()
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            for (k, x), g in zip(p.items(), grads):
                g = torch.zeros_like(x) if g is None else g
                if i == 1:
                    out["grad1"] = dict(out.get("grad1", {}), **{k: g.float().clone()})
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / (1 - b2 ** i) ** 0.5).add_(eps)
                x.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** i))
    out["change3"] = {k: (x.detach().float() - p0[k].float()) for k, x in p.items()}
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Record:
    data = cell.scene()
    sync = window.sync_of(device)
    n_chk = cell.traffic["checked_steps"]
    med0 = port.media(data, device)
    p0 = initial_params(cell, med0, seed, device)
    del med0
    steps = Steps(cell, data, seed, device, p0)
    prog = {"losses": []}
    for i in range(1, n_chk + 1):
        prog["losses"].append(steps(i))
        if i == 1:
            prog["grad1"] = steps.first_gradient()
    prog["change3"] = {n: x.detach().clone() - p0[n] for n, x in steps.leaves.items()}
    sync()
    setup_s = time.perf_counter() - t0
    losses = []

    def unit(i):
        losses.append(steps(n_chk + 1 + i))

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if trace:
        steps.time_backward = True
        walls, win, tr = window.traced(unit, cell.traffic["trace_steps"], sync)
    else:
        (walls, win), tr = window.timed(unit, seconds, sync), None
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    bad = sum(1 for x in losses if not x == x or x in (float("inf"), float("-inf")))
    rec = Record(unit="step", setup_s=setup_s, window_s=win, unit_walls=walls, peak_bytes=peak,
                 trace=tr, spans={k: v for k, v in steps.spans.items() if v},
                 attempted=len(walls), failed=bad)
    del steps, unit
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(cell, data, seed, device, p0)
    rec.numbers = compare.train_numbers(prog, ref)
    return rec
