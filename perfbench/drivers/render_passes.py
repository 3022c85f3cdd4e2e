"""Progressive rendering: a closed loop with one pass in flight. Each pass
is the program's forward render (path_tracer.render for a surface scene,
volpath.render_vol for a scene with media) under torch.no_grad, at the
traffic's size, with pass seeds seed, seed+1, ... added into a film.

The check: one pass, drawn from the seed among the window's first
`pass_from_first`, is kept as the program produced it (at `pixels` pixels
drawn from the seed for a surface scene, whose lanes replay alone; whole for
a scene with media, whose lanes share the tracking trip count) and, once
the window has closed and the program's state is freed, compared with the
reference's render of the same pass."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench.core import compare, port, window
from perfbench.core.record import Record
from perfbench.reference import surface, volume
from perfbench.reference.common import RefScene

MASK = 0xFFFFFFFF


def spp_of(cell) -> int:
    return cell.traffic.get("spp_by_config", {}).get(cell.config["name"], cell.traffic["spp"])


def plan(cell, seed: int):
    """(kept pass index, pixel ids or None): the check's sample, from the seed."""
    rng = np.random.default_rng(seed)
    chk = cell.traffic["check"]
    k = int(rng.integers(0, chk["pass_from_first"]))
    if cell.config["reference"] != "surface":
        return k, None
    n_px = cell.traffic["width"] * cell.traffic["height"]
    ids = rng.choice(n_px, size=min(chk["pixels"], n_px), replace=False)
    return k, np.sort(ids)


def program_pass(cell, data, device):
    """(pass function seed -> image, the program's state to free)."""
    W, H, spp = cell.traffic["width"], cell.traffic["height"], spp_of(cell)
    sc, cfg = port.scene(data, device), port.config(data)
    if data["media"]:
        med = port.media(data, device)
        return (lambda s: port.render_vol(sc, med, W, H, spp, s, cfg)), [sc, med]
    return (lambda s: port.render(sc, W, H, spp, s, cfg)), [sc]


def reference_pass(cell, data, device, seed, ids, dtype=torch.float32):
    """The reference's render of the pass of `seed`: (P, 3) at the pixel ids,
    or the whole (H, W, 3) image."""
    W, H, spp = cell.traffic["width"], cell.traffic["height"], spp_of(cell)
    block = cell.traffic["check"]["block_lanes"]
    rs = RefScene(data, device, dtype)
    if ids is not None:
        return surface.render_pixels(rs, torch.as_tensor(ids, device=device), W, H, spp, seed,
                                     block=block)
    with torch.no_grad():
        return volume.render(rs, volume.RefMedium(data["media"][0], device, dtype), W, H, spp,
                             seed, block=block)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Record:
    data = cell.scene()
    sync = window.sync_of(device)
    k, ids = plan(cell, seed)
    ids_t = None if ids is None else torch.as_tensor(ids, device=device)
    render, state = program_pass(cell, data, device)
    W, H, spp = cell.traffic["width"], cell.traffic["height"], spp_of(cell)
    with torch.no_grad():
        render((seed - 1) & MASK)          # warm-up: every shape of the window
        sync()
        setup_s = time.perf_counter() - t0
        film = torch.zeros(H, W, 3, device=device)
        kept = {}

        def unit(i):
            img = render((seed + i) & MASK)
            film.add_(img)
            if i == k:
                kept["img"] = (img.reshape(-1, 3)[ids_t] if ids_t is not None else img).clone()

        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        if trace:
            walls, win, tr = window.traced(unit, max(cell.traffic["trace_passes"], k + 1), sync)
        else:
            (walls, win), tr = window.timed(unit, seconds, sync, k + 1), None
        peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    rec = Record(unit="pass", setup_s=setup_s, window_s=win, unit_walls=walls,
                 samples=len(walls) * W * H * spp, peak_bytes=peak, trace=tr,
                 attempted=len(walls), failed=0)
    prog = kept["img"]
    del render, state, film, kept
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_pass(cell, data, device, (seed + k) & MASK, ids)
    rec.numbers = compare.image_numbers(prog, ref)
    return rec
