"""The readings the limits of a sharded grad cell (limits/<cell>.json) are
set from, on its cards at its own size, in one job of ranks: the compared
numbers of sound runs of the program (the lower readings), of the control
(the reference in bfloat16 in the program's place, a precision below the
configuration's float32) and of the program with a fault planted on every
rank (`FAULTS`; the upper readings). The reference runs once a seed and
serves every program run of that seed.

    python3 perfbench/tools/sharded_readings.py --workload <cell> --seeds 1,2 \\
        --control-seeds 3 [--faults] [--out readings.json]

`FAULTS` maps a fault to a function of the rank that plants it in the
rank's process and returns its undo (the harness's tests plant them the
same way)."""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench.core import compare, port, port_shard, ranks  # noqa: E402
from perfbench.core.cell import load_cell  # noqa: E402


def _patch(owner, name, new):
    old = getattr(owner, name)
    setattr(owner, name, new)
    return lambda: setattr(owner, name, old)


def state_unchanged(rank):
    """Adam moves nothing."""
    return _patch(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch(rank):
    """Every rank traces half of its samples (the target too)."""
    make = port_shard.render_vol
    return _patch(port_shard, "render_vol",
                  lambda mesh, w, h, spp, cfg: make(mesh, w, h, max(1, spp // 2), cfg))


def answer_altered(rank):
    """The rendered image times 1.01."""
    make = port_shard.render_vol

    def render_vol(*a):
        fn = make(*a)
        return lambda *b: fn(*b) * 1.01
    return _patch(port_shard, "render_vol", render_vol)


def grad_left_out(rank):
    """Rank 1's gradient is left out of the all-reduce (it adds zeros)."""
    reduce = port_shard.all_reduce_grads

    def all_reduce_grads(params):
        params = list(params)
        if rank == 1:
            for p in params:
                p.grad = None
        reduce(params)
    return _patch(port_shard, "all_reduce_grads", all_reduce_grads)


def same_block(rank):
    """Rank 1 renders rank 0's block of pixels (and none of its own)."""
    make = port_shard.mesh

    def mesh(layout, device):
        m = make(layout, device)
        return SimpleNamespace(shape=m.shape, get_coordinate=lambda: [0, 0]) if rank == 1 else m
    return _patch(port_shard, "mesh", mesh)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, answer_altered, grad_left_out,
                                  same_block)}


def rank_readings(rank, cell, plan, device, backend, port_no):
    """One rank of the readings job: for each (seed, kinds) of `plan`, the
    program's checked steps for each kind (None: sound; a fault's name), the
    reference, and with "control" the reference in bfloat16; rank 0's rows."""
    from perfbench.drivers import grad_steps
    from perfbench.drivers import sharded_grad_steps as D

    dev = port_shard.start(rank, cell.chips, port_no, device, backend,
                           cell.traffic["rank_timeout_s"])
    try:
        data = cell.scene()
        n = cell.traffic["checked_steps"]
        rows = []
        for seed, kinds in plan:
            t = time.perf_counter()
            p0 = grad_steps.initial_params(cell, port.media(data, dev), seed, dev)
            progs = {}
            for kind in kinds:
                if kind == "control":
                    continue
                undo = FAULTS[kind](rank) if kind else None
                try:
                    progs[kind] = D.checked_steps(D.ShardedSteps(cell, data, seed, dev, p0), n, p0)
                finally:
                    if undo is not None:
                        undo()
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            ref = D.reference_steps(cell, data, seed, dev, p0, rank)
            if "control" in kinds:
                progs["control"] = D.reference_steps(cell, data, seed, dev, p0, rank,
                                                     torch.bfloat16)
            for kind, prog in progs.items():
                nums = compare.train_numbers(prog, ref)
                rows.append(dict(kind="program" if kind is None else kind, seed=seed,
                                 seconds=time.perf_counter() - t, **nums))
                if rank == 0:
                    print(json.dumps(rows[-1]), flush=True)
        return rows
    finally:
        port_shard.stop()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sharded_readings: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    port_shard.require()
    bad = [k for k in FAULTS] if args.faults else []
    plan = [(int(s), [None]) for s in args.seeds.split(",") if s]
    plan += [(int(s), ["control"] + bad) for s in args.control_seeds.split(",") if s]
    rows = ranks.run(cell.chips, "perfbench.tools.sharded_readings", "rank_readings",
                     (cell, plan, "cuda", cell.config["backend"], port_shard.free_port()),
                     timeout=cell.traffic["rank_timeout_s"])[0]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
