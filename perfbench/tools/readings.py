"""The readings the limits of limits/<cell>.json are set from, on the card
at the cell's own size: the compared numbers of sound runs of the program
on many seeds (the lower readings), of the control (the reference in
bfloat16 in the program's place, a precision below the configuration's
float32) on a few, and, for a training cell, of the program with a fault
planted (half of the batch left out; the rendered answer altered by 1%).

    python3 perfbench/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--faults] [--out chiprun_out/readings.json]

A render cell's readings need no window: the kept pass does not depend on
the passes before it, so the pass the check would keep is rendered alone."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench.core import compare, port  # noqa: E402
from perfbench.core.cell import load_cell  # noqa: E402

MASK = 0xFFFFFFFF


def render_readings(cell, seeds, control_seeds, device):
    from perfbench.drivers import render_passes as R

    data = cell.scene()
    render, _ = R.program_pass(cell, data, device)
    out = []
    for kind, ss in (("program", seeds), ("control", control_seeds)):
        for seed in ss:
            t = time.perf_counter()
            k, ids = R.plan(cell, seed)
            s = (seed + k) & MASK
            ref = R.reference_pass(cell, data, device, s, ids)
            if kind == "program":
                with torch.no_grad():
                    img = render(s)
                prog = img.reshape(-1, 3)[torch.as_tensor(ids, device=device)] if ids is not None else img
            else:
                prog = R.reference_pass(cell, data, device, s, ids, torch.bfloat16).float()
            nums = compare.image_numbers(prog, ref)
            out.append(dict(kind=kind, seed=seed, seconds=time.perf_counter() - t, **nums))
            print(json.dumps(out[-1]), flush=True)
    return out


def grad_readings(cell, seeds, control_seeds, faults, device):
    from perfbench.drivers import grad_steps as G

    data = cell.scene()
    n = cell.traffic["checked_steps"]

    def program(seed, fault=None):
        med0 = port.media(data, device)
        p0 = G.initial_params(cell, med0, seed, device)
        steps = G.Steps(cell, data, seed, device, p0)
        if fault == "half_batch":
            steps.spp = steps.spp // 2          # half the lanes, the mean over the rest
        base_render = port.render_vol
        if fault == "answer_altered":
            port.render_vol = lambda *a, **k: base_render(*a, **k) * 1.01
        try:
            out = {"losses": []}
            for i in range(1, n + 1):
                out["losses"].append(steps(i))
                if i == 1:
                    out["grad1"] = steps.first_gradient()
            out["change3"] = {k: x.detach().clone() - p0[k] for k, x in steps.leaves.items()}
        finally:
            port.render_vol = base_render
        return p0, out

    rows = []
    plan = [("program", s, None) for s in seeds] + [("control", s, None) for s in control_seeds]
    if faults:
        plan += [("fault", s, f) for f in ("half_batch", "answer_altered") for s in control_seeds]
    for kind, seed, fault in plan:
        t = time.perf_counter()
        med0 = port.media(data, device)
        p0 = G.initial_params(cell, med0, seed, device)
        ref = G.reference_steps(cell, data, seed, device, p0)
        if kind == "control":
            prog = G.reference_steps(cell, data, seed, device, p0, torch.bfloat16)
        else:
            _, prog = program(seed, fault)
        nums = compare.train_numbers(prog, ref)
        rows.append(dict(kind=kind, fault=fault, seed=seed, seconds=time.perf_counter() - t, **nums))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    cell = load_cell(args.workload)
    if cell.traffic["driver"] == "grad_steps":
        rows = grad_readings(cell, seeds, control, args.faults, "cuda")
    else:
        rows = render_readings(cell, seeds, control, "cuda")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
