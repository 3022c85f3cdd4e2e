"""The numbers that decide `correct`: each is computed from the program's
output and the reference's, and held to the cell's limit
(limits/<cell>.json, with the readings each limit was set from)."""
from __future__ import annotations

import statistics

import torch


def pixel_errors(prog, ref):
    """Per pixel, the L1 gap over the channels relative to the reference's
    L1 (floored at 1% of the mean pixel's, so a black pixel reads as one of
    average brightness)."""
    a, b = prog.reshape(-1, 3).double(), ref.reshape(-1, 3).double()
    num = (a - b).abs().sum(1)
    den = b.abs().sum(1)
    return num / torch.clamp(den, min=max(1e-2 * float(den.mean()), 1e-30))


def image_numbers(prog, ref) -> dict:
    """The compared numbers of a render cell: the median pixel's relative
    gap, and the share of pixels more than 1e-3 off."""
    e = pixel_errors(prog, ref)
    return {"px_err_median": float(e.median()),
            "px_off_share": float((e > 1e-3).double().mean())}


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap of norms, |‖p‖ - ‖r‖| over the larger of the
    leaf's reference norm and the median leaf's."""
    names = [n for n in ref if keep is None or n in keep]
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = statistics.median(rn.values())
    return max(abs(float(prog[n].double().norm()) - rn[n]) / max(rn[n], med, 1e-30)
               for n in names)


def train_numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of a training cell, from {"losses": [...],
    "grad1": {leaf: tensor}, "change3": {leaf: tensor}} of each side: the
    worst step's relative loss gap, the worst leaf's gap of first-gradient
    norms, and of the parameters' change after the checked steps over the
    leaves whose reference gradient is above a thousandth of the median
    leaf's (a leaf below moves by round-off alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    gn = {n: float(g.double().norm()) for n, g in ref["grad1"].items()}
    med = statistics.median(gn.values())
    keep = {n for n, v in gn.items() if v >= 1e-3 * med}
    return {"loss_gap": loss,
            "grad_gap": _leaf_gaps(prog["grad1"], ref["grad1"]),
            "step_gap": _leaf_gaps(prog["change3"], ref["change3"], keep)}


def judge(numbers: dict, limits: dict):
    """(correct, checks): every number at or under its limit; a number
    with no limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
