"""The comparison that decides ``correct``: the numbers a run compares
with the plain reference, and their limits (``portbench/limits/<cell>.json``,
set from the program's and the control's readings, PERF.md)."""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np

LIMITS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "limits")

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone, and is not compared
GRAD_FLOOR = 1e-3


def limits(workload: str, limits_dir: str = LIMITS_DIR) -> Dict[str, float]:
    with open(os.path.join(limits_dir, f"{workload}.json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def leaf_gap(prog: Sequence[float], ref: Sequence[float],
             counted: Sequence[bool]) -> float:
    """The worst counted leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's."""
    ref = np.asarray(ref, np.float64)
    prog = np.asarray(prog, np.float64)
    med = float(np.median(ref))
    gaps = [abs(p - r) / max(r, med)
            for p, r, c in zip(prog, ref, counted) if c]
    return float(max(gaps)) if gaps else float("inf")


def counted_leaves(ref_grad_norms: Sequence[float]) -> list:
    g = np.asarray(ref_grad_norms, np.float64)
    return list(g >= GRAD_FLOOR * float(np.median(g)))


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``loss_gap`` (the worst step's relative gap of the loss),
    ``grad_gap`` (the first gradient's norms, leaf by leaf) and
    ``change_gap`` (each leaf's change after the steps)."""
    counted = counted_leaves(ref["grad_norms"])
    lp = np.asarray(prog["losses"], np.float64)
    lr = np.asarray(ref["losses"], np.float64)
    if len(lp) != len(lr) or not np.all(np.isfinite(lp)):
        loss_gap = float("inf")
    else:
        loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"],
                                 counted),
            "change_gap": leaf_gap(prog["change"], ref["change"], counted)}


def pred_gap(prog: np.ndarray, ref_raw: np.ndarray, means: np.ndarray,
             stds: np.ndarray) -> float:
    """The widest gap of a served prediction from the reference's, in
    units of the task's scale (the target scaler's deviation times the
    reference's root mean square raw output over the sample)."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref_raw, np.float64) * stds + means
    if prog.shape != ref.shape or not np.all(np.isfinite(prog)):
        return float("inf")
    scale = stds * np.sqrt(np.mean(np.asarray(ref_raw, np.float64) ** 2, 0))
    return float(np.max(np.abs(prog - ref) / scale))


def judge(numbers: Dict[str, float], lim: Dict[str, float]) -> tuple:
    """``(correct, checks)``: every number within its limit, and each
    number beside its limit."""
    checks = {k: {"value": float(numbers[k]), "limit": lim[k]}
              for k in lim}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return bool(ok), checks
