"""The numbers that decide `correct`, each held against its limit.

Training (the first three steps that the program runs through the window's
own call and feed, and the plain reference given the same weights, rows and
dropout seed):

  loss_gap    the largest |L_prog - L_ref| / |L_ref| over the three steps;
  grad_gap    over the parameters (leaves), the largest gap between the
              norms of the first step's gradient, |‖g_prog‖ - ‖g_ref‖|, over
              the larger of the reference leaf's norm and the median leaf's;
              the program's gradient is read back from Adam's first moment
              after one step (m = (1 - beta1) g);
  change_gap  the same of the parameters' change after three steps, over
              the leaves whose reference gradient is at least MOVED_FLOOR
              of the median leaf's (a key bias under softmax moves under
              Adam by round-off alone);
  grad_median_gap, change_median_gap
              the median leaf's gap instead of the worst's.

Serving: logit_gap, the largest ‖logits_prog - logits_ref‖ / ‖logits_ref‖
over the sampled images and both heads. JPEG decode: decode_diff, the
largest |program byte - reference byte| over the images the loader handed
the checked steps. A cell compares the numbers its workload file gives a
limit; the others are printed as readings.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

MOVED_FLOOR = 1e-3


@dataclass
class TrainReadings:
    losses: list = field(default_factory=list)
    grad: dict = field(default_factory=dict)      # leaf -> ‖g1‖
    change: dict = field(default_factory=dict)    # leaf -> ‖p3 - p0‖


def _leaf_gap(prog: dict, ref: dict, keep, over=max) -> float:
    """`over` (the worst, or the median) of the kept leaves' gaps."""
    med = float(np.median([ref[k] for k in ref]))
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref if keep(k)]
    return float(over(gaps)) if gaps else math.inf


def compare_train(prog: TrainReadings, ref: TrainReadings) -> dict:
    if set(prog.grad) != set(ref.grad) or set(prog.change) != set(ref.change):
        raise ValueError("the program's and the reference's leaves differ")
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses))
    med = float(np.median(list(ref.grad.values())))
    moved = lambda k: ref.grad[k] >= MOVED_FLOOR * med
    every = lambda k: True
    return {"loss_gap": loss,
            "grad_gap": _leaf_gap(prog.grad, ref.grad, every),
            "grad_median_gap": _leaf_gap(prog.grad, ref.grad, every,
                                         np.median),
            "change_gap": _leaf_gap(prog.change, ref.change, moved),
            "change_median_gap": _leaf_gap(prog.change, ref.change, moved,
                                           np.median)}


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> list:
    """[(gap, leaf)] of the n leaves with the largest gaps."""
    med = float(np.median(list(ref.values())))
    return sorted(((abs(prog[k] - ref[k]) / max(ref[k], med), k)
                   for k in ref), reverse=True)[:n]


def compare_logits(prog: list, ref: list) -> dict:
    """prog, ref: [style [rows, C], genre [rows, C']] arrays."""
    gap = 0.0
    for p, r in zip(prog, ref):
        num = np.linalg.norm(np.asarray(p, np.float64)
                             - np.asarray(r, np.float64), axis=1)
        den = np.linalg.norm(np.asarray(r, np.float64), axis=1)
        gap = max(gap, float((num / den).max()))
    return {"logit_gap": gap}


def compare_bytes(prog: np.ndarray, ref: np.ndarray) -> dict:
    return {"decode_diff": float(np.abs(prog.astype(np.int16)
                                        - ref.astype(np.int16)).max())}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that the
    cell's limits name: correct when each is finite and at most its limit.
    A cell without limits is not correct."""
    unknown = set(limits) - set(numbers)
    if unknown:
        raise KeyError(f"limits of numbers the check does not read: "
                       f"{sorted(unknown)}")
    out = {name: {"value": numbers[name], "limit": limit}
           for name, limit in limits.items()}
    ok = bool(out) and all(math.isfinite(v["value"])
                           and v["value"] <= v["limit"]
                           for v in out.values())
    return ok, out
