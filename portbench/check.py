"""The comparison that decides ``correct`` for a training cell.

Three numbers, each against its limit from ``checks/<cell>.json``:

- ``loss_gap``: the largest gap, in nats, between the program's and the
  reference's loss over the checked steps;
- ``grad_gap``: by the worst parameter, the gap between the norms of the
  first step's gradient (the program's worked out from AdamW's first moment,
  ``‖m₁‖ / (1 − β₁)``), over the larger of the reference's norm of that
  parameter and its median over parameters;
- ``change_gap``: the same, of the norms of each parameter's change over the
  checked steps, leaving out parameters whose reference gradient is under a
  thousandth of the median (they move under AdamW by rounding alone).

A number that is not finite, or missing, fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

from .reference import Readings

# A parameter whose first reference gradient is under this share of the
# median parameter's takes no part in change_gap.
STILL_GRAD = 1e-3


def _worst(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    worst = 0.0
    for n in names:
        p = prog.get(n, math.nan)
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - ref[n]) / max(ref[n], med))
    return worst


def moving(ref: Readings) -> list:
    """The parameters that take part in ``change_gap``."""
    med = statistics.median(ref.grad_norms.values())
    return [n for n, g in ref.grad_norms.items() if g >= STILL_GRAD * med]


def numbers(prog: Readings, ref: Readings) -> Dict[str, float]:
    """``{"loss_gap", "grad_gap", "change_gap"}`` of the program's readings
    against the reference's."""
    if len(prog.losses) != len(ref.losses):
        loss_gap = math.inf
    else:
        gaps = [abs(a - b) for a, b in zip(prog.losses, ref.losses)]
        loss_gap = max(g if math.isfinite(g) else math.inf for g in gaps)
    return {
        "loss_gap": loss_gap,
        "grad_gap": _worst(prog.grad_norms, ref.grad_norms, ref.grad_norms),
        "change_gap": _worst(prog.change_norms, ref.change_norms, moving(ref)),
    }


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each limited number with its value and limit, and whether it held."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        out[name] = {"value": v, "limit": limit, "ok": math.isfinite(v) and v <= limit}
    return out
