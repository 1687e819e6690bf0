"""The comparison that decides ``correct``: the program's readings after its
first steps against the plain reference's from the same weights and
batches.

Readings (:func:`portbench.reference.common.train_readings` gives the
reference's; the harness takes the program's from the same steps of the
window's own call): each step's loss, every leaf's first gradient norm
(the program's worked out from its optimizer state after one step), and
every leaf's change norm after the last step, of the parameters and of
the state the step threads (BatchNorm's running statistics).

Numbers compared, each against the cell's limit:

- ``loss_gap``: the largest ``|loss - loss_ref| / |loss_ref|`` over the
  steps;
- ``grad_gap``: over every leaf, the largest gap between the two first
  gradient norms, ``|‖g‖ - ‖g_ref‖|``, over the larger of the leaf's
  reference norm and the median leaf's;
- ``change_gap``: the same of the parameters' change, leaving out the
  leaves whose reference gradient is under a thousandth of the median
  leaf's (a key's bias under softmax: its gradient is zero to rounding,
  and Adam-type rules move it by round-off alone);
- ``state_gap``: the same of the state's change (where the step threads
  state).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of the change comparison
NEGLIGIBLE_GRAD = 1e-3


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keys: Iterable[str]) -> Tuple[float, Optional[str]]:
    """The largest gap of norms over ``keys``, each over the larger of the
    leaf's reference norm and the median leaf's, and its leaf."""
    keys = list(keys)
    if not keys:
        return 0.0, None
    median = statistics.median(ref[k] for k in keys)
    worst, leaf = -1.0, None
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def gaps(prog: dict, ref: dict) -> Dict[str, Tuple[float, Optional[str]]]:
    """Every number compared, with the step or leaf it was worst at."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program's leaves differ from the reference's")
    out = {}
    worst, at = -1.0, None
    for i, (lp, lr) in enumerate(zip(prog["losses"], ref["losses"])):
        gap = abs(lp - lr) / abs(lr)
        if not math.isfinite(gap):
            gap = math.inf
        if gap > worst:
            worst, at = gap, f"step {i + 1}"
    out["loss_gap"] = (worst, at)
    g_ref = ref["grad_norms"]
    out["grad_gap"] = worst_leaf(prog["grad_norms"], g_ref, g_ref)
    median = statistics.median(g_ref.values())
    moved = [k for k, v in g_ref.items() if v >= NEGLIGIBLE_GRAD * median]
    out["change_gap"] = worst_leaf(prog["change_norms"], ref["change_norms"],
                                   moved)
    if ref["state_change_norms"]:
        out["state_gap"] = worst_leaf(prog["state_change_norms"],
                                      ref["state_change_norms"],
                                      ref["state_change_norms"])
    return out


def judge(found: Dict[str, Tuple[float, Optional[str]]],
          limits: Dict[str, float]) -> Tuple[bool, dict]:
    """``(correct, checks)``: every number within its limit, and each with
    its limit and where it was worst (a number that is not finite is
    written as a string)."""
    if set(found) != set(limits):
        raise ValueError(f"the cell's limits name {sorted(limits)}; the "
                         f"comparison reads {sorted(found)}")
    checks, ok = {}, True
    for name, (value, at) in found.items():
        good = math.isfinite(value) and value <= limits[name]
        ok = ok and good
        checks[name] = {"value": value if math.isfinite(value)
                        else str(value), "limit": limits[name],
                        "worst_at": at}
    return ok, checks
