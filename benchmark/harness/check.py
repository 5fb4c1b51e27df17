"""The comparison that decides ``correct``.

Training: the first ``checked_steps`` steps of the timed step, taken in
set-up on distinct batches, against the reference's.  Compared
(``COMPARED``): the first step's four loss terms and total, the worst
relative gap (``first_loss_gap``); the first gradient as the optimiser
got it, worked out from its momentum after one step, and the parameters'
change over the steps, each by the median leaf (``grad_median_gap``,
``update_median_gap``): the gap between the program's norm of a leaf and
the reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger.  A leaf whose reference gradient is under a
thousandth of the median leaf's moves by round-off alone and is left out
of the change.  Recorded beside them and not compared (``PERF.md`` says
why): the worst step's loss gap and the worst leaf's gaps, which the
float32 rounding of the scalar norm parameters' gradients sets.

Validation: every answer of the window (a batch's four loss terms and
total) against the reference's for its batch (``eval_loss_gap``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

TERMS = ("loss_edge_cls", "loss_node_cls", "loss_node_reg", "loss_obj_cls", "loss_total")
NOUGHT = 1e-3  # a leaf's reference gradient under this share of the median's


def _rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-12)


def loss_gap(prog: Sequence[Dict[str, float]], ref: Sequence[Dict[str, float]]) -> float:
    return max(_rel(p[k], r[k]) for p, r in zip(prog, ref) for k in TERMS)


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def moved_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    norms = _norms(ref_grad)
    median = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= NOUGHT * median]


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Sequence[str]) -> Dict[str, float]:
    """Each leaf among ``keep``: |‖prog‖ − ‖ref‖| over max(‖ref‖, median
    leaf's ‖ref‖)."""
    pn, rn = _norms({k: prog[k] for k in keep}), _norms({k: ref[k] for k in keep})
    median = float(np.median([rn[k] for k in keep]))
    return {k: (abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30) if math.isfinite(pn[k])
                else math.inf) for k in keep}


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    """prog and ref: ``losses`` (a list of dicts of floats, one a step),
    ``grad`` and ``delta`` (dicts of tensors by leaf name).  The numbers
    compared (``COMPARED``) and, recorded beside them, the worst step's
    loss gap and the worst leaf's gaps."""
    grad = leaf_gaps(prog["grad"], ref["grad"], list(ref["grad"]))
    delta = leaf_gaps(prog["delta"], ref["delta"], moved_leaves(ref["grad"]))
    return {
        "first_loss_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
        "grad_median_gap": float(np.median(list(grad.values()))),
        "update_median_gap": float(np.median(list(delta.values()))),
        "loss_gap_all_steps": loss_gap(prog["losses"], ref["losses"]),
        "grad_worst_leaf_gap": max(grad.values()),
        "update_worst_leaf_gap": max(delta.values()),
    }


COMPARED = ("first_loss_gap", "grad_median_gap", "update_median_gap", "eval_loss_gap")


def train_detail(prog: dict, ref: dict) -> dict:
    """Where the training readings come from: each step's worst loss term
    and gap, the worst leaves of the gradient and of the change."""
    out = {"loss_steps": [max(((_rel(p[k], r[k]), k) for k in TERMS))
                          for p, r in zip(prog["losses"], ref["losses"])]}
    for name, keep in (("grad", list(ref["grad"])), ("delta", moved_leaves(ref["grad"]))):
        gaps = leaf_gaps(prog[name], ref[name], keep)
        out[name] = {"worst": sorted(gaps.items(), key=lambda kv: -kv[1])[:3],
                     "left_out": len(ref["grad"]) - len(keep)}
    return out


def eval_numbers(answers: Sequence[tuple], ref: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """answers: (batch index, the step's metrics as floats)."""
    return {"eval_loss_gap": max(_rel(m[k], ref[b][k]) for b, m in answers for k in TERMS)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
