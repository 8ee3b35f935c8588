"""The comparison that decides a training cell's ``correct``.

Each side (the program, the reference) reports over the first steps of a
run: the loss of each step, the norm of each leaf's first gradient as the
optimizer gets it, and the norm of each leaf's change over the steps. Three
numbers are compared, each against a limit of its own that the cell's
workload file states (``limits``; ``PERF.md`` gives the readings each was set
from):

* ``loss_rel_gap``: the largest ``|loss_p - loss_r| / |loss_r|`` over the
  steps;
* ``grad_norm_gap``: over the leaves, the largest gap between the two
  sides' gradient norms, ``|n_p - n_r|``, over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_norm_gap``: the same of the change norms, over the leaves whose
  reference gradient is at least ``COUNTED_GRAD_SHARE`` of the median
  leaf's (a leaf whose gradient is nought to rounding moves by round-off
  alone under Adam), measured against the median of those leaves' changes.
"""

from __future__ import annotations

import math

import torch

__all__ = ["COUNTED_GRAD_SHARE", "NUMBERS", "counted", "judge", "leaf_gaps", "readings"]

NUMBERS = ("loss_rel_gap", "grad_norm_gap", "change_norm_gap")
COUNTED_GRAD_SHARE = 1e-3


def counted(ref_grad_norms: torch.Tensor) -> torch.Tensor:
    """The leaves whose change is compared: a reference gradient of at
    least ``COUNTED_GRAD_SHARE`` of the median leaf's."""
    g = ref_grad_norms.double()
    return g >= COUNTED_GRAD_SHARE * g.median()


def leaf_gaps(got: torch.Tensor, want: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``|got - want| / max(want, median(want))`` over the entries that
    ``keep`` marks (the median over those too); a NaN reads infinite."""
    g, w = got.double()[keep], want.double()[keep]
    gaps = (g - w).abs() / torch.maximum(w, w.median())
    return torch.where(torch.isnan(gaps), torch.full_like(gaps, math.inf), gaps)


def _worst_gap(got: torch.Tensor, want: torch.Tensor, keep: torch.Tensor):
    """``(gap, index)``: the largest of :func:`leaf_gaps`."""
    gaps = leaf_gaps(got, want, keep)
    i = int(gaps.argmax())
    return float(gaps[i]), int(keep.nonzero()[i])


def readings(prog: dict, ref: dict, names=None) -> dict:
    """The three numbers of the module docstring, with the worst leaf of
    each gap (by index, or by ``names[index]``)."""
    lp, lr = prog["losses"], ref["losses"]
    if len(lp) != len(lr):
        raise ValueError(f"the sides ran {len(lp)} and {len(lr)} steps")
    loss_gap = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf) for a, b in zip(lp, lr))
    gr = ref["grad_norms"]
    keep = counted(gr)
    grad_gap, gi = _worst_gap(prog["grad_norms"], gr, torch.ones_like(keep))
    change_gap, ci = _worst_gap(prog["change_norms"], ref["change_norms"], keep)

    def name(i):
        return names[i] if names is not None else i

    return {"loss_rel_gap": loss_gap, "grad_norm_gap": grad_gap, "change_norm_gap": change_gap,
            "worst_grad_leaf": name(gi), "worst_change_leaf": name(ci),
            "leaves_counted": int(keep.sum()), "leaves": int(gr.numel())}


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})`` over the numbers that
    ``limits`` gives a limit (``None``: the number is not compared): each
    at most its limit (a NaN never is)."""
    unknown = set(limits) - set(NUMBERS)
    if unknown:
        raise ValueError(f"limits for unknown numbers {sorted(unknown)}; known: {NUMBERS}")
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items() if v is not None}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
