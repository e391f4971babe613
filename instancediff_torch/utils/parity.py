"""Holding one train step to a reference's, leaf by leaf: its gradients (or
Adam's first moments) and the parameters Adam made of them. The port's
tests hold it to JAX's step on the CPU, ``chip_smoke.py`` the card's step to
the CPU's. Trees are flat dicts of numpy arrays keyed by leaf path."""

from __future__ import annotations

import re

import numpy as np

# scalars whose gradient sums over every pixel, prompt and image: the score
# head's scale and bias of each score-map module
LARGE_REDUCTIONS = ("logit_scale", "score_bias")


def is_large_reduction(leaf: str) -> bool:
    """``leaf`` a flax path ("a/b/logit_scale") or a torch name ("a.logit_scale")."""
    return re.split(r"[/.]", leaf)[-1] in LARGE_REDUCTIONS


def _max(a) -> float:
    return float(np.abs(a).max())


def grad_tolerances(want: dict, tol: float, floor: float, reduction_tol: float,
                    slack=None) -> dict:
    """Each leaf's absolute tolerance: ``tol`` (``reduction_tol`` for a
    ``LARGE_REDUCTIONS`` leaf) times the leaf's own largest magnitude, and at
    least ``floor`` times the largest over the other leaves: the roundoff
    left in a gradient that cancels to (nearly) zero in exact arithmetic,
    such as a bias ahead of a one-channel GroupNorm group. Plus the leaf's
    ``slack``, where given (the reference's own spread on that leaf)."""
    scale = max(_max(v) for k, v in want.items() if not is_large_reduction(k))
    return {k: max((reduction_tol if is_large_reduction(k) else tol) * _max(v), floor * scale)
            + (slack[k] if slack else 0.0) for k, v in want.items()}


def check_grads(got: dict, want: dict, tol: float, floor: float, reduction_tol: float,
                slack=None, what: str = "") -> tuple:
    """Every leaf of ``got`` within ``grad_tolerances`` of ``want``'s.
    Returns the tolerances and a report: the worst error as a share of its
    leaf's largest magnitude (the large reductions' apart), and how many
    leaves pass only on the floor or the slack, with the worst of their
    errors beyond the slack as a share of the floor's scale."""
    assert sorted(got) == sorted(want), what
    tols = grad_tolerances(want, tol, floor, reduction_tol, slack)
    floor_scale = max(_max(v) for k, v in want.items() if not is_large_reduction(k))
    report = {"worst_of_leaf_max": 0.0, "worst_reduction_of_leaf_max": 0.0,
              "worst_on_floor_of_floor_scale": 0.0, "leaves": len(want),
              "leaves_on_floor": 0}
    for k, w in want.items():
        err, scale = _max(got[k] - w), max(_max(w), 1e-30)
        if not err <= tols[k]:
            raise AssertionError(f"{what}{k}: max abs err {err:.3g}, tolerance "
                                 f"{tols[k]:.3g}, leaf scale {scale:.3g}")
        reduction = is_large_reduction(k)
        key = "worst_reduction_of_leaf_max" if reduction else "worst_of_leaf_max"
        report[key] = max(report[key], err / scale)
        if err > (reduction_tol if reduction else tol) * scale:
            report["leaves_on_floor"] += 1
            report["worst_on_floor_of_floor_scale"] = max(
                report["worst_on_floor_of_floor_scale"],
                (err - (slack[k] if slack else 0.0)) / floor_scale)
    return tols, report


def adam_step_bound(lr: float, grad, grad_tol: float):
    """How far apart one Adam step of learning rate ``lr`` can put an element
    whose gradient ``grad`` is known to ``grad_tol``: the step is
    lr m/sqrt(v), so 2 lr min(1, grad_tol / |grad|) (a gradient within its
    tolerance of zero may flip the step's sign)."""
    return 2 * lr * np.minimum(1.0, grad_tol / np.maximum(np.abs(grad), 1e-30))


def check_params(got: dict, want: dict, tol: float, steps, cap: int, what: str = "") -> dict:
    """Every element of ``got`` within ``tol`` of its leaf's largest
    magnitude in ``want``, or, for at most ``cap`` elements, within that
    plus what Adam makes of its gradient's tolerance over ``steps``
    ((lr, gradient tree, gradient tolerance per leaf), one per step): the
    elements whose gradient lies within its tolerance of zero, where
    roundoff picks the step's size or sign. Returns how many took that
    allowance, of how many."""
    assert sorted(got) == sorted(want), what
    n_allowed = n = 0
    for k, w in want.items():
        err, base = np.abs(got[k] - w), tol * _max(w)
        allowed = base + sum(adam_step_bound(lr, g[k], gt[k]) for lr, g, gt in steps)
        if not np.all(err <= allowed):
            raise AssertionError(f"{what}{k}: {int((err > allowed).sum())} elements out, "
                                 f"worst {float(err.max()):.3g}")
        n_allowed += int((err > base).sum())
        n += w.size
    if n_allowed > cap:
        raise AssertionError(f"{what}{n_allowed} of {n} elements need Adam's allowance "
                             f"(at most {cap})")
    return {"adam_allowance_elements": n_allowed, "elements": n}
