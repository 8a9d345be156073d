"""The comparisons that decide `correct`, between what the timed path
produced and what the plain reference (portbench/reference) works out
again. Each returns {number name: value}; the cell's workload file gives
each number its limit ("limits"), and a run is correct where every number
is at or under its limit (judge).

Images (render cells), over the pixels compared:
    count_mismatch_share  share of pixels whose sample count differs
    mean_rel_gap          sum |mean - mean_ref| / sum |mean_ref| (every
                          channel of every pixel)
    bad_pixel_share       share of pixels with |mean - mean_ref| > 1e-3
                          in some channel

Inverse rendering (the first steps of the optimiser), leaves being the
fields of the parameter bundle:
    loss_gap              max over the steps of |loss - loss_ref| / |loss_ref|
    grad_gap              max over leaves of | |g| - |g_ref| | / max(|g_ref|,
                          the median leaf's |g_ref|), first step
    change_gap            the same of the parameters' change over the steps
Leaves whose reference gradient is under a thousandth of the median
leaf's (those the loss does not reach) are left out of both.
"""

from __future__ import annotations

import math

import torch

BAD_PIXEL_ABS = 1e-3
QUIET_LEAF = 1e-3


def image_numbers(mean, count, ref_mean, ref_count) -> dict:
    """Partial sums of the image numbers over some pixels (so that ranks
    can add theirs): tensors on any device, [N, 3] and [N]."""
    mean = mean.to(torch.float64)
    ref = ref_mean.to(mean.device, torch.float64)
    gap = (mean - ref).abs()
    return {
        "pixels": float(mean.shape[0]),
        "count_mismatch": float((count.to(ref_count.device)
                                 != ref_count).sum()),
        "abs_gap": float(gap.sum()),
        "abs_ref": float(ref.abs().sum()),
        "bad_pixels": float((gap > BAD_PIXEL_ABS).any(dim=1).sum()),
    }


def image_summary(parts) -> dict:
    """The image numbers from image_numbers' partial sums (added)."""
    tot = {k: sum(p[k] for p in parts) for k in parts[0]}
    return {
        "count_mismatch_share": tot["count_mismatch"] / tot["pixels"],
        "mean_rel_gap": tot["abs_gap"] / max(tot["abs_ref"], 1e-30),
        "bad_pixel_share": tot["bad_pixels"] / tot["pixels"],
    }


def _norm(t) -> float:
    return float(t.detach().to(torch.float64).norm())


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return 0.5 * (xs[(n - 1) // 2] + xs[n // 2])


def loud_leaves(ref_grad: dict):
    """Leaves whose reference gradient norm is at least QUIET_LEAF of the
    median leaf's, with the median taken over the leaves the loss moves."""
    norms = {k: _norm(g) for k, g in ref_grad.items()}
    moved = [v for v in norms.values() if v > 0]
    med = _median(moved) if moved else 0.0
    return [k for k, v in norms.items() if v >= QUIET_LEAF * med and v > 0]


def _leaf_gap(got: dict, want: dict, leaves) -> float:
    norms = {k: _norm(want[k]) for k in leaves}
    med = _median(list(norms.values()))
    return max(abs(_norm(got[k]) - norms[k]) / max(norms[k], med, 1e-30)
               for k in leaves)


def grad_numbers(losses, ref_losses, grad, ref_grad, change,
                 ref_change) -> dict:
    """The inverse-rendering numbers: losses of each step, the first
    step's gradients, the change of the parameters over the steps
    ({leaf: tensor}). Returns the three gaps and the leaves held."""
    leaves = loud_leaves(ref_grad)
    loss_gap = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                   for a, b in zip(losses, ref_losses))
    if len(losses) != len(ref_losses) or not all(
            math.isfinite(float(x)) for x in losses):
        loss_gap = math.inf
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap(grad, ref_grad, leaves),
        "change_gap": _leaf_gap(change, ref_change, leaves),
    }, leaves


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number that has a
    limit, at or under it. A NaN reads as failed."""
    compared = {}
    ok = True
    for name, limit in limits.items():
        value = float(numbers[name])
        compared[name] = {"value": value, "limit": float(limit)}
        if not value <= limit:
            ok = False
    return ok, compared
