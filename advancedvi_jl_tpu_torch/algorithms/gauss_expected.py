"""Gaussian expectations of the target's gradient and Hessian (port of
algorithms/gauss_expected.py; reference gauss_expected_grad_hess.jl:20-80).

- **Stein path** (order-1 targets, or ``hessian="stein"``): one full-rank
  draw (z, u) (K7b on the card), the batched gradients at z, then
  E[H] = C^-T E[u grad^T]: one (d, n) x (n, d) product and one triangular
  solve (``torch.linalg.solve_triangular``, as the JAX package leaves this
  solve to XLA).
- **Order-2 path**: the mean of the batched exact Hessians
  (``log_density_grad_and_hess``).

Under a device mesh with ``mc_axis`` each rank draws its rows; the three
means become its rows' means weighted by rows / n, summed over the axis
and averaged over the others (``reduce_shares``: a data axis's blocks),
and the solve runs on every rank.  The rows are the estimate's split terms
(``terms_split``): a target whose data axis is ``mc_axis`` evaluates them
on every row of its data.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..core.problem import (
    ORDER_GRAD,
    ORDER_VALUE_ONLY,
    log_density_and_grad,
    log_density_grad_and_hess,
    order_of,
)
from ..families.location_scale import FullRankLocationScale
from ..objectives.repgradelbo import draw_with_base, mc_share
from ..parallel.mesh import reduce_shares, terms_split


def check_capability_at_least_grad(prob: Any, alg_name: str) -> None:
    """Measure-space algorithms refuse order-0 targets (reference
    klminnaturalgraddescent.jl:73-79)."""
    if order_of(prob) <= ORDER_VALUE_ONLY:
        raise ValueError(
            f"{alg_name} requires at least first-order differentiation "
            "capability; the supplied target is value-only (order 0)."
        )


def gaussian_expected_grad_hess(
    key,
    q: FullRankLocationScale,
    n_samples: int,
    prob: Any,
    mc_axis: Optional[str] = None,
    hessian: str = "auto",
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(E[log pi], E[grad log pi], E[hess log pi]) under q = N(m, C C^T).

    ``hessian``: ``"auto"`` (the Stein path for order-1 targets, exact
    Hessians otherwise), ``"stein"`` (the Stein estimator for any target)
    or ``"exact"`` (batched exact Hessians; refuses order-1 targets).
    ``noise``: optional (n_samples, d) base draws in place of the sampler.
    ``mc_axis``: the mesh axis that splits the samples (parallel/mesh.py).
    """
    if hessian not in ("auto", "stein", "exact"):
        raise ValueError(
            f"hessian must be 'auto', 'stein', or 'exact', got {hessian!r}"
        )
    order = order_of(prob)
    if hessian == "exact" and order == ORDER_GRAD:
        raise ValueError(
            "hessian='exact' requires an order-2 or JAX-differentiable "
            "target; this target only provides gradients (order 1). Use "
            "hessian='stein' or 'auto'."
        )
    q_draw, rows = mc_share(q, n_samples, mc_axis)
    z, u = draw_with_base(q_draw, key, n_samples, noise, rows)  # one K7b launch on the card
    with terms_split(mc_axis):
        if order == ORDER_GRAD or hessian == "stein":
            # Stein/Price identity: E[hess] = C^-T E[u grad(C u + m)^T]
            logpi, grads = log_density_and_grad(prob, z)
            means = [torch.mean(logpi), torch.mean(grads, dim=0), (u.T @ grads) / z.shape[0]]
        else:
            logpi, grads, hesses = log_density_grad_and_hess(prob, z)
            means = [torch.mean(logpi), torch.mean(grads, dim=0), torch.mean(hesses, dim=0)]
    if rows is not None:
        means = [m * (rows[1] / n_samples) for m in means]
    logpi_avg, grad, hess = reduce_shares(means, mc_axis)  # as they are outside a mesh
    if order == ORDER_GRAD or hessian == "stein":
        hess = torch.linalg.solve_triangular(q.tril_scale().T, hess, upper=True)
    return logpi_avg, grad, hess
