"""Entropy estimators for ELBO objectives (port of objectives/entropy.py).

This slice ports the three estimators ``KLMinRepGradDescent`` accepts:

- CLOSED_FORM:  entropy(q), differentiated;
- MONTE_CARLO:  -mean log q(z) with z and q both live;
- STL:          -mean log q_stop(z), the sticking-the-landing estimator
                (Roeder et al. 2017): only the path derivative through z.

``q_stop`` is a detached copy of ``q`` (core/pytree.tree_stop_gradient).
``estimate_entropy_from_draw`` is the reference's solve-free path: for
z = scale * u + location the whitening scale^{-1}(z - m) is u itself, so
values come from u and the STL gradient in z is (1/n) scale^{-T} (-score(u)).
"""

from __future__ import annotations

import torch

CLOSED_FORM = "closed_form"
MONTE_CARLO = "monte_carlo"
STL = "stl"


def estimate_entropy(estimator: str, samples: torch.Tensor, q, q_stop) -> torch.Tensor:
    """Estimate H(q) from (n, d) reparameterized samples."""
    if estimator == CLOSED_FORM:
        return q.entropy()
    if estimator == MONTE_CARLO:
        return -torch.mean(q.log_prob(samples))
    if estimator == STL:
        return -torch.mean(q_stop.log_prob(samples))
    raise ValueError(f"unknown entropy estimator: {estimator!r}")


def _base_neg_mean_logp(q, u: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(q.base.log_prob(u), dim=-1))


class _STLEntropyFast(torch.autograd.Function):
    """Value -mean log q_stop(z) computed from u; gradient only in z:
    d/dz_i = -(1/n) scale^{-T} score(u_i) (the reference's _stl_entropy_fast)."""

    @staticmethod
    def forward(ctx, z, u, q_stop):
        ctx.save_for_backward(u)
        ctx.q_stop = q_stop
        return _base_neg_mean_logp(q_stop, u) + q_stop.log_det_scale()

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        q_stop = ctx.q_stop
        n = u.shape[0]
        bar_z = (-g / n) * q_stop.apply_inv_scale_T(q_stop.base.score(u))
        return bar_z, None, None


def estimate_entropy_from_draw(
    estimator: str, z: torch.Tensor, u: torch.Tensor, q, q_stop
) -> torch.Tensor:
    """Same estimators, values and gradients as ``estimate_entropy`` for a
    draw (z, u) with z = scale * u + location, without the whitening."""
    if estimator == CLOSED_FORM:
        return q.entropy()
    if estimator == MONTE_CARLO:
        return _base_neg_mean_logp(q, u) + q.log_det_scale()
    if estimator == STL:
        return _STLEntropyFast.apply(z, u, q_stop)
    raise ValueError(f"unknown entropy estimator: {estimator!r}")
