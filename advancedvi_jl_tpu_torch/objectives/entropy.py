"""Entropy estimators for ELBO objectives (port of objectives/entropy.py).

The five estimators of the reference (entropy.jl:11-90):

- CLOSED_FORM:            entropy(q), differentiated;
- CLOSED_FORM_ZERO_GRAD:  entropy(q_stop), detached (for the proximal
                          entropy operator);
- MONTE_CARLO:            -mean log q(z) with z and q both live;
- STL:                    -mean log q_stop(z), the sticking-the-landing
                          estimator (Roeder et al. 2017): only the path
                          derivative through z;
- STL_ZERO_GRAD:          STL - entropy(q) + entropy(q_stop): the STL value
                          with a mean-zero entropy gradient (for proximal
                          steps).

``q_stop`` is a detached copy of ``q`` (core/pytree.tree_stop_gradient).
``estimate_entropy_from_draw`` is the reference's solve-free path: for
z = scale * u + location the whitening scale^{-1}(z - m) is u itself, so
values come from u and the STL gradient in z is (1/n) scale^{-T} (-score(u)).
"""

from __future__ import annotations

import torch

CLOSED_FORM = "closed_form"
CLOSED_FORM_ZERO_GRAD = "closed_form_zero_grad"
MONTE_CARLO = "monte_carlo"
STL = "stl"
STL_ZERO_GRAD = "stl_zero_grad"

ALL_ENTROPY_ESTIMATORS = (CLOSED_FORM, CLOSED_FORM_ZERO_GRAD, MONTE_CARLO, STL,
                          STL_ZERO_GRAD)
# estimators whose entropy gradient has mean zero: the ones the proximal
# entropy operator takes (reference constructors.jl:122-157)
ZERO_GRAD_ESTIMATORS = (CLOSED_FORM_ZERO_GRAD, STL_ZERO_GRAD)


def estimate_entropy(estimator: str, samples: torch.Tensor, q, q_stop) -> torch.Tensor:
    """Estimate H(q) from (n, d) reparameterized samples."""
    if estimator == CLOSED_FORM:
        return q.entropy()
    if estimator == CLOSED_FORM_ZERO_GRAD:
        return q_stop.entropy()
    if estimator == MONTE_CARLO:
        return -torch.mean(q.log_prob(samples))
    if estimator == STL:
        return -torch.mean(q_stop.log_prob(samples))
    if estimator == STL_ZERO_GRAD:
        return -torch.mean(q_stop.log_prob(samples)) - q.entropy() + q_stop.entropy()
    raise ValueError(f"unknown entropy estimator: {estimator!r}")


def supports_fast_entropy(q) -> bool:
    """Whether a family takes ``estimate_entropy_from_draw``: it exposes
    ``apply_inv_scale_T``, ``log_det_scale`` and a base with ``score``."""
    return (
        hasattr(q, "apply_inv_scale_T")
        and hasattr(q, "log_det_scale")
        and hasattr(getattr(q, "base", None), "score")
    )


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
    if estimator == CLOSED_FORM_ZERO_GRAD:
        return q_stop.entropy()
    if estimator == MONTE_CARLO:
        return _base_neg_mean_logp(q, u) + q.log_det_scale()
    if estimator == STL:
        return _STLEntropyFast.apply(z, u, q_stop)
    if estimator == STL_ZERO_GRAD:
        return _STLEntropyFast.apply(z, u, q_stop) - q.entropy() + q_stop.entropy()
    raise ValueError(f"unknown entropy estimator: {estimator!r}")
