"""Target log-density protocol (PyTorch port of core/problem.py).

A target is any object exposing

- ``log_density(theta) -> tensor``: ``theta`` has shape ``(..., d)`` and the
  result has the batch shape ``(...)``, so a batch of Monte-Carlo samples is
  one call (the port's replacement for ``jax.vmap``);
- ``dim``: the dimension ``d``;
- optionally ``order()`` and ``log_density_and_grad(theta)``.

Gradients come from ``torch.autograd``.  A target that brings its own
gradient oracle is wrapped in ``CustomGradTarget``, whose backward is the
cotangent times the oracle's gradient (the JAX package's ``jax.custom_vjp``,
the reference's MixedADLogDensityProblem); ``fn_target`` makes a target of a
plain function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

# Capability orders, mirroring LogDensityProblems.LogDensityOrder{K}().
ORDER_VALUE_ONLY = 0
ORDER_GRAD = 1
ORDER_HESS = 2
ORDER_AUTOGRAD = 100  # differentiable by torch.autograd to any order
ORDER_JAX = ORDER_AUTOGRAD  # the reference package's name for the same level


def order_of(prob: Any) -> int:
    """Differentiation capability of a target (default: autograd-able)."""
    fn = getattr(prob, "order", None)
    if fn is None:
        return ORDER_AUTOGRAD
    return fn() if callable(fn) else int(fn)


def dim_of(prob: Any) -> int:
    d = getattr(prob, "dim")
    return d() if callable(d) else int(d)


def log_density(prob: Any, theta: torch.Tensor) -> torch.Tensor:
    return prob.log_density(theta)


def log_density_and_grad(prob: Any, theta: torch.Tensor):
    """Value and gradient in ``theta`` (batched over leading dims),
    preferring a target-supplied oracle."""
    fn = getattr(prob, "log_density_and_grad", None)
    if fn is not None:
        return fn(theta)
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        value = prob.log_density(th)
        (grad,) = torch.autograd.grad(value.sum(), th)
    return value.detach(), grad


def log_density_grad_and_hess(prob: Any, theta: torch.Tensor):
    """Value, gradient and Hessian (the order-2 path of the measure-space
    algorithms; JAX core/problem.py:69-81), preferring a target-supplied
    oracle.  ``theta`` of shape (..., d) gives a (..., d, d) Hessian.

    The rows of a batch are independent, so row j of every sample's Hessian
    is one product of the gradient's graph with e_j at every sample: one
    forward, one backward with its graph kept, and d vector products in one
    batched backward (``is_grads_batched``), whatever the batch.  (A
    per-sample ``torch.func.hessian`` under ``vmap`` computes the same
    values at 4-8x the host time.)"""
    fn = getattr(prob, "log_density_grad_and_hess", None)
    if fn is not None:
        return fn(theta)
    d = theta.shape[-1]
    with torch.enable_grad():
        z = theta.detach().reshape(-1, d).requires_grad_(True)
        v = prob.log_density(z)
        (g,) = torch.autograd.grad(v.sum(), z, create_graph=True)
        rows = torch.eye(d, dtype=z.dtype, device=z.device)[:, None, :].expand(d, *z.shape)
        (h,) = torch.autograd.grad(g, z, grad_outputs=rows, is_grads_batched=True)
    return (v.detach().reshape(theta.shape[:-1]), g.detach().reshape(theta.shape),
            h.transpose(0, 1).reshape(*theta.shape, d))


def subsample(prob_or_q: Any, indices: torch.Tensor) -> Any:
    """Restrict a target (or a variational family) to the data points
    ``indices``: its own ``subsample`` when it has one, otherwise the object
    itself (JAX core/problem.py:106-120; reference interface.jl)."""
    fn = getattr(prob_or_q, "subsample", None)
    if fn is None:
        return prob_or_q
    return fn(indices)


# ---------------------------------------------------------------------------
# Custom-gradient targets (MixedADLogDensityProblem analogue)
# ---------------------------------------------------------------------------


class _OracleLogDensity(torch.autograd.Function):
    """log pi(theta) whose backward is ct * the oracle's gradient (JAX
    core/problem.py:130-146, the reference's rrule)."""

    @staticmethod
    def forward(ctx, theta, data, value_fn, value_and_grad_fn):
        if not ctx.needs_input_grad[0]:
            return value_fn(theta, data)
        v, g = value_and_grad_fn(theta, data)
        ctx.save_for_backward(g)
        return v

    @staticmethod
    def backward(ctx, ct):
        (g,) = ctx.saved_tensors
        return ct[..., None] * g, None, None, None


@dataclass(frozen=True)
class CustomGradTarget:
    """A target that supplies its own gradient oracle (JAX
    core/problem.py:149-188).

    ``value_fn(theta, data)`` and ``value_and_grad_fn(theta, data)`` take
    ``theta`` of shape (..., d) and give the (...) values (and the (..., d)
    gradients).  Differentiating ``log_density`` goes through the oracle:
    the backward is ``ct * grad``.  ``value_grad_and_hess_fn`` raises the
    capability to order 2."""

    data: Any
    value_fn: Callable
    value_and_grad_fn: Callable
    dim: int
    capability: int = ORDER_GRAD
    value_grad_and_hess_fn: Optional[Callable] = None

    def order(self) -> int:
        if self.value_grad_and_hess_fn is not None:
            return max(self.capability, ORDER_HESS)
        return self.capability

    def log_density(self, theta: torch.Tensor) -> torch.Tensor:
        return _OracleLogDensity.apply(theta, self.data, self.value_fn, self.value_and_grad_fn)

    def log_density_and_grad(self, theta: torch.Tensor):
        return self.value_and_grad_fn(theta, self.data)

    def log_density_grad_and_hess(self, theta: torch.Tensor):
        if self.value_grad_and_hess_fn is None:
            raise ValueError("target has no Hessian oracle (order < 2)")
        return self.value_grad_and_hess_fn(theta, self.data)


def maybe_wrap_custom_grad(prob: Any) -> Any:
    """Use a target's own gradient oracle when it has one (JAX
    core/problem.py:191-208, reference RepGradELBO.init): a
    ``CustomGradTarget`` is used as it is, an autograd target is already
    optimal, and a value-only target (order 0) cannot feed a
    reparameterization gradient."""
    if isinstance(prob, CustomGradTarget):
        return prob
    if order_of(prob) == ORDER_VALUE_ONLY:
        raise ValueError(
            "Target has capability order 0 (value-only, not differentiable). "
            "Reparameterization-gradient objectives require a differentiable "
            "target; use ScoreGradELBO / KLMinScoreGradDescent instead."
        )
    return prob


# ---------------------------------------------------------------------------
# Simple functional target
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FnTarget:
    """A target built from a plain function ``fn(theta, data)`` of torch
    ops, batched as every target of the port: ``theta`` (..., d) gives
    (...) values (JAX core/problem.py:216-232, whose ``fn`` takes one
    vector)."""

    data: Any
    fn: Callable
    dim: int

    def order(self) -> int:
        return ORDER_AUTOGRAD

    def log_density(self, theta: torch.Tensor) -> torch.Tensor:
        return self.fn(theta, self.data)


def fn_target(fn: Callable, dim: int, data: Any = None) -> FnTarget:
    return FnTarget(data=data, fn=fn, dim=dim)
