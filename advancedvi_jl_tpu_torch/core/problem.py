"""Target log-density protocol (PyTorch port of core/problem.py).

A target is any object exposing

- ``log_density(theta) -> tensor``: ``theta`` has shape ``(..., d)`` and the
  result has the batch shape ``(...)``, so a batch of Monte-Carlo samples is
  one call (the port's replacement for ``jax.vmap``);
- ``dim``: the dimension ``d``;
- optionally ``order()`` and ``log_density_and_grad(theta)``.

Gradients come from ``torch.autograd``.
"""

from __future__ import annotations

from typing import Any

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
