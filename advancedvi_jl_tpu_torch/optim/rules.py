"""Optimizer rules as gradient transformations (port of optim/rules.py).

Each rule is a pair ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)`` over a family dataclass,
with optax's convention that ``updates`` are ADDED to the parameters.

- ``adam``: optax's ``scale_by_adam`` followed by ``scale_by_learning_rate``,
  written out so that its moments compare one to one with the reference
  (bias correction 1 - b^count with count starting at 1, eps outside the
  square root).  It is deliberately not ``torch.optim.Adam``.
- ``dowg``: DoWG (reference rules.jl:17-34), the constructor's default:
  eta = r^2 / sqrt(v), r = max(||x - x0||, r), v += r^2 ||g||^2, with norms
  global over all tensors of the family.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..core.pytree import tree_global_norm_sq, tree_map


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class AdamState(NamedTuple):
    count: int
    mu: Any
    nu: Any


class DoWGState(NamedTuple):
    x0: Any
    v: torch.Tensor  # accumulated weighted squared gradient norms
    r: torch.Tensor  # running distance estimate


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def adam(
    learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
) -> GradientTransformation:
    def init_fn(params):
        return AdamState(
            count=0,
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    def update_fn(grads, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state.nu)
        count = state.count + 1
        # optax: 1 - decay**count in float32
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        updates = tree_map(
            lambda m, v: -learning_rate * ((m / bc1) / (torch.sqrt(v / bc2) + eps)),
            mu, nu,
        )
        return updates, AdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init_fn, update_fn)


def dowg(alpha: float = 1e-6) -> GradientTransformation:
    """DoWG; ``alpha`` scales the initial distance guess r0 = alpha (1 + ||x0||)."""

    def init_fn(params):
        r0 = alpha * (1.0 + torch.sqrt(tree_global_norm_sq(params)))
        return DoWGState(
            x0=tree_map(torch.clone, params),
            v=torch.zeros_like(r0),
            r=r0,
        )

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("dowg requires params")
        dist = torch.sqrt(
            tree_global_norm_sq(tree_map(torch.sub, params, state.x0))
        )
        r = torch.maximum(dist, state.r)
        r2 = r * r
        v = state.v + r2 * tree_global_norm_sq(grads)
        eta = r2 / torch.sqrt(v)
        return tree_map(lambda g: -eta * g, grads), DoWGState(x0=state.x0, v=v, r=r)

    return GradientTransformation(init_fn, update_fn)
