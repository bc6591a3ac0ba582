"""Optimizer rules as gradient transformations (port of optim/rules.py).

Each rule is a pair ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)`` over a family dataclass,
with optax's convention that ``updates`` are ADDED to the parameters.

- ``adam``: optax's ``scale_by_adam`` followed by ``scale_by_learning_rate``,
  written out so that its moments compare one to one with the reference
  (bias correction 1 - b^count with count starting at 1, eps outside the
  square root).  It is deliberately not ``torch.optim.Adam``.
- ``dowg``: DoWG (reference rules.jl:17-34), the constructors' default:
  eta = r^2 / sqrt(v), r = max(||x - x0||, r), v += r^2 ||g||^2.
- ``dog``: DoG (rules.jl:48-64): eta = r / sqrt(v), v += ||g||^2.
- ``cocob``: COCOB-Backprop coin betting (rules.jl:78-96), elementwise.
- ``descent``: constant step size, kept in the state so that the proximal
  entropy operator can read it.

DoG and DoWG norms are global over all tensors of the family, as the
reference's flattened parameter vector.  ``stepsize_from_opt_state`` reads
the step size the proximal operator needs (descent, DoG, DoWG only).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.pytree import tree_global_norm_sq, tree_leaves, tree_map


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


class DoGState(NamedTuple):
    x0: Any
    v: torch.Tensor  # accumulated squared gradient norms
    r: torch.Tensor  # running distance estimate


class COCOBState(NamedTuple):
    L: Any  # per-coordinate max absolute gradient
    G: Any  # per-coordinate absolute gradient sum
    R: Any  # per-coordinate "reward"
    theta: Any  # per-coordinate summed negative gradients
    x1: Any  # initial parameters


class DescentState(NamedTuple):
    """Constant step size, visible to the proximal entropy operator
    (reference proximal_location_scale_entropy.jl:30)."""

    lr: torch.Tensor


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


def _distance_rule(alpha: float, state_cls, weighted: bool, name: str):
    """DoWG (``weighted``) or DoG: r0 = alpha (1 + ||x0||)."""

    def init_fn(params):
        r0 = alpha * (1.0 + torch.sqrt(tree_global_norm_sq(params)))
        return state_cls(x0=tree_map(torch.clone, params), v=torch.zeros_like(r0), r=r0)

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError(f"{name} requires params")
        dist = torch.sqrt(
            tree_global_norm_sq(tree_map(torch.sub, params, state.x0))
        )
        r = torch.maximum(dist, state.r)
        if weighted:
            r2 = r * r
            v = state.v + r2 * tree_global_norm_sq(grads)
            eta = r2 / torch.sqrt(v)
        else:
            v = state.v + tree_global_norm_sq(grads)
            eta = r / torch.sqrt(v)
        return tree_map(lambda g: -eta * g, grads), state_cls(x0=state.x0, v=v, r=r)

    return GradientTransformation(init_fn, update_fn)


def dowg(alpha: float = 1e-6) -> GradientTransformation:
    """DoWG; ``alpha`` scales the initial distance guess r0 = alpha (1 + ||x0||)."""
    return _distance_rule(alpha, DoWGState, True, "dowg")


def dog(alpha: float = 1e-6) -> GradientTransformation:
    """DoG; ``alpha`` scales the initial distance guess r0 = alpha (1 + ||x0||)."""
    return _distance_rule(alpha, DoGState, False, "dog")


def cocob(alpha: float = 100.0) -> GradientTransformation:
    """COCOB-Backprop, per coordinate: L = max(L, |g|); G += |g|;
    R = max(R + (x - x1)(-g), 0); theta += -g; new x = x1 + theta (L + R) /
    (L max(G + L, alpha L)).  A coordinate that has only seen zero gradients
    (the inert upper triangle of a full-rank scale) keeps x = x1."""

    def init_fn(params):
        return COCOBState(
            L=tree_map(torch.zeros_like, params),
            G=tree_map(torch.zeros_like, params),
            R=tree_map(torch.zeros_like, params),
            theta=tree_map(torch.zeros_like, params),
            x1=tree_map(torch.clone, params),
        )

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("cocob requires params")
        L = tree_map(lambda L, g: torch.maximum(L, torch.abs(g)), state.L, grads)
        G = tree_map(lambda G, g: G + torch.abs(g), state.G, grads)
        R = tree_map(lambda R, x, x1, g: torch.clamp_min(R + (x - x1) * (-g), 0.0),
                     state.R, params, state.x1, grads)
        theta = tree_map(lambda t, g: t + (-g), state.theta, grads)

        def delta(L, G, R, t, x1, x):
            den = L * torch.maximum(G + L, alpha * L)
            bet = torch.where(den > 0, t / torch.where(den > 0, den, torch.ones_like(den)),
                              torch.zeros_like(den))
            return x1 + bet * (L + R) - x

        upd = tree_map(delta, L, G, R, theta, state.x1, params)
        return upd, COCOBState(L=L, G=G, R=R, theta=theta, x1=state.x1)

    return GradientTransformation(init_fn, update_fn)


def descent(lr: float) -> GradientTransformation:
    """Plain SGD whose step size is visible in the state (for the proximal
    operator), in the parameters' dtype."""

    def init_fn(params):
        leaf = tree_leaves(params)[0]
        return DescentState(lr=torch.tensor(lr, dtype=leaf.dtype, device=leaf.device))

    def update_fn(grads, state, params=None):
        return tree_map(lambda g: -state.lr * g, grads), state

    return GradientTransformation(init_fn, update_fn)


def stepsize_from_opt_state(opt_state) -> Optional[torch.Tensor]:
    """The current scalar step size of a descent, DoG or DoWG state (or of
    the first such state in a tuple of states); None for any other rule
    (reference proximal_location_scale_entropy.jl:26-42)."""
    states = opt_state if isinstance(opt_state, tuple) and not hasattr(
        opt_state, "_fields"
    ) else (opt_state,)
    for s in states:
        if isinstance(s, DescentState):
            return s.lr
        if isinstance(s, DoGState):
            return s.r / torch.sqrt(s.v)
        if isinstance(s, DoWGState):
            return (s.r * s.r) / torch.sqrt(s.v)
    return None
