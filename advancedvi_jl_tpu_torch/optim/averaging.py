"""Iterate averaging (port of optim/averaging.py; reference averaging.jl:7-53)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

from ..core.pytree import tree_map


@dataclass(frozen=True)
class NoAveraging:
    """Return the last iterate."""

    def init(self, params) -> Any:
        return params

    def apply(self, state, params) -> Any:
        return params

    def value(self, state) -> Any:
        return state


@dataclass(frozen=True)
class PolynomialAveraging:
    """x_bar <- (1 - w) x_bar + w x,  w = (eta + 1) / (t + eta); t starts at 1
    (Shamir & Zhang 2013)."""

    eta: float = 8.0

    def init(self, params) -> Tuple[Any, int]:
        return (params, 1)

    def apply(self, state, params) -> Tuple[Any, int]:
        x_bar, t = state
        w = (self.eta + 1.0) / (t + self.eta)
        new_bar = tree_map(lambda xb, x: (1.0 - w) * xb + w * x, x_bar, params)
        return (new_bar, t + 1)

    def value(self, state) -> Any:
        return state[0]
