"""Bijective transforms for constrained supports (port of core/transforms.py).

``forward`` maps unconstrained -> constrained; ``forward_and_ldj`` returns
``(constrained, log|det J_forward|)``.  Inputs have shape ``(..., d)`` and the
log-det-Jacobian has the batch shape ``(...)``.  This slice ports Identity,
Exp, Stacked and TransformedTarget; the other transforms of the reference
follow in later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from .problem import order_of


class Transform:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_and_ldj(x)[0]

    def forward_and_ldj(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def unconstrained_dim(self, constrained_dim: int) -> int:
        return constrained_dim


@dataclass(frozen=True)
class Identity(Transform):
    def forward_and_ldj(self, x):
        return x, x.new_zeros(x.shape[:-1])

    def inverse(self, y):
        return y


@dataclass(frozen=True)
class Exp(Transform):
    """Unconstrained -> positive via exp; ldj = sum(x)."""

    def forward_and_ldj(self, x):
        return torch.exp(x), torch.sum(x, dim=-1)

    def inverse(self, y):
        return torch.log(y)


@dataclass(frozen=True)
class Stacked(Transform):
    """Different transforms on contiguous slices of the last dimension."""

    transforms: tuple
    sizes: tuple

    def forward_and_ldj(self, x):
        pieces = []
        ldj = x.new_zeros(x.shape[:-1])
        offset = 0
        for t, n in zip(self.transforms, self.sizes):
            y, l = t.forward_and_ldj(x[..., offset : offset + n])
            pieces.append(y)
            ldj = ldj + l
            offset += n
        return torch.cat(pieces, dim=-1), ldj

    def inverse(self, y):
        pieces = []
        offset = 0
        for t, n in zip(self.transforms, self.sizes):
            pieces.append(t.inverse(y[..., offset : offset + n]))
            offset += n
        return torch.cat(pieces, dim=-1)

    def unconstrained_dim(self, constrained_dim: int) -> int:
        return sum(self.sizes)


def stacked(*pairs: Tuple[Transform, int]) -> Stacked:
    transforms, sizes = zip(*pairs)
    return Stacked(transforms=tuple(transforms), sizes=tuple(sizes))


@dataclass(frozen=True)
class TransformedTarget:
    """Change of variables: ``log_density(x) = prob.log_density(T(x)) + ldj``."""

    prob: Any
    transform: Transform

    @property
    def dim(self) -> int:
        d = getattr(self.prob, "dim")
        d = d() if callable(d) else int(d)
        return self.transform.unconstrained_dim(d)

    def order(self) -> int:
        return order_of(self.prob)

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        theta, ldj = self.transform.forward_and_ldj(x)
        return self.prob.log_density(theta) + ldj

    def subsample(self, indices: torch.Tensor) -> "TransformedTarget":
        """The inner target restricted to ``indices``, same transform."""
        from .problem import subsample

        return TransformedTarget(prob=subsample(self.prob, indices), transform=self.transform)
