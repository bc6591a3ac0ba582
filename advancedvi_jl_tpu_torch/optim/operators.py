"""Post-update operators (port of optim/operators.py)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..families.location_scale import FullRankLocationScale, MeanFieldLocationScale
from ..families.low_rank import LowRankLocationScale
from .rules import stepsize_from_opt_state


@dataclass(frozen=True)
class IdentityOperator:
    """No-op (reference: src/AdvancedVI.jl:197-199)."""

    def apply(self, q, opt_state):
        return q


@dataclass(frozen=True)
class ClipScale:
    """Clamp the scale diagonal to >= epsilon (reference clip_scale.jl:8-41):
    mean-field and low-rank ``scale_diag``, or the full-rank diagonal
    through ``with_scale_diag`` (clamped entries are exactly epsilon; the
    off-diagonal, the inert upper triangle included, is kept as stored)."""

    epsilon: float = 1e-5

    def apply(self, q, opt_state):
        if isinstance(q, (MeanFieldLocationScale, LowRankLocationScale)):
            return dataclasses.replace(
                q, scale_diag=torch.clamp_min(q.scale_diag, self.epsilon)
            )
        if isinstance(q, FullRankLocationScale):
            return q.with_scale_diag(torch.clamp_min(q.scale_diag_view(), self.epsilon))
        raise TypeError(f"ClipScale is not defined for family {type(q).__name__}")


@dataclass(frozen=True)
class ProximalLocationScaleEntropy:
    """Closed-form proximal step for the entropy of a location-scale family
    (reference proximal_location_scale_entropy.jl:20-61): on the scale
    diagonal, sigma' = sigma / 2 + sqrt(sigma^2 + 4 gamma) / 2, with gamma
    the step size the optimizer state holds (descent, DoG, DoWG only).
    Mean-field: ``scale_diag``; full-rank: the diagonal only, through
    ``with_scale_diag``."""

    def apply(self, q, opt_state):
        gamma = stepsize_from_opt_state(opt_state)
        if gamma is None:
            raise ValueError(
                "ProximalLocationScaleEntropy requires an optimizer whose "
                "step size is extractable from its state: descent, dog, dowg."
            )

        def prox(sigma):
            return sigma / 2.0 + torch.sqrt(sigma * sigma + 4.0 * gamma) / 2.0

        if isinstance(q, MeanFieldLocationScale):
            return dataclasses.replace(q, scale_diag=prox(q.scale_diag))
        if isinstance(q, FullRankLocationScale):
            return q.with_scale_diag(prox(q.scale_diag_view()))
        # The low-rank family is refused, as in the reference
        # (proximal_location_scale_entropy.jl:23): its entropy couples D to U
        # through the determinant lemma, so the diagonal closed form is inexact.
        raise TypeError(
            "ProximalLocationScaleEntropy only supports location-scale "
            f"families, got {type(q).__name__}"
        )
