"""Post-update operators (port of optim/operators.py)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..families.location_scale import MeanFieldLocationScale


@dataclass(frozen=True)
class IdentityOperator:
    """No-op (reference: src/AdvancedVI.jl:197-199)."""

    def apply(self, q, opt_state):
        return q


@dataclass(frozen=True)
class ClipScale:
    """Clamp the scale diagonal to >= epsilon (reference clip_scale.jl:8-41).
    This slice has the mean-field family only."""

    epsilon: float = 1e-5

    def apply(self, q, opt_state):
        if isinstance(q, MeanFieldLocationScale):
            return dataclasses.replace(
                q, scale_diag=torch.clamp_min(q.scale_diag, self.epsilon)
            )
        raise TypeError(f"ClipScale is not defined for family {type(q).__name__}")
