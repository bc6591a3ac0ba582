"""Post-update operators (port of optim/operators.py)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..families.location_scale import FullRankLocationScale, MeanFieldLocationScale


@dataclass(frozen=True)
class IdentityOperator:
    """No-op (reference: src/AdvancedVI.jl:197-199)."""

    def apply(self, q, opt_state):
        return q


@dataclass(frozen=True)
class ClipScale:
    """Clamp the scale diagonal to >= epsilon (reference clip_scale.jl:8-41):
    mean-field ``scale_diag``, or the full-rank diagonal through
    ``with_scale_diag`` (clamped entries are exactly epsilon; the
    off-diagonal, the inert upper triangle included, is kept as stored)."""

    epsilon: float = 1e-5

    def apply(self, q, opt_state):
        if isinstance(q, MeanFieldLocationScale):
            return dataclasses.replace(
                q, scale_diag=torch.clamp_min(q.scale_diag, self.epsilon)
            )
        if isinstance(q, FullRankLocationScale):
            return q.with_scale_diag(torch.clamp_min(q.scale_diag_view(), self.epsilon))
        raise TypeError(f"ClipScale is not defined for family {type(q).__name__}")
