"""Post-update operators (port of optim/operators.py)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..families.blockdiag import BlockDiagLocationScale
from ..families.local import GlobalLocalFamily, PerDatapointMeanField
from ..families.location_scale import FullRankLocationScale, MeanFieldLocationScale
from ..families.low_rank import LowRankLocationScale
from ..families.mixture import MixtureFullRank, MixtureMeanField
from .rules import stepsize_from_opt_state


@dataclass(frozen=True)
class IdentityOperator:
    """No-op (reference: src/AdvancedVI.jl:197-199)."""

    def apply(self, q, opt_state):
        return q


def _with_block_diagonals(q, fn):
    """q with each (K | B, k, k) block's diagonal moved to fn(diagonal) by a
    delta * eye add, the rest of the blocks as stored."""
    diag = torch.diagonal(q.scales, dim1=-2, dim2=-1)
    delta = fn(diag) - diag
    eye = torch.eye(diag.shape[-1], dtype=q.scales.dtype, device=q.scales.device)
    return dataclasses.replace(q, scales=q.scales + delta[:, :, None] * eye)


@dataclass(frozen=True)
class ClipScale:
    """Clamp the scale diagonal to >= epsilon (reference clip_scale.jl:8-41):
    mean-field, per-datapoint and low-rank ``scale_diag``, the mixtures'
    ``scale_diags``, the full-rank diagonal through ``with_scale_diag``
    (clamped entries are exactly epsilon; the off-diagonal, the inert upper
    triangle included, is kept as stored), and each block's diagonal of the
    full-rank mixture and the block-diagonal family; a ``GlobalLocalFamily``
    clips both parts."""

    epsilon: float = 1e-5

    def apply(self, q, opt_state):
        eps = self.epsilon
        if isinstance(q, GlobalLocalFamily):
            return dataclasses.replace(q, global_q=self.apply(q.global_q, opt_state),
                                       local_q=self.apply(q.local_q, opt_state))
        if isinstance(q, (MeanFieldLocationScale, LowRankLocationScale, PerDatapointMeanField)):
            return dataclasses.replace(q, scale_diag=torch.clamp_min(q.scale_diag, eps))
        if isinstance(q, FullRankLocationScale):
            return q.with_scale_diag(torch.clamp_min(q.scale_diag_view(), eps))
        if isinstance(q, MixtureMeanField):
            return dataclasses.replace(q, scale_diags=torch.clamp_min(q.scale_diags, eps))
        if isinstance(q, (MixtureFullRank, BlockDiagLocationScale)):
            return _with_block_diagonals(q, lambda diag: torch.clamp_min(diag, eps))
        raise TypeError(f"ClipScale is not defined for family {type(q).__name__}")


@dataclass(frozen=True)
class ProximalLocationScaleEntropy:
    """Closed-form proximal step for the entropy of a location-scale family
    (reference proximal_location_scale_entropy.jl:20-61): on the scale
    diagonal, sigma' = sigma / 2 + sqrt(sigma^2 + 4 gamma) / 2, with gamma
    the step size the optimizer state holds (descent, DoG, DoWG only).
    Mean-field and per-datapoint: ``scale_diag``; full-rank: the diagonal
    only, through ``with_scale_diag``; block-diagonal: each block's
    diagonal."""

    def apply(self, q, opt_state):
        gamma = stepsize_from_opt_state(opt_state)
        if gamma is None:
            raise ValueError(
                "ProximalLocationScaleEntropy requires an optimizer whose "
                "step size is extractable from its state: descent, dog, dowg."
            )

        def prox(sigma):
            return sigma / 2.0 + torch.sqrt(sigma * sigma + 4.0 * gamma) / 2.0

        if isinstance(q, (MeanFieldLocationScale, PerDatapointMeanField)):
            return dataclasses.replace(q, scale_diag=prox(q.scale_diag))
        if isinstance(q, FullRankLocationScale):
            return q.with_scale_diag(prox(q.scale_diag_view()))
        if isinstance(q, BlockDiagLocationScale):
            return _with_block_diagonals(q, prox)
        # The low-rank family is refused, as in the reference
        # (proximal_location_scale_entropy.jl:23): its entropy couples D to U
        # through the determinant lemma, so the diagonal closed form is inexact.
        raise TypeError(
            "ProximalLocationScaleEntropy only supports location-scale "
            f"families, got {type(q).__name__}"
        )
