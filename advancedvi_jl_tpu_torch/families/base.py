"""Univariate base distributions for location-scale families (port of
families/base.py).  This slice ports the standard normal; its draws come from
the step-indexed Philox sampler (ops/cuda/location_scale_kernels.py)."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_HALF_LOG_2PI_E = 0.5 * (math.log(2.0 * math.pi) + 1.0)


@dataclass(frozen=True)
class Normal:
    """Standard normal base: z = C u + m gives a Gaussian family."""

    def log_prob(self, u: torch.Tensor) -> torch.Tensor:
        return -0.5 * (u * u) - 0.5 * math.log(2.0 * math.pi)

    def score(self, u: torch.Tensor) -> torch.Tensor:
        """Elementwise d log_prob / du (drives the solve-free STL backward)."""
        return -u

    def entropy(self) -> float:
        return _HALF_LOG_2PI_E

    def mean(self) -> float:
        return 0.0

    def var(self) -> float:
        return 1.0
