"""Univariate base distributions for location-scale families (port of
families/base.py).

The reference's ``MvLocationScale`` takes any univariate base; Normal,
Student-t and Laplace are documented (reference: docs/src/families.md:74-110).
A base is a small frozen dataclass with an elementwise ``log_prob`` and
``score``, a closed-form ``entropy``, ``mean``, ``var`` and ``symmetric()``.
The float32 Normal draws come from the step-indexed Philox samplers
(ops/cuda/location_scale_kernels.py); every other draw from
ops/base_draws.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
# host-side special functions: the constants depend only on the static df
from scipy.special import betaln, digamma

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

    def symmetric(self) -> bool:
        """True iff -u has the same law as u (antithetic sampling's condition)."""
        return True


@dataclass(frozen=True)
class StudentT:
    """Standard Student-t base (heavy tails); ``df`` is static."""

    df: float = 5.0

    def log_prob(self, u: torch.Tensor) -> torch.Tensor:
        nu = self.df
        lognorm = -0.5 * math.log(nu) - float(betaln(nu / 2.0, 0.5))
        return lognorm - (nu + 1.0) / 2.0 * torch.log1p(u * u / nu)

    def score(self, u: torch.Tensor) -> torch.Tensor:
        nu = self.df
        return -(nu + 1.0) * u / (nu + u * u)

    def entropy(self) -> float:
        nu = self.df
        return float(
            (nu + 1.0) / 2.0 * (digamma((nu + 1.0) / 2.0) - digamma(nu / 2.0))
            + 0.5 * math.log(nu)
            + betaln(nu / 2.0, 0.5)
        )

    def mean(self) -> float:
        return 0.0

    def var(self) -> float:
        return self.df / (self.df - 2.0) if self.df > 2.0 else float("inf")

    def symmetric(self) -> bool:
        return True


@dataclass(frozen=True)
class Laplace:
    """Standard Laplace base."""

    def log_prob(self, u: torch.Tensor) -> torch.Tensor:
        return -torch.abs(u) - math.log(2.0)

    def score(self, u: torch.Tensor) -> torch.Tensor:
        return -torch.sign(u)

    def entropy(self) -> float:
        return 1.0 + math.log(2.0)

    def mean(self) -> float:
        return 0.0

    def var(self) -> float:
        return 2.0

    def symmetric(self) -> bool:
        return True
