"""Hierarchical Bayesian logistic regression (port of models/logreg.py).

    sigma ~ LogNormal(0, prior_scale)
    beta  ~ Normal(0_d, sigma^2 I_d)
    y     ~ BernoulliLogit(X beta)

theta = [beta (d), sigma (1)]; ``LogReg(...).unconstrained()`` is the
TransformedTarget with Stacked(Identity_d, Exp_1), as in the reference.
The log-density is batched: ``theta`` of shape ``(..., d + 1)`` gives one
``(..., n) = beta @ X^T`` product for the whole batch of samples.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

from ..core.problem import ORDER_AUTOGRAD
from ..core.transforms import Exp, Identity, TransformedTarget, stacked


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Stable softplus, the same formula as the reference's jax.nn.softplus."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


@dataclass(frozen=True)
class LogReg:
    """Constrained-space target: theta = [beta, sigma], sigma > 0."""

    X: torch.Tensor  # (n, d)
    y: torch.Tensor  # (n,) in {0, 1}
    likeadj: torch.Tensor  # likelihood rescaling (0-dim)
    prior_scale: float = 3.0

    @property
    def dim(self) -> int:
        return self.X.shape[1] + 1

    def order(self) -> int:
        return ORDER_AUTOGRAD

    def log_density(self, theta: torch.Tensor) -> torch.Tensor:
        d = self.X.shape[1]
        beta, sigma = theta[..., :d], theta[..., d]
        logprior_beta = (
            -0.5 * torch.sum(beta * beta, dim=-1) / (sigma * sigma)
            - d * torch.log(sigma)
            - 0.5 * d * math.log(2.0 * math.pi)
        )
        s = self.prior_scale
        logsig = torch.log(sigma)
        logprior_sigma = (
            -(logsig * logsig) / (2.0 * s * s)
            - logsig
            - math.log(s)
            - 0.5 * math.log(2.0 * math.pi)
        )
        logits = beta @ self.X.T
        loglike = torch.sum(self.y * logits - softplus(logits), dim=-1)
        return self.likeadj * loglike + logprior_beta + logprior_sigma

    def unconstrained(self) -> TransformedTarget:
        """Unconstrained-space target (identity on beta, exp on sigma)."""
        d = self.X.shape[1]
        return TransformedTarget(
            prob=self, transform=stacked((Identity(), d), (Exp(), 1))
        )


def make_logreg(
    generator: Union[int, torch.Generator, None] = None,
    n_data: int = 208,
    n_features: int = 60,
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
) -> LogReg:
    """Synthetic sonar-like dataset (208 x 60 + intercept, standardized).

    Same shapes and standardisation as the reference's ``make_logreg``; the
    numbers come from a CPU ``torch.Generator`` (an int seeds a new one), so
    a seed gives the same data on every device.
    """
    if not isinstance(generator, torch.Generator):
        seed = 0 if generator is None else int(generator)
        generator = torch.Generator().manual_seed(seed)
    X = torch.randn(n_data, n_features, generator=generator, dtype=dtype)
    X = (X - X.mean(dim=0)) / X.std(dim=0, correction=0)
    X = torch.cat([X, torch.ones(n_data, 1, dtype=dtype)], dim=1)
    beta_true = torch.randn(n_features + 1, generator=generator, dtype=dtype)
    logits = X @ beta_true
    y = (
        torch.rand(n_data, generator=generator, dtype=dtype)
        < torch.sigmoid(logits)
    ).to(dtype)
    return LogReg(
        X=X.to(device),
        y=y.to(device),
        likeadj=torch.ones((), dtype=dtype, device=device),
    )
