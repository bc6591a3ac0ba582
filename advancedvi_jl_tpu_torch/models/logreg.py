"""Hierarchical Bayesian logistic regression (port of models/logreg.py).

    sigma ~ LogNormal(0, prior_scale)
    beta  ~ Normal(0_d, sigma^2 I_d)
    y     ~ BernoulliLogit(X beta)

theta = [beta (d), sigma (1)]; ``LogReg(...).unconstrained()`` is the
TransformedTarget with Stacked(Identity_d, Exp_1), as in the reference.
The log-density is batched: ``theta`` of shape ``(..., d + 1)`` gives one
``(..., n) = beta @ X^T`` product for the whole batch of samples.  With
``data_axis``, under a device mesh with that axis, a rank takes its row
block of the data (or of the minibatch) and the blocks' likelihood sums
are summed over the axis (parallel/mesh.py ``data_psum``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

from ..core.problem import ORDER_AUTOGRAD
from ..core.transforms import Exp, Identity, TransformedTarget, stacked
from ..parallel.mesh import data_psum, shard_axis0


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
    data_axis: Optional[str] = None

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
        X, y = shard_axis0(self.X, self.data_axis), shard_axis0(self.y, self.data_axis)
        logits = beta @ X.T
        loglike = data_psum(torch.sum(y * logits - softplus(logits), dim=-1), self.data_axis)
        return self.likeadj * loglike + logprior_beta + logprior_sigma

    def subsample(self, indices: torch.Tensor) -> "LogReg":
        """The minibatch ``indices`` with the likelihood rescaled by
        n / batch (JAX models/logreg.py:78-88)."""
        n = self.X.shape[0]
        return LogReg(
            X=torch.index_select(self.X, 0, indices),
            y=torch.index_select(self.y, 0, indices),
            likeadj=self.likeadj * (n / indices.shape[0]),
            prior_scale=self.prior_scale,
            data_axis=self.data_axis,
        )

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
    data_axis: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> LogReg:
    """Synthetic sonar-like dataset (208 x 60 + intercept, standardized).

    Same shapes and standardisation as the reference's ``make_logreg``; the
    numbers come from a CPU ``torch.Generator`` (an int seeds a new one), so
    a seed gives the same data on every device.  The tensors go to
    ``device``: the card unless the caller asks for the CPU.  ``data_axis``:
    the mesh axis that splits the data rows.
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
        data_axis=data_axis,
    )
