"""Analytic Gaussian targets with ground truth (port of models/normal.py).

``NormalTarget`` is N(mu, L L^T) with a batched log-density: ``theta`` of
shape ``(..., d)`` gives ``(...)``.  The constructors draw from a CPU
``torch.Generator`` (an int seeds a new one), so a seed gives the same
target on every device, and put it on ``device`` (the card unless the
caller asks for the CPU); the JAX package's draws come across as numpy
through ``convert.normal_target_from_numpy``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

from ..core.problem import ORDER_AUTOGRAD

SeedOrGenerator = Union[int, torch.Generator, None]


@dataclass(frozen=True)
class NormalTarget:
    """N(mu, L L^T).  ``inv_scale_tril``: optional precomputed L^{-1}, so a
    log-density is one matmul instead of a triangular solve (``solve_free``)."""

    mu: torch.Tensor  # (d,)
    scale_tril: torch.Tensor  # (d, d) lower-triangular Cholesky factor
    inv_scale_tril: Optional[torch.Tensor] = None

    @property
    def dim(self) -> int:
        return self.mu.shape[-1]

    def order(self) -> int:
        return ORDER_AUTOGRAD

    def solve_free(self) -> "NormalTarget":
        """Precompute L^{-1} once so every log_density is matmul-only."""
        eye = torch.eye(self.dim, dtype=self.scale_tril.dtype, device=self.mu.device)
        T = torch.linalg.solve_triangular(self.scale_tril, eye, upper=False)
        return NormalTarget(mu=self.mu, scale_tril=self.scale_tril, inv_scale_tril=T)

    def log_density(self, theta: torch.Tensor) -> torch.Tensor:
        L = self.scale_tril
        diff = theta - self.mu
        if self.inv_scale_tril is not None:
            u = diff @ self.inv_scale_tril.T
        else:
            u = torch.linalg.solve_triangular(L, diff.unsqueeze(-1), upper=False).squeeze(-1)
        return (
            -0.5 * torch.sum(u * u, dim=-1)
            - torch.sum(torch.log(torch.abs(torch.diagonal(L))))
            - 0.5 * self.dim * math.log(2.0 * math.pi)
        )


def _generator(seed: SeedOrGenerator) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(0 if seed is None else int(seed))


def _target(mu, L, device):
    mu, L = mu.to(device), L.to(device)
    return NormalTarget(mu=mu, scale_tril=L), mu, L


def normal_fullrank(seed: SeedOrGenerator = None, n_dims: int = 5,
                    dtype=torch.float32, device="cuda"):
    """Correlated Gaussian target (reference: test/models/normal.jl fullrank);
    returns (target, mu_true, scale_tril_true)."""
    g = _generator(seed)
    mu = torch.randn(n_dims, generator=g, dtype=dtype)
    A = 0.3 * torch.randn(n_dims, n_dims, generator=g, dtype=dtype)
    L = torch.tril(A, -1) + torch.diag(1.0 + 0.5 * torch.abs(torch.diagonal(A)))
    return _target(mu, L, device)


def normal_fullrank_wellcond(seed: SeedOrGenerator = None, n_dims: int = 5,
                             dtype=torch.float32, device="cuda"):
    """Correlated Gaussian that stays well-conditioned at large d: the
    off-diagonal is scaled by 1/sqrt(d) (unit-norm rows in expectation)."""
    g = _generator(seed)
    mu = torch.randn(n_dims, generator=g, dtype=dtype)
    A = torch.randn(n_dims, n_dims, generator=g, dtype=dtype) * (0.3 / n_dims**0.5)
    L = torch.tril(A, -1) + torch.eye(n_dims, dtype=dtype)
    return _target(mu, L, device)


def normal_meanfield(seed: SeedOrGenerator = None, n_dims: int = 5,
                     dtype=torch.float32, device="cuda"):
    """Diagonal Gaussian target (reference: test/models/normal.jl meanfield)."""
    g = _generator(seed)
    mu = torch.randn(n_dims, generator=g, dtype=dtype)
    sigma = 0.5 + torch.rand(n_dims, generator=g, dtype=dtype)
    return _target(mu, torch.diag(sigma), device)
