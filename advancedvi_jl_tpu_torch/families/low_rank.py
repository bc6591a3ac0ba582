"""Diagonal-plus-low-rank location-scale family (port of families/low_rank.py).

Covariance ``sigma^2_base (D^2 + U U^T)`` with ``D = diag(scale_diag)``
(d,) and factors ``U`` (d, r) (reference: location_scale_low_rank.jl:18-136).
A draw is ``z = u1 * D + u2 U^T + m`` from base draws u1 (n, d) and u2 (n, r):
for a float32 Normal base, on a CUDA tensor one launch of the low-rank
sampler kernel (K7c, csrc/lowrank_sample.cu), on a CPU tensor its plain
PyTorch version.  u1 is the mean-field sampler's draw for the same key, so
with U = 0 the family draws the mean-field z.  Any other base or dtype
draws [u1 | u2] through ops/base_draws.py (JAX low_rank.py:75-76 draws them
with ``jax.random``); ``sampler="pallas"`` refuses it.

``log_prob`` and ``entropy`` take the dense-Cholesky path of Sigma = D^2 +
U U^T for d <= _DENSE_LOGPROB_MAX_DIM, stable when ClipScale drives an entry
of D to its floor while U covers that direction, and the Woodbury form
(matrix determinant lemma) above it.  The family exposes no
``apply_inv_scale_T``: ``RepGradELBO`` takes the general entropy path
(``estimate_entropy`` on ``q_stop.log_prob``), as the JAX package does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..ops.cuda.location_scale_kernels import as_key, lowrank_sample
from .base import Normal
from .location_scale import base_draw, kernel_draws, row_span

# Dense-Cholesky log_prob/entropy up to this dimension (stability), Woodbury
# above it (speed); the JAX package's bound.
_DENSE_LOGPROB_MAX_DIM = 512


@dataclass(frozen=True)
class LowRankLocationScale:
    """Family z = D u1 + U u2 + location with iid base draws u1 (d,), u2 (r,)."""

    location: torch.Tensor  # (d,)
    scale_diag: torch.Tensor  # (d,)
    scale_factors: torch.Tensor  # (d, r)
    base: Any = Normal()
    sampler: str = "xla"

    @property
    def dim(self) -> int:
        return self.location.shape[-1]

    @property
    def rank(self) -> int:
        return self.scale_factors.shape[-1]

    @property
    def base_dim(self) -> int:
        """Width of one injected base draw [u1 | u2] (``from_base``)."""
        return self.dim + self.rank

    def sample(self, key, n_samples: int, rows=None) -> torch.Tensor:
        return self.sample_with_base(key, n_samples, rows)[0]

    def sample_with_base(self, key, n_samples: int, rows=None):
        """(z, [u1 | u2]) for ``key`` (a PhiloxKey, or a seed read as
        iteration 0); ``rows=(row0, count)``: those rows of the
        n_samples-row draw.  On the kernel route u1 is the mean-field
        sampler's draw for the same key."""
        if not kernel_draws(self):
            u = base_draw(self, key, n_samples, self.base_dim, rows)
            return self.from_base(u), u
        k = as_key(key)
        row0, count = row_span(n_samples, rows)
        z, u1, u2 = lowrank_sample(k.seed, k.it, self.location, self.scale_diag,
                                   self.scale_factors, count, row0)
        return z, torch.cat([u1, u2], dim=1)

    def from_base(self, u: torch.Tensor) -> torch.Tensor:
        """z = u1 D + u2 U^T + location for given (n, d + r) draws [u1 | u2]."""
        d = self.dim
        return u[:, :d] * self.scale_diag + u[:, d:] @ self.scale_factors.T + self.location

    def _chol_sigma(self) -> torch.Tensor:
        """Cholesky factor of Sigma = D^2 + U U^T (dense path)."""
        U = self.scale_factors
        sigma = torch.diag(self.scale_diag * self.scale_diag) + U @ U.T
        return torch.linalg.cholesky(sigma)

    def _inner(self) -> torch.Tensor:
        """I + U^T D^-2 U, the Woodbury capacitance matrix (r, r)."""
        D2 = self.scale_diag * self.scale_diag
        U = self.scale_factors
        return torch.eye(self.rank, dtype=D2.dtype, device=D2.device) + U.T @ (U / D2[:, None])

    def _logdet_sigma(self) -> torch.Tensor:
        if self.dim <= _DENSE_LOGPROB_MAX_DIM:
            return 2.0 * torch.sum(torch.log(torch.diagonal(self._chol_sigma())))
        # logdet(D^2 + U U^T) = 2 sum log|D| + logdet(I + U^T D^-2 U)
        _, logdet_inner = torch.linalg.slogdet(self._inner())
        return 2.0 * torch.sum(torch.log(torch.abs(self.scale_diag))) + logdet_inner

    def entropy(self) -> torch.Tensor:
        return self.dim * self.base.entropy() + 0.5 * self._logdet_sigma()

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        """Gaussian-base log density; dense-Cholesky or Woodbury path by
        dimension (module docstring).

        Exact for the Gaussian base (the reference's non-Gaussian low-rank
        logpdf path is only valid for Gaussian bases anyway, since D u1 + U u2
        equals L u in distribution only under rotation invariance)."""
        single = z.ndim == 1
        zb = z[None, :] if single else z
        d = self.dim
        diff = zb - self.mean()
        if d <= _DENSE_LOGPROB_MAX_DIM:
            L = self._chol_sigma()
            v = torch.linalg.solve_triangular(L, diff.T, upper=False)  # (d, n)
            quad = torch.sum(v * v, dim=0)
            logdet_sigma = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
        else:
            D2 = self.scale_diag * self.scale_diag
            dinv2_diff = diff / D2
            w = dinv2_diff @ self.scale_factors  # (n, r)
            sol = torch.cholesky_solve(w.T, torch.linalg.cholesky(self._inner())).T
            quad = torch.sum(diff * dinv2_diff, dim=-1) - torch.sum(w * sol, dim=-1)
            logdet_sigma = self._logdet_sigma()
        out = -0.5 * (quad + logdet_sigma + d * math.log(2.0 * math.pi))
        return out[0] if single else out

    def mean(self) -> torch.Tensor:
        mu_b = self.base.mean()
        if mu_b == 0.0:
            return self.location
        return (self.location + self.scale_diag * mu_b
                + self.scale_factors @ torch.full((self.rank,), mu_b, dtype=self.location.dtype,
                                                  device=self.location.device))

    def var(self) -> torch.Tensor:
        return self.base.var() * (self.scale_diag * self.scale_diag
                                  + torch.sum(self.scale_factors * self.scale_factors, dim=1))

    def cov(self) -> torch.Tensor:
        U = self.scale_factors
        return self.base.var() * (torch.diag(self.scale_diag * self.scale_diag) + U @ U.T)


def LowRankGaussian(
    location: torch.Tensor, scale_diag: torch.Tensor, scale_factors: torch.Tensor
) -> LowRankLocationScale:
    """Gaussian with D + U U^T scale (reference: location_scale_low_rank.jl:124-136)."""
    location = torch.as_tensor(location)
    return LowRankLocationScale(
        location=location,
        scale_diag=torch.as_tensor(scale_diag, device=location.device),
        scale_factors=torch.as_tensor(scale_factors, device=location.device),
        base=Normal(),
    )
