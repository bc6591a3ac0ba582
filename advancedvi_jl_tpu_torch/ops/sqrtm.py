"""Symmetric matrix square roots for the measure-space updates (port of
ops/sqrtm.py).

- ``sqrtm_psd`` / ``inv_sqrtm_psd``: one symmetric eigendecomposition
  (``torch.linalg.eigh``, cuSOLVER on the card), eigenvalues clamped;
- ``sqrtm_newton_schulz``: the Newton-Schulz iteration, (d, d) products
  only.  Its Frobenius-norm prescale stays a device tensor, so the
  iteration never waits on the host.
"""

from __future__ import annotations

import torch


def _symmetrize(A: torch.Tensor) -> torch.Tensor:
    return (A + A.T) / 2.0


def sqrtm_psd(A: torch.Tensor) -> torch.Tensor:
    """Principal square root of a symmetric PSD matrix via eigh."""
    w, V = torch.linalg.eigh(_symmetrize(A))
    w = torch.clamp_min(w, 0.0)
    return (V * torch.sqrt(w)) @ V.T


def inv_sqrtm_psd(A: torch.Tensor, eps: float = 1e-12):
    """(A^{1/2}, A^{-1/2}) for symmetric positive definite A."""
    w, V = torch.linalg.eigh(_symmetrize(A))
    sw = torch.sqrt(torch.clamp_min(w, eps))
    return (V * sw) @ V.T, (V / sw) @ V.T


def sqrtm_newton_schulz(A: torch.Tensor, n_iter: int = 20) -> torch.Tensor:
    """Newton-Schulz iteration for the PSD square root (products only),
    prescaled by the Frobenius norm: it converges quadratically once
    ||I - A / ||A||_F|| < 1."""
    d = A.shape[-1]
    norm = torch.sqrt(torch.sum(A * A))
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    Y, Z = A / norm, eye
    for _ in range(n_iter):
        T = 0.5 * (3.0 * eye - Z @ Y)
        Y, Z = Y @ T, T @ Z
    return Y * torch.sqrt(norm)
