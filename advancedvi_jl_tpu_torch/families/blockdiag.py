"""Block-diagonal full-rank Gaussian family (port of families/blockdiag.py).

B independent blocks of size k, each with its own dense Cholesky factor:
full within-block covariance at O(B k^2) parameters, between the
mean-field and full-rank families.  A draw is u from the mean-field sampler
(K7a, csrc/meanfield_sample.cu) at zero location and unit scale over the
flat (n, B k) width, then one batched product z = einsum("bij,nbj->nbi",
tril(C), u) + m, as the JAX package forms it outside Pallas; another base
or dtype draws u through ops/base_draws.py.  ``log_prob`` is one batched
triangular solve over the blocks.

``block_axis`` (the blocks over a device mesh's axis, as experts): the
draw stays whole, each rank forms its blocks' part of z with its blocks'
factors alone, and ``gather_share`` copies the parts into the whole z;
``log_prob`` and the entropy read every block's replicated factor.

The family has no ``apply_inv_scale_T``, so ``RepGradELBO`` takes the
general entropy path (``estimate_entropy`` on ``q_stop``), as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..parallel.mesh import gather_share, rows_of
from .base import Normal
from .location_scale import standard_draw


@dataclass(frozen=True)
class BlockDiagLocationScale:
    """q = N(location, blockdiag(C_1 C_1^T, ..., C_B C_B^T)).

    ``location`` is flat (B k,): block b owns coordinates [b k, (b + 1) k).
    ``scales`` holds dense (B, k, k) blocks read as their lower triangles
    (the strict upper entries are inert, as in the full-rank family).
    ``block_axis``: the blocks over a device mesh's axis."""

    location: torch.Tensor  # (B*k,)
    scales: torch.Tensor  # (B, k, k), lower-triangular by convention
    base: Any = Normal()
    block_axis: Optional[str] = None

    @property
    def n_blocks(self) -> int:
        return self.scales.shape[0]

    @property
    def block_dim(self) -> int:
        return self.scales.shape[-1]

    @property
    def dim(self) -> int:
        return self.location.shape[-1]

    @property
    def base_dim(self) -> int:
        """Width of one injected base draw (``from_base``)."""
        return self.dim

    def tril_scales(self) -> torch.Tensor:
        return torch.tril(self.scales)

    def sample(self, key, n_samples: int) -> torch.Tensor:
        return self.sample_with_base(key, n_samples)[0]

    def sample_with_base(self, key, n_samples: int):
        """(z, u) for ``key``, both (n, B k)."""
        u = standard_draw(self.base, key, n_samples, self.dim, self.location.dtype,
                          self.location.device)
        return self.from_base(u), u

    def from_base(self, u: torch.Tensor) -> torch.Tensor:
        """z = blockdiag(tril C) u + location for given (n, B k) draws; under
        ``block_axis`` this rank's blocks, gathered."""
        n, B, k = u.shape[0], self.n_blocks, self.block_dim
        mine = rows_of(B, self.block_axis)
        b0, nb = (0, B) if mine is None else mine
        C = torch.tril(self.scales[b0:b0 + nb])
        z = torch.einsum("bij,nbj->nbi", C, u.reshape(n, B, k)[:, b0:b0 + nb])
        z = z + self.location.reshape(B, k)[b0:b0 + nb]
        return gather_share(z, B, self.block_axis, dim=1).reshape(n, B * k)

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        B, k = self.n_blocks, self.block_dim
        squeeze = z.ndim == 1
        if squeeze:
            z = z[None, :]
        C = self.tril_scales()
        diff = (z - self.location).reshape(z.shape[0], B, k)
        # (B, k, k) \ (B, k, n): one batched solve over the blocks
        u = torch.linalg.solve_triangular(C, diff.permute(1, 2, 0), upper=False)
        logdet = torch.sum(torch.log(torch.abs(torch.diagonal(C, dim1=-2, dim2=-1))))
        out = torch.sum(self.base.log_prob(u), dim=(0, 1)) - logdet
        return out[0] if squeeze else out

    def entropy(self) -> torch.Tensor:
        logdet = torch.sum(torch.log(torch.abs(torch.diagonal(self.scales, dim1=-2, dim2=-1))))
        return self.dim * self.base.entropy() + logdet

    def mean(self) -> torch.Tensor:
        return self.location  # symmetric zero-mean bases

    def var(self) -> torch.Tensor:
        C = self.tril_scales()
        return self.base.var() * torch.sum(C * C, dim=-1).reshape(-1)

    def cov(self) -> torch.Tensor:
        """Dense (B k, B k) block-diagonal covariance (diagnostics only)."""
        C = self.tril_scales()
        blocks = self.base.var() * torch.einsum("bij,bkj->bik", C, C)
        return torch.block_diag(*blocks)

    def scale_matrix(self) -> torch.Tensor:
        return torch.block_diag(*self.tril_scales())


def BlockDiagGaussian(
    location: torch.Tensor,
    scales: Optional[torch.Tensor] = None,
    n_blocks: Optional[int] = None,
) -> BlockDiagLocationScale:
    """Gaussian with block-diagonal covariance: explicit ``scales`` (B, k,
    k), or ``n_blocks`` identity blocks (the location's length must divide
    evenly)."""
    location = torch.as_tensor(location)
    if scales is None:
        if n_blocks is None:
            raise ValueError("pass scales=(B, k, k) or n_blocks=")
        d = location.shape[-1]
        if d % n_blocks:
            raise ValueError(f"dim {d} is not divisible into {n_blocks} equal blocks")
        k = d // n_blocks
        scales = torch.eye(k, dtype=location.dtype, device=location.device).expand(
            n_blocks, k, k)
    scales = torch.tril(torch.as_tensor(scales, device=location.device))
    if scales.shape[0] * scales.shape[-1] != location.shape[-1]:
        raise ValueError(
            f"scales {tuple(scales.shape)} cover dim {scales.shape[0] * scales.shape[-1]} "
            f"!= location dim {location.shape[-1]}"
        )
    return BlockDiagLocationScale(location=location, scales=scales)
