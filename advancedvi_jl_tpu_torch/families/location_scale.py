"""Mean-field location-scale family (port of families/location_scale.py).

The family is a frozen dataclass of tensors: ``location`` and ``scale_diag``
are the parameters the optimizer updates (core/pytree.py maps over them).
Draws go through the step-indexed Philox sampler: on a CUDA tensor
``sample_with_base`` launches the fused kernel (K7a, csrc/meanfield_sample.cu),
on a CPU tensor it runs the kernel's plain PyTorch version.  The full-rank
and low-rank families come in later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..ops.cuda.location_scale_kernels import as_key, meanfield_sample
from .base import Normal


@dataclass(frozen=True)
class MeanFieldLocationScale:
    """Family z = diag(scale) * u + location with iid base draws u ~ base."""

    location: torch.Tensor  # (d,)
    scale_diag: torch.Tensor  # (d,)
    base: Any = Normal()

    @property
    def dim(self) -> int:
        return self.location.shape[-1]

    def sample(self, key, n_samples: int) -> torch.Tensor:
        return self.sample_with_base(key, n_samples)[0]

    def sample_with_base(self, key, n_samples: int):
        """(z, u) for ``key`` (a PhiloxKey, or a seed read as iteration 0)."""
        if not isinstance(self.base, Normal):
            raise ValueError(
                f"the Philox sampler draws the Normal base, got "
                f"{type(self.base).__name__}"
            )
        if self.location.dtype != torch.float32:
            raise ValueError(
                f"the sampler needs float32 parameters, got {self.location.dtype}"
            )
        k = as_key(key)
        return meanfield_sample(
            k.seed, k.it, self.location, self.scale_diag, n_samples
        )

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        u = (z - self.location) / self.scale_diag
        return torch.sum(self.base.log_prob(u), dim=-1) - torch.sum(
            torch.log(torch.abs(self.scale_diag))
        )

    def entropy(self) -> torch.Tensor:
        return self.dim * self.base.entropy() + self.log_det_scale()

    def log_det_scale(self) -> torch.Tensor:
        return torch.sum(torch.log(torch.abs(self.scale_diag)))

    def apply_inv_scale_T(self, V: torch.Tensor) -> torch.Tensor:
        """scale^{-T} applied to each row of (n, d) V (solve-free entropy)."""
        return V / self.scale_diag

    def mean(self) -> torch.Tensor:
        return self.location + self.scale_diag * self.base.mean()

    def var(self) -> torch.Tensor:
        return self.base.var() * self.scale_diag * self.scale_diag

    def cov(self) -> torch.Tensor:
        return torch.diag(self.var())

    def scale_matrix(self) -> torch.Tensor:
        return torch.diag(self.scale_diag)


def MeanFieldGaussian(
    location: torch.Tensor,
    scale_diag: Optional[torch.Tensor] = None,
) -> MeanFieldLocationScale:
    """Gaussian with diagonal covariance (reference: location_scale.jl:124-141)."""
    location = torch.as_tensor(location)
    if scale_diag is None:
        scale_diag = torch.ones_like(location)
    return MeanFieldLocationScale(
        location=location,
        scale_diag=torch.as_tensor(scale_diag, device=location.device),
        base=Normal(),
    )


def is_location_scale(q: Any) -> bool:
    return isinstance(q, MeanFieldLocationScale)
