"""Subsampled-normals target with an analytic posterior (port of
models/subsampled_normals.py; reference test/models/subsamplednormals.jl).

A 1-dimensional product of n unit-scale Normal factors N(mu_i, 1) in x,
whose normalized density is N(mean(mu), 1/n).  ``subsample`` keeps a
minibatch of factors and rescales by n / batch.  The log-density is batched:
``x`` of shape ``(..., 1)`` gives ``(...)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.problem import ORDER_AUTOGRAD
from .normal import SeedOrGenerator, _generator

_HALF_L2PI = 0.5 * math.log(2.0 * math.pi)


@dataclass(frozen=True)
class SubsampledNormals:
    mus: torch.Tensor  # (n,)
    likeadj: torch.Tensor  # 0-dim

    @property
    def dim(self) -> int:
        return 1

    def order(self) -> int:
        return ORDER_AUTOGRAD

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        lps = -0.5 * torch.square(x[..., :1] - self.mus) - _HALF_L2PI
        return self.likeadj * torch.sum(lps, dim=-1)

    def subsample(self, indices: torch.Tensor) -> "SubsampledNormals":
        n = self.mus.shape[0]
        return SubsampledNormals(mus=torch.index_select(self.mus, 0, indices),
                                 likeadj=self.likeadj * (n / indices.shape[0]))


def subsampled_normals(seed: SeedOrGenerator = None, n_data: int = 8,
                       dtype=torch.float32, device="cuda"):
    """Returns (target, mu_true (1,), scale_true (1, 1)); the factors' means
    are drawn from a CPU ``torch.Generator`` and put on ``device`` (the
    card unless the caller asks for the CPU)."""
    mus = torch.randn(n_data, generator=_generator(seed), dtype=dtype).to(device)
    target = SubsampledNormals(mus=mus, likeadj=torch.ones((), dtype=dtype, device=device))
    mu_true = torch.mean(mus)[None]
    scale_true = torch.full((1, 1), 1.0 / math.sqrt(n_data), dtype=dtype, device=device)
    return target, mu_true, scale_true
