"""Per-datapoint (local-latent) mean-field family and the global-local
product family (port of families/local.py).

``PerDatapointMeanField`` holds N mean-field Gaussian blocks of k local
latents as (N, k) tensors; ``subsample`` gathers the minibatch's rows, so
that a doubly-stochastic step touches only their parameters (the gather's
gradient is a scatter back into the full tensors).  The full ELBO is a sum
of N per-datapoint terms, which a batch of B rows estimates as N/B times
its sum: the family carries that ``weight`` on ``log_prob`` and
``entropy``, so every entropy estimator scales with the likelihood.

A draw is one launch of the mean-field sampler (K7a,
csrc/meanfield_sample.cu) over the flat (n, rows k) width; another base or
dtype draws through ops/base_draws.py.  ``GlobalLocalFamily`` draws its
global block and its local block under two sub-keys of the step's key
(``split_seed_words``), so the two never share a Philox stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..ops.cuda.location_scale_kernels import (
    PhiloxKey,
    as_key,
    meanfield_sample,
    split_seed_words,
)
from .base import Normal
from .location_scale import base_draw


@dataclass(frozen=True)
class PerDatapointMeanField:
    """N independent blocks q_i = N(loc_i, diag(scale_i^2)); draws cover the
    flattened (rows k) space, rows in the order of the (subsampled) data."""

    location: torch.Tensor  # (rows, k)
    scale_diag: torch.Tensor  # (rows, k)
    base: Any = Normal()
    weight: float = 1.0  # N / batch under subsampling

    @property
    def n_rows(self) -> int:
        return self.location.shape[0]

    @property
    def dim(self) -> int:
        return self.location.shape[0] * self.location.shape[1]

    @property
    def base_dim(self) -> int:
        """Width of one injected base draw (``from_base``)."""
        return self.dim

    def subsample(self, indices: torch.Tensor) -> "PerDatapointMeanField":
        return PerDatapointMeanField(
            location=torch.index_select(self.location, 0, indices),
            scale_diag=torch.index_select(self.scale_diag, 0, indices),
            base=self.base,
            weight=self.weight * (self.n_rows / indices.shape[0]),
        )

    def _flat(self):
        return self.location.reshape(-1), self.scale_diag.reshape(-1)

    def sample(self, key, n_samples: int) -> torch.Tensor:
        return self.sample_with_base(key, n_samples)[0]

    def sample_with_base(self, key, n_samples: int):
        """(z, u), both (n, rows k): one K7a launch for a float32 Normal base."""
        loc, sd = self._flat()
        if isinstance(self.base, Normal) and loc.dtype == torch.float32:
            k = as_key(key)
            return meanfield_sample(k.seed, k.it, loc, sd, n_samples)
        u = base_draw(self, key, n_samples, self.dim)
        return self.from_base(u), u

    def from_base(self, u: torch.Tensor) -> torch.Tensor:
        loc, sd = self._flat()
        return u * sd + loc

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        """The weighted density weight * sum_i log q_i (weight 1 for the full
        family)."""
        loc, sd = self._flat()
        u = (z - loc) / sd
        raw = torch.sum(self.base.log_prob(u), dim=-1) - torch.sum(torch.log(torch.abs(sd)))
        return self.weight * raw

    def entropy(self) -> torch.Tensor:
        loc, sd = self._flat()
        raw = loc.shape[0] * self.base.entropy() + torch.sum(torch.log(torch.abs(sd)))
        return self.weight * raw

    def mean(self) -> torch.Tensor:
        return self._flat()[0]

    def var(self) -> torch.Tensor:
        sd = self._flat()[1]
        return self.base.var() * (sd * sd)


def per_datapoint_meanfield(
    n_data: int, k: int = 1, scale: float = 0.1, dtype=torch.float32, device="cuda",
) -> PerDatapointMeanField:
    """A fresh local-latent family: N blocks of k latents each."""
    return PerDatapointMeanField(
        location=torch.zeros((n_data, k), dtype=dtype, device=device),
        scale_diag=scale * torch.ones((n_data, k), dtype=dtype, device=device),
    )


def _part_key(key, i: int) -> PhiloxKey:
    k = as_key(key)
    return PhiloxKey(split_seed_words(k.seed, i), k.it)


@dataclass(frozen=True)
class GlobalLocalFamily:
    """Product family q(theta_g) x prod_i q(z_i) for models with global
    parameters and per-datapoint local latents.  Flat layout: the ``dg``
    global dims, then the local block row-major (rows k).  ``subsample``
    gathers the local rows only; the local density carries the N/B weight,
    the global entropy enters every batch once."""

    global_q: Any
    local_q: PerDatapointMeanField

    @property
    def dim(self) -> int:
        return self.global_q.dim + self.local_q.dim

    @property
    def base_dim(self) -> int:
        """Width of one injected base draw [u_global | u_local]."""
        return self.global_q.base_dim + self.local_q.dim

    @property
    def weight(self) -> float:
        # != 1 only under subsampling; the objectives that are nonlinear in
        # log q (VarGrad, IWELBO) refuse a weighted density
        return self.local_q.weight

    def subsample(self, indices: torch.Tensor) -> "GlobalLocalFamily":
        return GlobalLocalFamily(global_q=self.global_q, local_q=self.local_q.subsample(indices))

    def sample(self, key, n_samples: int) -> torch.Tensor:
        zg = self.global_q.sample(_part_key(key, 0), n_samples)
        zl = self.local_q.sample(_part_key(key, 1), n_samples)
        return torch.cat([zg, zl], dim=-1)

    def sample_with_base(self, key, n_samples: int):
        """(z, [u_global | u_local]): the two blocks under sub-keys 0 and 1."""
        zg, ug = self.global_q.sample_with_base(_part_key(key, 0), n_samples)
        zl, ul = self.local_q.sample_with_base(_part_key(key, 1), n_samples)
        return torch.cat([zg, zl], dim=-1), torch.cat([ug, ul], dim=-1)

    def from_base(self, u: torch.Tensor) -> torch.Tensor:
        gb = self.global_q.base_dim
        return torch.cat([self.global_q.from_base(u[:, :gb]),
                          self.local_q.from_base(u[:, gb:])], dim=-1)

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        dg = self.global_q.dim
        return self.global_q.log_prob(z[..., :dg]) + self.local_q.log_prob(z[..., dg:])

    def entropy(self) -> torch.Tensor:
        return self.global_q.entropy() + self.local_q.entropy()

    def mean(self) -> torch.Tensor:
        return torch.cat([self.global_q.mean(), self.local_q.mean()])

    def var(self) -> torch.Tensor:
        return torch.cat([self.global_q.var(), self.local_q.var()])
