"""Mean-field and full-rank location-scale families (port of
families/location_scale.py).

A family is a frozen dataclass of tensors: ``location`` and ``scale_diag``
(mean-field) or ``scale`` (full-rank, dense (d, d), only its lower triangle
meaningful) are the parameters the optimizer updates (core/pytree.py maps
over them).  Draws go through the step-indexed Philox samplers: on a CUDA
tensor ``sample_with_base`` launches the fused kernel (K7a,
csrc/meanfield_sample.cu; K7b, csrc/fullrank_sample.cu), on a CPU tensor it
runs the kernel's plain PyTorch version.  The low-rank family is
families/low_rank.py.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..ops.cuda.location_scale_kernels import as_key, fullrank_sample, meanfield_sample
from ..ops.cuda.trisolve_kernels import vdiv_c, vdiv_ct
from .base import Normal


def _check_sampler(q) -> None:
    if not isinstance(q.base, Normal):
        raise ValueError(
            f"the Philox sampler draws the Normal base, got {type(q.base).__name__}"
        )
    if q.location.dtype != torch.float32:
        raise ValueError(
            f"the sampler needs float32 parameters, got {q.location.dtype}"
        )


@dataclass(frozen=True)
class MeanFieldLocationScale:
    """Family z = diag(scale) * u + location with iid base draws u ~ base."""

    location: torch.Tensor  # (d,)
    scale_diag: torch.Tensor  # (d,)
    base: Any = Normal()

    @property
    def dim(self) -> int:
        return self.location.shape[-1]

    @property
    def base_dim(self) -> int:
        """Width of one injected base draw (``from_base``)."""
        return self.dim

    def sample(self, key, n_samples: int) -> torch.Tensor:
        return self.sample_with_base(key, n_samples)[0]

    def sample_with_base(self, key, n_samples: int):
        """(z, u) for ``key`` (a PhiloxKey, or a seed read as iteration 0)."""
        _check_sampler(self)
        k = as_key(key)
        return meanfield_sample(
            k.seed, k.it, self.location, self.scale_diag, n_samples
        )

    def from_base(self, u: torch.Tensor) -> torch.Tensor:
        """z = scale u + location for given (n, d) base draws."""
        return u * self.scale_diag + self.location

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


SOLVE_MODES = ("solve", "inverse", "pallas")


@dataclass(frozen=True)
class FullRankLocationScale:
    """Family z = tril(scale) u + location.  ``scale`` is stored dense and
    only its lower triangle is read, so the strict upper triangle is inert
    (zero gradient, hence zero Adam moments).

    ``solve_mode`` picks how C^{-1}/C^{-T} are applied to a batch of rows
    (log_prob whitening, STL entropy backward): ``"solve"`` is
    ``torch.linalg.solve_triangular``, ``"pallas"`` the triangular-solve
    kernel (K8, csrc/trisolve.cu; the name is the JAX package's).  A 1-D
    argument always takes the plain solve."""

    location: torch.Tensor  # (d,)
    scale: torch.Tensor  # (d, d), lower-triangular by convention
    base: Any = Normal()
    solve_mode: str = "solve"

    @property
    def dim(self) -> int:
        return self.location.shape[-1]

    @property
    def base_dim(self) -> int:
        """Width of one injected base draw (``from_base``)."""
        return self.dim

    def tril_scale(self) -> torch.Tensor:
        return torch.tril(self.scale)

    def scale_diag_view(self) -> torch.Tensor:
        return torch.diagonal(self.scale)

    def with_scale_diag(self, new_diag: torch.Tensor) -> "FullRankLocationScale":
        """The family with the scale diagonal replaced exactly by
        ``new_diag``, the off-diagonal kept as stored."""
        return dataclasses.replace(
            self, scale=torch.diagonal_scatter(self.scale, new_diag)
        )

    def sample(self, key, n_samples: int) -> torch.Tensor:
        return self.sample_with_base(key, n_samples)[0]

    def sample_with_base(self, key, n_samples: int):
        """(z, u) for ``key`` (a PhiloxKey, or a seed read as iteration 0);
        u is the mean-field sampler's draw for the same key."""
        _check_sampler(self)
        k = as_key(key)
        return fullrank_sample(k.seed, k.it, self.location, self.scale, n_samples)

    def from_base(self, u: torch.Tensor) -> torch.Tensor:
        """z = u tril(scale)^T + location for given (n, d) base draws."""
        return u @ self.tril_scale().T + self.location

    def _check_solve_mode(self) -> None:
        if self.solve_mode not in SOLVE_MODES:
            raise ValueError(
                f"solve_mode must be one of {SOLVE_MODES}, got {self.solve_mode!r}"
            )
        if self.solve_mode == "inverse":
            raise NotImplementedError(
                "solve_mode='inverse' needs ops/trinv.py, not ported yet "
                "(ROADMAP Queue 1 item 6)"
            )
        if self.solve_mode == "pallas" and self.location.dtype != torch.float32:
            raise ValueError(
                "solve_mode='pallas' requires float32 parameters (the kernel "
                f"is float32), got {self.location.dtype}"
            )

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        self._check_solve_mode()
        C = self.tril_scale()
        diff = z - self.location
        if self.solve_mode == "pallas" and diff.ndim == 2:
            u = vdiv_ct(C, diff)
        else:
            rows = diff.reshape(-1, self.dim)
            u = torch.linalg.solve_triangular(C, rows.T, upper=False).T.reshape(diff.shape)
        return torch.sum(self.base.log_prob(u), dim=-1) - self.log_det_scale()

    def entropy(self) -> torch.Tensor:
        return self.dim * self.base.entropy() + self.log_det_scale()

    def log_det_scale(self) -> torch.Tensor:
        return torch.sum(torch.log(torch.abs(self.scale_diag_view())))

    def apply_inv_scale_T(self, V: torch.Tensor) -> torch.Tensor:
        """C^{-T} applied to each row of (n, d) V: one right division."""
        self._check_solve_mode()
        C = self.tril_scale()
        if self.solve_mode == "pallas" and V.ndim == 2:
            return vdiv_c(C, V)
        rows = V.reshape(-1, self.dim)
        return torch.linalg.solve_triangular(C, rows, upper=False, left=False).reshape(V.shape)

    def mean(self) -> torch.Tensor:
        mu_b = self.base.mean()
        if mu_b == 0.0:
            return self.location
        return self.location + self.tril_scale() @ torch.full_like(self.location, mu_b)

    def var(self) -> torch.Tensor:
        C = self.tril_scale()
        return self.base.var() * torch.sum(C * C, dim=1)

    def cov(self) -> torch.Tensor:
        C = self.tril_scale()
        return self.base.var() * (C @ C.T)

    def scale_matrix(self) -> torch.Tensor:
        return self.tril_scale()


def FullRankGaussian(
    location: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    solve_mode: str = "solve",
    layout: str = "dense",
    compute_dtype: Any = None,
) -> FullRankLocationScale:
    """Gaussian with a dense Cholesky-factor scale (reference:
    location_scale.jl:124-141).  The scale is made lower-triangular here,
    so the stored parameters equal the effective ones."""
    if layout != "dense":
        raise NotImplementedError(
            f"layout={layout!r} needs ops/packing.py, not ported yet "
            "(ROADMAP Queue 1 item 6)"
        )
    if compute_dtype is not None:
        raise NotImplementedError(
            "compute_dtype is not ported: the port's full-rank draw is the "
            "float32 sampler kernel (ROADMAP Queue 1 item 6)"
        )
    location = torch.as_tensor(location)
    if scale is None:
        scale = torch.eye(location.shape[-1], dtype=location.dtype,
                          device=location.device)
    scale = torch.tril(torch.as_tensor(scale, device=location.device))
    q = FullRankLocationScale(location=location, scale=scale, base=Normal(),
                              solve_mode=solve_mode)
    q._check_solve_mode()
    return q


def is_location_scale(q: Any) -> bool:
    from .low_rank import LowRankLocationScale

    return isinstance(q, (MeanFieldLocationScale, FullRankLocationScale, LowRankLocationScale))
