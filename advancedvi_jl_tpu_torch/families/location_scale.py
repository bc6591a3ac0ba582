"""Mean-field and full-rank location-scale families (port of
families/location_scale.py).

A family is a frozen dataclass of tensors: ``location`` and ``scale_diag``
(mean-field) or ``scale`` (full-rank) are the parameters the optimizer
updates (core/pytree.py maps over them); ``base``, ``sampler``,
``solve_mode`` and ``layout`` are static.

Draws: a float32 family on the Normal base goes through the step-indexed
Philox samplers whatever ``sampler`` says: on a CUDA tensor
``sample_with_base`` launches the fused kernel (K7a,
csrc/meanfield_sample.cu; K7b, csrc/fullrank_sample.cu), on a CPU tensor it
runs the kernel's plain PyTorch version.  Every other family (a Student-t or
Laplace base, or float64) draws its base through ops/base_draws.py, as the
JAX package draws those with ``jax.random``; ``sampler="pallas"`` refuses
them with the JAX package's message.  There is no fallback between the two
routes.  ``rows=(row0, count)`` draws rows [row0, row0 + count) of the
n-row draw: the kernels at a row offset, so one rank of a device mesh's
"mc" axis draws its rows alone; the ops/base_draws.py route draws the whole
block (a torch generator cannot start at a row) and keeps the rows.

The full-rank ``scale`` is dense (d, d), only its lower triangle read, or
with ``layout="packed"`` the tile-packed triangle of ops/packing.py; the
dense factor is made where a product or a solve reads it.  ``tp_axis``
(the factor's rows over a device mesh's axis): each rank forms its share
of z's columns, the columns of its rows of C (K7b over a column range, or
the plain product of those rows for injected draws), and ``gather_share``
copies the shares into the whole z; the densities, the entropy and the
solves read the replicated factor.  ``compute_dtype="bfloat16"``: the
sampling product rounds u and C to bfloat16 and sums in the parameters'
dtype (csrc/fullrank_bf16.cu on the card, after K7b's draw launch on the
kernel route); u, the densities, the entropy and the solves stay in the
parameters' dtype.  Under ``sampler="pallas"`` the product is K7b's float32
one, as the JAX package's Pallas sampler ignores ``compute_dtype``.  The
low-rank family is families/low_rank.py.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..ops import base_draws
from ..ops.cuda.location_scale_kernels import (
    as_key, fullrank_affine_reference, fullrank_bf16, fullrank_draw, fullrank_sample,
    meanfield_sample,
)
from ..ops.cuda.trisolve_kernels import vdiv_c, vdiv_ct
from ..ops.packing import packed_diag, packed_with_diag, tril_pack, tril_unpack
from ..ops.trinv import tril_inverse
from ..parallel.mesh import gather_share, rows_of
from .base import Normal


def take_rows(x: torch.Tensor, rows) -> torch.Tensor:
    """Rows [row0, row0 + count) of ``x`` for ``rows=(row0, count)``; ``x``
    for None."""
    return x if rows is None else x.narrow(0, rows[0], rows[1])


def row_span(n: int, rows) -> Tuple[int, int]:
    """(row0, count) of ``rows``, or the whole n-row draw for None."""
    return (0, n) if rows is None else (int(rows[0]), int(rows[1]))


def check_compute_dtype(compute_dtype) -> None:
    """Accept None or bfloat16 (the name or the torch dtype): the operand
    type of a family's sampling product or a model's forward products."""
    if compute_dtype is not None and compute_dtype not in ("bfloat16", torch.bfloat16):
        raise ValueError(
            "compute_dtype must be None or 'bfloat16' (the products round their operands "
            f"to bfloat16 and sum in float32), got {compute_dtype!r}"
        )


def _check_pallas_ok(q) -> None:
    """The JAX package's ``_check_pallas_ok``: the sampler kernel draws the
    Normal base in float32 only."""
    if not isinstance(q.base, Normal):
        raise ValueError(
            "sampler='pallas' requires the Normal base (Box-Muller kernel); "
            f"got {type(q.base).__name__}"
        )
    if q.location.dtype != torch.float32:
        raise ValueError(
            f"sampler='pallas' requires float32 parameters, got "
            f"{q.location.dtype}"
        )


def kernel_draws(q) -> bool:
    """Whether the family's draws come from the Philox sampler kernels (a
    float32 Normal base) rather than ops/base_draws.py.  ``sampler="pallas"``
    on any other family raises."""
    if q.sampler == "pallas":
        _check_pallas_ok(q)
    return isinstance(q.base, Normal) and q.location.dtype == torch.float32


def base_draw(q, key, n_samples: int, width: int, rows=None) -> torch.Tensor:
    """(n_samples, width) base draws of a family the kernels do not draw
    (``rows`` of them with ``rows``)."""
    return base_draws.draw(q.base, key, n_samples, width, q.location.dtype, q.location.device,
                           rows)


def standard_draw(base, key, n_samples: int, width: int, dtype: torch.dtype,
                  device) -> torch.Tensor:
    """(n_samples, width) iid draws of ``base`` for ``key``: the float32
    Normal base from the mean-field sampler (K7a) at zero location and unit
    scale, whose z is its u; any other base or dtype from
    ops/base_draws.py (the block-diagonal family's and the full-rank
    mixture's draw, whose product follows)."""
    if isinstance(base, Normal) and dtype == torch.float32:
        k = as_key(key)
        zero = torch.zeros(width, dtype=dtype, device=device)
        one = torch.ones(width, dtype=dtype, device=device)
        return meanfield_sample(k.seed, k.it, zero, one, n_samples)[1]
    return base_draws.draw(base, key, n_samples, width, dtype, device)


@dataclass(frozen=True)
class MeanFieldLocationScale:
    """Family z = diag(scale) * u + location with iid base draws u ~ base."""

    location: torch.Tensor  # (d,)
    scale_diag: torch.Tensor  # (d,)
    base: Any = Normal()
    sampler: str = "xla"

    @property
    def dim(self) -> int:
        return self.location.shape[-1]

    @property
    def base_dim(self) -> int:
        """Width of one injected base draw (``from_base``)."""
        return self.dim

    def sample(self, key, n_samples: int, rows=None) -> torch.Tensor:
        return self.sample_with_base(key, n_samples, rows)[0]

    def sample_with_base(self, key, n_samples: int, rows=None):
        """(z, u) for ``key`` (a PhiloxKey, or a seed read as iteration 0);
        ``rows=(row0, count)``: those rows of the n_samples-row draw."""
        if kernel_draws(self):
            k = as_key(key)
            row0, count = row_span(n_samples, rows)
            return meanfield_sample(k.seed, k.it, self.location, self.scale_diag, count, row0)
        u = base_draw(self, key, n_samples, self.dim, rows)
        return self.from_base(u), u

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
    sampler: str = "xla",
) -> MeanFieldLocationScale:
    """Gaussian with diagonal covariance (reference: location_scale.jl:124-141).
    ``sampler`` is the JAX package's argument; a float32 family draws
    through the Philox sampler kernel either way."""
    location = torch.as_tensor(location)
    if scale_diag is None:
        scale_diag = torch.ones_like(location)
    return MeanFieldLocationScale(
        location=location,
        scale_diag=torch.as_tensor(scale_diag, device=location.device),
        base=Normal(),
        sampler=sampler,
    )


SOLVE_MODES = ("solve", "inverse", "pallas")
LAYOUTS = ("dense", "packed")


@dataclass(frozen=True)
class FullRankLocationScale:
    """Family z = tril(scale) u + location.  A dense ``scale`` has only its
    lower triangle read, so the strict upper triangle is inert (zero
    gradient, hence zero Adam moments); a packed one holds the triangle's
    tiles (ops/packing.py).

    ``solve_mode`` picks how C^{-1}/C^{-T} are applied to a batch of rows
    (log_prob whitening, STL entropy backward): ``"solve"`` is
    ``torch.linalg.solve_triangular``, ``"inverse"`` a product with the
    level-parallel inverse (ops/trinv.py), ``"pallas"`` the triangular-solve
    kernel (K8, csrc/trisolve.cu; the name is the JAX package's).  A 1-D
    argument takes the plain solve under ``"pallas"``."""

    location: torch.Tensor  # (d,)
    scale: torch.Tensor  # (d, d) lower-triangular by convention, or packed tiles
    base: Any = Normal()
    sampler: str = "xla"
    tp_axis: Optional[str] = None
    compute_dtype: Any = None
    solve_mode: str = "solve"
    layout: str = "dense"

    def __post_init__(self) -> None:
        check_compute_dtype(self.compute_dtype)
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"layout must be 'dense' or 'packed', got {self.layout!r}"
            )
        if self.solve_mode not in SOLVE_MODES:
            raise ValueError(
                f"solve_mode must be one of {SOLVE_MODES}, got {self.solve_mode!r}"
            )
        if self.solve_mode == "pallas" and self.location.dtype != torch.float32:
            raise ValueError(
                "solve_mode='pallas' requires float32 parameters (the kernel "
                f"is float32), got {self.location.dtype}"
            )

    @property
    def dim(self) -> int:
        return self.location.shape[-1]

    @property
    def base_dim(self) -> int:
        """Width of one injected base draw (``from_base``)."""
        return self.dim

    def tril_scale(self) -> torch.Tensor:
        if self.layout == "packed":
            if self.tp_axis is not None:
                raise ValueError(
                    "layout='packed' cannot row-shard the scale; use "
                    "layout='dense' with tp_axis"
                )
            return tril_unpack(self.scale, self.dim)
        return torch.tril(self.scale)

    def _factor(self) -> torch.Tensor:
        """The factor a sampling product reads: the dense scale as stored (its
        lower triangle read), a packed one unpacked (contiguous: where d is
        not a whole number of tiles the unpacked grid's corner is a view)."""
        return self.scale if self.layout == "dense" else self.tril_scale().contiguous()

    def scale_diag_view(self) -> torch.Tensor:
        """Diagonal of the effective scale, whatever the layout."""
        if self.layout == "packed":
            return packed_diag(self.scale, self.dim)
        return torch.diagonal(self.scale)

    def with_scale_diag(self, new_diag: torch.Tensor) -> "FullRankLocationScale":
        """The family with the scale diagonal replaced exactly by
        ``new_diag``, the off-diagonal kept as stored (either layout)."""
        if self.layout == "packed":
            return dataclasses.replace(
                self, scale=packed_with_diag(self.scale, self.dim, new_diag))
        return dataclasses.replace(
            self, scale=torch.diagonal_scatter(self.scale, new_diag)
        )

    def sample(self, key, n_samples: int, rows=None) -> torch.Tensor:
        return self.sample_with_base(key, n_samples, rows)[0]

    def sample_with_base(self, key, n_samples: int, rows=None):
        """(z, u) for ``key`` (a PhiloxKey, or a seed read as iteration 0);
        ``rows=(row0, count)``: those rows of the n_samples-row draw.  On
        the kernel route u is the mean-field sampler's draw for the same
        key: K7b forms z (over this rank's columns under ``tp_axis``), or,
        with ``compute_dtype``, draws u alone for the bfloat16 product."""
        if kernel_draws(self):
            k = as_key(key)
            row0, count = row_span(n_samples, rows)
            cols = rows_of(self.dim, self.tp_axis)
            if self.compute_dtype is not None and self.sampler != "pallas":
                u = fullrank_draw(k.seed, k.it, self.location, count, row0)
                z = fullrank_bf16(u, self.location, self._factor(), cols)
            else:
                z, u = fullrank_sample(k.seed, k.it, self.location, self._factor(), count,
                                       row0, cols)
            return gather_share(z, self.dim, self.tp_axis, dim=1), u
        u = base_draw(self, key, n_samples, self.dim, rows)
        return self.from_base(u), u

    def from_base(self, u: torch.Tensor) -> torch.Tensor:
        """z = u tril(scale)^T + location for given (n, d) base draws (with
        ``compute_dtype``, the bfloat16 product); under ``tp_axis`` this
        rank's columns, gathered."""
        cols = rows_of(self.dim, self.tp_axis)
        if self.compute_dtype is not None:
            z = fullrank_bf16(u, self.location, self._factor(), cols)
        else:
            z = fullrank_affine_reference(u, self.location, self._factor(), cols)
        return gather_share(z, self.dim, self.tp_axis, dim=1)

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        C = self.tril_scale()
        diff = z - self.location
        if self.solve_mode == "inverse":
            u = diff @ tril_inverse(C).T
        elif self.solve_mode == "pallas" and diff.ndim == 2:
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
        """C^{-T} applied to each row of (n, d) V: one right division, or a
        product with the inverse under ``solve_mode="inverse"``."""
        C = self.tril_scale()
        if self.solve_mode == "inverse":
            return V @ tril_inverse(C)
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
    sampler: str = "xla",
    compute_dtype: Any = None,
    solve_mode: str = "solve",
    layout: str = "dense",
) -> FullRankLocationScale:
    """Gaussian with a dense Cholesky-factor scale (reference:
    location_scale.jl:124-141), in the JAX package's argument order.  The
    scale is made lower-triangular here, so the stored parameters equal the
    effective ones; ``layout="packed"`` then packs it (ops/packing.py)."""
    location = torch.as_tensor(location)
    if scale is None:
        scale = torch.eye(location.shape[-1], dtype=location.dtype,
                          device=location.device)
    scale = torch.tril(torch.as_tensor(scale, device=location.device))
    if layout == "packed":
        scale = tril_pack(scale)
    return FullRankLocationScale(location=location, scale=scale, base=Normal(),
                                 sampler=sampler, compute_dtype=compute_dtype,
                                 solve_mode=solve_mode, layout=layout)


def is_location_scale(q: Any) -> bool:
    from .low_rank import LowRankLocationScale

    return isinstance(q, (MeanFieldLocationScale, FullRankLocationScale, LowRankLocationScale))
