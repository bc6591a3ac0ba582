"""Bijective transforms for constrained supports (port of core/transforms.py).

``forward`` maps unconstrained -> constrained; ``forward_and_ldj`` returns
``(constrained, log|det J_forward|)``.  Inputs have shape ``(..., d)`` and the
log-det-Jacobian has the batch shape ``(...)``, so a batch of samples is one
call (the reference vmaps one vector at a time).

Softplus writes softplus as the fused model bodies do, ``clamp_min(x, 0) +
log1p(exp(-|x|))``: every op of it is on K5's list (ops/cuda/ad_body.py), so
a positive site traces into the generated body.  Its autograd derivative at
exactly x = 0 is 1, not 1/2 (the kink of clamp_min and abs; ROADMAP "K5's
softplus kink").  Sigmoid and the simplex use ``torch.sigmoid``, and Ordered
``cumsum``, which K5 refuses by name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from .problem import order_of


class Transform:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_and_ldj(x)[0]

    def forward_and_ldj(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def unconstrained_dim(self, constrained_dim: int) -> int:
        return constrained_dim


@dataclass(frozen=True)
class Identity(Transform):
    def forward_and_ldj(self, x):
        return x, x.new_zeros(x.shape[:-1])

    def inverse(self, y):
        return y


@dataclass(frozen=True)
class Exp(Transform):
    """Unconstrained -> positive via exp; ldj = sum(x)."""

    def forward_and_ldj(self, x):
        return torch.exp(x), torch.sum(x, dim=-1)

    def inverse(self, y):
        return torch.log(y)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)), stable: the formula of jax.nn.softplus."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


@dataclass(frozen=True)
class Softplus(Transform):
    """Unconstrained -> positive via softplus; ldj = sum(log sigmoid(x))."""

    def forward_and_ldj(self, x):
        return softplus(x), torch.sum(-softplus(-x), dim=-1)

    def inverse(self, y):
        return y + torch.log(-torch.expm1(-y))


@dataclass(frozen=True)
class Sigmoid(Transform):
    """Unconstrained -> (lo, hi) via the scaled logistic sigmoid."""

    lo: float = 0.0
    hi: float = 1.0

    def forward_and_ldj(self, x):
        width = self.hi - self.lo
        y = self.lo + width * torch.sigmoid(x)
        ldj = torch.sum(math.log(width) - softplus(-x) - softplus(x), dim=-1)
        return y, ldj

    def inverse(self, y):
        u = (y - self.lo) / (self.hi - self.lo)
        return torch.log(u) - torch.log1p(-u)


@dataclass(frozen=True)
class StickBreakingSimplex(Transform):
    """Unconstrained R^{K-1} -> K-simplex by stick breaking: z_k =
    sigmoid(x_k - log(K - 1 - k)), y_k = rem_k z_k, rem_{k+1} = rem_k - y_k;
    ldj = sum_k log rem_k + log z_k + log(1 - z_k).  The K - 1 breaks run
    in order, as the reference's scan."""

    def forward_and_ldj(self, x):
        km1 = x.shape[-1]
        adj = torch.log(km1 - torch.arange(km1, dtype=x.dtype, device=x.device))
        z = torch.sigmoid(x - adj)
        rem = torch.ones_like(x[..., 0])
        ys, ldj = [], torch.zeros_like(rem)
        for k in range(km1):
            zk = z[..., k]
            yk = rem * zk
            ldj = ldj + (torch.log(rem) + torch.log(zk) + torch.log1p(-zk))
            ys.append(yk)
            rem = rem - yk
        return torch.stack(ys + [rem], dim=-1), ldj

    def inverse(self, y):
        km1 = y.shape[-1] - 1
        rem = 1.0 - torch.cat([torch.zeros_like(y[..., :1]),
                               torch.cumsum(y[..., :-1], dim=-1)], dim=-1)[..., :km1]
        z = y[..., :km1] / rem
        adj = torch.log(km1 - torch.arange(km1, dtype=y.dtype, device=y.device))
        return torch.log(z) - torch.log1p(-z) + adj

    def unconstrained_dim(self, constrained_dim: int) -> int:
        return constrained_dim - 1


@dataclass(frozen=True)
class Ordered(Transform):
    """Unconstrained R^K -> strictly increasing vectors: y_1 = x_1,
    y_k = y_{k-1} + exp(x_k); ldj = sum_{k>=2} x_k."""

    def forward_and_ldj(self, x):
        incr = torch.cat([x[..., :1], torch.exp(x[..., 1:])], dim=-1)
        return torch.cumsum(incr, dim=-1), torch.sum(x[..., 1:], dim=-1)

    def inverse(self, y):
        return torch.cat([y[..., :1], torch.log(torch.diff(y, dim=-1))], dim=-1)


@dataclass(frozen=True)
class Stacked(Transform):
    """Different transforms on contiguous slices of the last dimension."""

    transforms: tuple
    sizes: tuple

    def forward_and_ldj(self, x):
        pieces = []
        ldj = x.new_zeros(x.shape[:-1])
        offset = 0
        for t, n in zip(self.transforms, self.sizes):
            y, l = t.forward_and_ldj(_cols(x, offset, n))
            pieces.append(y)
            ldj = ldj + l
            offset += n
        return (torch.cat(pieces, dim=-1) if len(pieces) > 1 else pieces[0]), ldj

    def inverse(self, y):
        pieces = []
        offset = 0
        for t, n in zip(self.transforms, self.sizes):
            # the block's constrained width (it differs from n for the simplex)
            n_out = t.forward(y.new_zeros(n)).shape[-1]
            pieces.append(t.inverse(y[..., offset : offset + n_out]))
            offset += n_out
        return torch.cat(pieces, dim=-1)

    def unconstrained_dim(self, constrained_dim: int) -> int:
        return sum(self.sizes)


def _cols(x: torch.Tensor, offset: int, n: int) -> torch.Tensor:
    """Columns [offset, offset + n) of the last dimension; all of them as
    ``x`` itself (a slice of every column traces as an ``alias``, which K5
    does not take)."""
    return x if offset == 0 and n == x.shape[-1] else x[..., offset:offset + n]


def stacked(*pairs: Tuple[Transform, int]) -> Stacked:
    transforms, sizes = zip(*pairs)
    return Stacked(transforms=tuple(transforms), sizes=tuple(sizes))


@dataclass(frozen=True)
class Blockwise(Transform):
    """One block transform on each of ``n_blocks`` contiguous blocks of the
    last dimension, e.g. a (B, K) Dirichlet site: B independent K-simplices,
    not one (B K)-simplex.  ``block_in`` / ``block_out``: a block's
    unconstrained and constrained widths."""

    inner: Transform
    n_blocks: int
    block_in: int
    block_out: int

    def forward_and_ldj(self, x):
        batch = x.shape[:-1]
        y, ldj = self.inner.forward_and_ldj(x.reshape(*batch, self.n_blocks, self.block_in))
        return y.reshape(*batch, self.n_blocks * self.block_out), torch.sum(ldj, dim=-1)

    def inverse(self, y):
        batch = y.shape[:-1]
        x = self.inner.inverse(y.reshape(*batch, self.n_blocks, self.block_out))
        return x.reshape(*batch, self.n_blocks * self.block_in)

    def unconstrained_dim(self, constrained_dim: int) -> int:
        return self.n_blocks * self.block_in


@dataclass(frozen=True)
class TransformedTarget:
    """Change of variables: ``log_density(x) = prob.log_density(T(x)) + ldj``."""

    prob: Any
    transform: Transform

    @property
    def dim(self) -> int:
        d = getattr(self.prob, "dim")
        d = d() if callable(d) else int(d)
        return self.transform.unconstrained_dim(d)

    def order(self) -> int:
        return order_of(self.prob)

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        theta, ldj = self.transform.forward_and_ldj(x)
        return self.prob.log_density(theta) + ldj

    def subsample(self, indices: torch.Tensor) -> "TransformedTarget":
        """The inner target restricted to ``indices``, same transform."""
        from .problem import subsample

        return TransformedTarget(prob=subsample(self.prob, indices), transform=self.transform)


@dataclass(frozen=True)
class TransformedDistribution:
    """A variational family pushed through a transform: the constrained
    posterior (JAX core/transforms.py:266-293).  ``sample`` and ``log_prob``
    take the base family's keys and (..., d) batches."""

    base: Any
    transform: Transform

    def sample(self, key, n_samples: int) -> torch.Tensor:
        return self.transform.forward(self.base.sample(key, n_samples))

    def log_prob(self, y: torch.Tensor) -> torch.Tensor:
        """Density in the constrained space at one point (d,) or a batch
        (n, d): each row's own Jacobian."""
        x = self.transform.inverse(y)
        _, ldj = self.transform.forward_and_ldj(x)
        return self.base.log_prob(x) - ldj
