"""Bayesian neural-network posterior (port of models/bnn.py; BASELINE.md's
BNN configuration).

A one-hidden-layer MLP regression posterior: weights ~ N(0, 1),
y ~ N(f_w(x), noise_scale^2).  theta is the flat weight vector [W1 (in_dim
x hidden), b1 (hidden), W2 (hidden), b2]; the forward pass is batched over
samples and data, so a step of mean-field ADVI on it is two matrix products
per sample.  ``subsample`` keeps a minibatch and rescales the likelihood by
n / batch.  ``data_axis``: under a device mesh with that axis a rank takes
its row block of the data and the blocks' likelihood sums are summed over
the axis (parallel/mesh.py ``data_psum``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..core.problem import ORDER_AUTOGRAD
from ..parallel.mesh import data_psum, shard_axis0
from .normal import SeedOrGenerator, _generator

_HALF_L2PI = 0.5 * math.log(2.0 * math.pi)


@dataclass(frozen=True)
class BayesianMLP:
    X: torch.Tensor  # (n, in_dim)
    y: torch.Tensor  # (n,)
    likeadj: torch.Tensor  # 0-dim
    hidden: int = 32
    noise_scale: float = 0.1
    data_axis: Optional[str] = None
    # The JAX model's bf16 forward products; the port computes in float32.
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        if self.compute_dtype is not None:
            raise NotImplementedError(
                "BayesianMLP(compute_dtype=...) is not ported: the port's forward pass "
                "runs in float32 (ROADMAP Queue 1 item 5)"
            )

    @property
    def in_dim(self) -> int:
        return self.X.shape[1]

    @property
    def dim(self) -> int:
        h, i = self.hidden, self.in_dim
        return i * h + h + h + 1  # W1, b1, W2, b2

    def order(self) -> int:
        return ORDER_AUTOGRAD

    def replace(self, **kw) -> "BayesianMLP":
        return replace(self, **kw)

    def _unpack(self, theta: torch.Tensor):
        h, i = self.hidden, self.in_dim
        W1 = theta[..., : i * h].reshape(*theta.shape[:-1], i, h)
        b1 = theta[..., i * h: i * h + h]
        W2 = theta[..., i * h + h: i * h + 2 * h]
        b2 = theta[..., i * h + 2 * h]
        return W1, b1, W2, b2

    def forward(self, theta: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        """Predictions (..., n) for weights theta (..., d) on inputs X (n, in_dim)."""
        W1, b1, W2, b2 = self._unpack(theta)
        hcore = torch.tanh(X @ W1 + b1.unsqueeze(-2))  # (..., n, h)
        return (hcore @ W2.unsqueeze(-1)).squeeze(-1) + b2.unsqueeze(-1)

    def log_density(self, theta: torch.Tensor) -> torch.Tensor:
        X, y = shard_axis0(self.X, self.data_axis), shard_axis0(self.y, self.data_axis)
        pred = self.forward(theta, X)
        s = self.noise_scale
        loglike = data_psum(torch.sum(
            -0.5 * torch.square((y - pred) / s) - math.log(s) - _HALF_L2PI, dim=-1),
            self.data_axis)
        logprior = torch.sum(-0.5 * torch.square(theta) - _HALF_L2PI, dim=-1)
        return self.likeadj * loglike + logprior

    def subsample(self, indices: torch.Tensor) -> "BayesianMLP":
        n = self.X.shape[0]
        return replace(self, X=torch.index_select(self.X, 0, indices),
                       y=torch.index_select(self.y, 0, indices),
                       likeadj=self.likeadj * (n / indices.shape[0]))


def make_bnn(seed: SeedOrGenerator = None, n_data: int = 256, in_dim: int = 8,
             hidden: int = 32, dtype=torch.float32, device="cuda") -> BayesianMLP:
    """Synthetic regression data y = sin(X w) + 0.1 noise from a CPU
    ``torch.Generator`` (the JAX package's recipe, other numbers), put on
    ``device`` (the card unless the caller asks for the CPU)."""
    g = _generator(seed)
    X = torch.randn(n_data, in_dim, generator=g, dtype=dtype)
    f = torch.sin(X @ torch.randn(in_dim, generator=g, dtype=dtype))
    y = f + 0.1 * torch.randn(n_data, generator=g, dtype=dtype)
    return BayesianMLP(X=X.to(device), y=y.to(device),
                       likeadj=torch.ones((), dtype=dtype, device=device), hidden=hidden)
