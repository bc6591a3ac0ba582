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

``compute_dtype="bfloat16"``: the two forward products take bfloat16
operands and give float32 sums (the JAX model's ``preferred_element_type``),
at the JAX model's rounding points: X and W1 rounded for the first product,
``h`` and ``tanh`` in float32, ``hcore`` and W2 rounded for the second.  The
gradient rounds where JAX's transpose of such a product does: each bf16
operand's gradient is a float32 product rounded to bfloat16.  On the card
the products are ``torch.bmm(..., out_dtype=torch.float32)`` (the tensor
cores); torch's CPU kernels have no mixed-dtype product (``aten::bmm.dtype``),
so on the CPU the rounded operands are widened to float32 (the same
function: a product of two bfloat16 values is exact in float32).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from ..core.problem import ORDER_AUTOGRAD
from ..families.location_scale import check_compute_dtype
from ..parallel.mesh import data_psum, shard_axis0
from .normal import SeedOrGenerator, _generator

_HALF_L2PI = 0.5 * math.log(2.0 * math.pi)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (broadcast over leading dims) of two bfloat16 tensors, summed
    in float32: ``torch.bmm(..., out_dtype=torch.float32)`` on the card, the
    operands widened to float32 on the CPU."""
    if not a.is_cuda:
        return a.float() @ b.float()
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = torch.bmm(a3, b3, out_dtype=torch.float32)
    return out.reshape(*batch, a.shape[-2], b.shape[-1])


def _unbroadcast(g: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``g`` summed over the leading dims that broadcasting added to ``shape``."""
    g = g.sum(dim=tuple(range(g.dim() - len(shape)))) if g.dim() > len(shape) else g
    keep = [i for i, (a, b) in enumerate(zip(g.shape, shape)) if b == 1 and a != 1]
    return g.sum(dim=keep, keepdim=True) if keep else g


class _Bf16Product(torch.autograd.Function):
    """a @ b with bfloat16 operands and float32 sums, and the JAX package's
    gradient of ``jnp.dot(a.astype(bf16), b.astype(bf16),
    preferred_element_type=f32)``: da = bf16(g bf16(b)^T), db = bf16(bf16(a)^T
    g), each a float32 product rounded to bfloat16 and widened back."""

    @staticmethod
    def forward(ctx, a, b):
        ab, bb = _bf16(a), _bf16(b)
        ctx.save_for_backward(ab, bb)
        ctx.shapes = (a.shape, b.shape)
        return _product_f32(ab, bb)

    @staticmethod
    def backward(ctx, g):
        ab, bb = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _unbroadcast(_bf16(g @ bb.float().mT).float(), ctx.shapes[0])
        if ctx.needs_input_grad[1]:
            db = _unbroadcast(_bf16(ab.float().mT @ g).float(), ctx.shapes[1])
        return da, db


@dataclass(frozen=True)
class BayesianMLP:
    X: torch.Tensor  # (n, in_dim)
    y: torch.Tensor  # (n,)
    likeadj: torch.Tensor  # 0-dim
    hidden: int = 32
    noise_scale: float = 0.1
    data_axis: Optional[str] = None
    # the forward products' operand type: None (float32) or "bfloat16"
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        check_compute_dtype(self.compute_dtype)

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
        if self.compute_dtype is not None:
            hcore = torch.tanh(_Bf16Product.apply(X, W1) + b1.unsqueeze(-2))  # float32
            return _Bf16Product.apply(hcore, W2.unsqueeze(-1)).squeeze(-1) + b2.unsqueeze(-1)
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
