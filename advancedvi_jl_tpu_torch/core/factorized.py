"""Factorized targets: a log-joint with subsampling for free (port of
core/factorized.py; reference ext/AdvancedVIDynamicPPLExt.jl).

Users supply

- ``logprior_fn(theta)``: theta of shape ``(..., d)`` -> ``(...)``;
- ``loglike_fn(theta, data)``: the log-likelihood of a batch of data rows,
  a sum over the rows, theta batched as above;

and get the target protocol, ``likeadj * loglike + logprior``, with a
minibatch ``subsample`` that gathers the rows and rescales the likelihood
by n / batch.  ``data`` is a tensor, or a tuple, list or dict of tensors,
each with the data axis first.  ``data_axis``: under a device mesh with that
axis a rank evaluates ``loglike_fn`` on its row block of the data (or of
the minibatch) and the blocks' sums are summed over the axis
(parallel/mesh.py ``data_psum``); ``likeadj`` comes from the global counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..parallel.mesh import data_psum, shard_axis0
from .problem import ORDER_AUTOGRAD
from .transforms import Transform, TransformedTarget


def _map_data(fn: Callable, data: Any) -> Any:
    if isinstance(data, torch.Tensor):
        return fn(data)
    if isinstance(data, dict):
        return {k: _map_data(fn, v) for k, v in data.items()}
    if isinstance(data, (tuple, list)):
        return type(data)(_map_data(fn, v) for v in data)
    raise TypeError(f"data must be tensors (or tuples, lists, dicts of them), got {type(data)}")


def _first_tensor(data: Any) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data
    values = data.values() if isinstance(data, dict) else data
    return _first_tensor(next(iter(values)))


@dataclass(frozen=True)
class FactorizedTarget:
    """logprior(theta) + likeadj * loglike(theta, data)."""

    data: Any
    likeadj: torch.Tensor  # 0-dim likelihood rescaling
    logprior_fn: Callable
    loglike_fn: Callable
    dim: int
    n_data: int
    data_axis: Optional[str] = None

    def order(self) -> int:
        return ORDER_AUTOGRAD

    def log_density(self, theta: torch.Tensor) -> torch.Tensor:
        data = _map_data(lambda x: shard_axis0(x, self.data_axis), self.data)
        loglike = data_psum(self.loglike_fn(theta, data), self.data_axis)
        return self.logprior_fn(theta) + self.likeadj * loglike

    def subsample(self, indices: torch.Tensor) -> "FactorizedTarget":
        return FactorizedTarget(
            data=_map_data(lambda x: torch.index_select(x, 0, indices), self.data),
            likeadj=self.likeadj * (self.n_data / indices.shape[0]),
            logprior_fn=self.logprior_fn, loglike_fn=self.loglike_fn,
            dim=self.dim, n_data=self.n_data, data_axis=self.data_axis,
        )

    def unconstrained(self, transform: Transform) -> TransformedTarget:
        return TransformedTarget(prob=self, transform=transform)


def factorized_target(
    logprior_fn: Callable,
    loglike_fn: Callable,
    data: Any,
    dim: int,
    data_axis: Optional[str] = None,
) -> FactorizedTarget:
    """A ``FactorizedTarget`` over ``data`` (the tensors stay where they
    lie); ``data_axis``: the mesh axis that splits the data rows."""
    first = _first_tensor(data)
    dtype = first.dtype if first.is_floating_point() else torch.float32
    return FactorizedTarget(
        data=data, likeadj=torch.ones((), dtype=dtype, device=first.device),
        logprior_fn=logprior_fn, loglike_fn=loglike_fn, dim=dim, n_data=first.shape[0],
        data_axis=data_axis,
    )
