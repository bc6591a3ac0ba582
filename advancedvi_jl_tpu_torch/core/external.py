"""External (host) targets: numpy functions behind the target protocol (port
of core/external.py).

The reference accepts any callable, including ones no AD backend can
differentiate (capability order 0) and ones with their own gradient oracle
(order 1):

- order 0 (value only) feeds the score-gradient path
  (``KLMinScoreGradDescent``), which never differentiates the target;
- order 1 (value and gradient): ``log_density`` is a
  ``torch.autograd.Function`` whose backward is the cotangent times the
  host gradient, the reference's MixedADLogDensityProblem contract.

Every evaluation is one device-to-host round trip, as in the JAX package:
the whole batch of rows goes to the host function in one call.  This is for
legacy and simulator models, not the hot path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .problem import ORDER_GRAD, ORDER_VALUE_ONLY


def _back(out, theta: torch.Tensor, shape) -> torch.Tensor:
    """A host function's result as a tensor of theta's type and device."""
    return torch.as_tensor(np.asarray(out), dtype=theta.dtype).reshape(shape).to(theta.device)


class _ExternalLogDensity(torch.autograd.Function):
    """log pi(theta) by the host function; backward ct * the host gradient."""

    @staticmethod
    def forward(ctx, theta, host_fn, host_grad_fn):
        x = theta.detach().cpu().numpy()
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(_back(host_grad_fn(x), theta, theta.shape))
        return _back(host_fn(x), theta, theta.shape[:-1])

    @staticmethod
    def backward(ctx, ct):
        (g,) = ctx.saved_tensors
        return ct[..., None] * g, None, None


@dataclass(frozen=True)
class ExternalTarget:
    """A host Python function as a VI target.

    ``host_fn(theta_batch: np.ndarray (..., d)) -> np.ndarray (...)`` for
    order 0; for order 1 also ``host_grad_fn`` with the same batching,
    returning (..., d).
    """

    host_fn: Callable
    dim: int
    host_grad_fn: Optional[Callable] = None

    def order(self) -> int:
        return ORDER_GRAD if self.host_grad_fn is not None else ORDER_VALUE_ONLY

    def log_density(self, theta: torch.Tensor) -> torch.Tensor:
        if self.host_grad_fn is not None:
            return _ExternalLogDensity.apply(theta, self.host_fn, self.host_grad_fn)
        return _back(self.host_fn(theta.detach().cpu().numpy()), theta, theta.shape[:-1])

    def log_density_and_grad(self, theta: torch.Tensor):
        if self.host_grad_fn is None:
            raise ValueError("external target has no gradient oracle")
        x = theta.detach().cpu().numpy()
        return (_back(self.host_fn(x), theta, theta.shape[:-1]),
                _back(self.host_grad_fn(x), theta, theta.shape))
