"""Normal-LogNormal target with an analytic optimum (port of
models/normallognormal.py).

A (d + 1)-dimensional target

    y ~ LogNormal(mu_y, sigma_y)        (positive scalar)
    x ~ Normal(mu_x, diag(sigma_x)^2)

whose variational family lives in unconstrained space through an Exp
bijector on y.  The joint is exactly a Gaussian in (log y, x), so the
optimum of a Gaussian family there is known: location [mu_y, mu_x], scale
diag([sigma_y, sigma_x]).  The log-density is batched over leading dims.
``make_normallognormal`` draws from a CPU ``torch.Generator`` and puts the
target on ``device`` (the card unless the caller asks for the CPU); the JAX
package's draws come across through ``convert.normallognormal_from_numpy``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.problem import ORDER_AUTOGRAD
from ..core.transforms import Exp, Identity, TransformedTarget, stacked
from .normal import SeedOrGenerator, _generator

_HALF_L2PI = 0.5 * math.log(2.0 * math.pi)


@dataclass(frozen=True)
class NormalLogNormal:
    mu_y: torch.Tensor  # 0-dim
    sigma_y: torch.Tensor  # 0-dim
    mu_x: torch.Tensor  # (d,)
    sigma_x: torch.Tensor  # (d,)

    @property
    def dim(self) -> int:
        return self.mu_x.shape[0] + 1

    def order(self) -> int:
        return ORDER_AUTOGRAD

    def log_density(self, theta: torch.Tensor) -> torch.Tensor:
        """theta = [y, x] in constrained space (y > 0), shape (..., d + 1)."""
        y, x = theta[..., 0], theta[..., 1:]
        logy = torch.log(y)
        lp_y = (
            -0.5 * torch.square((logy - self.mu_y) / self.sigma_y)
            - logy
            - torch.log(self.sigma_y)
            - _HALF_L2PI
        )
        lp_x = torch.sum(
            -0.5 * torch.square((x - self.mu_x) / self.sigma_x)
            - torch.log(self.sigma_x)
            - _HALF_L2PI,
            dim=-1,
        )
        return lp_y + lp_x

    def unconstrained(self) -> TransformedTarget:
        """Unconstrained-space target (exp on y, identity on x)."""
        return TransformedTarget(
            prob=self, transform=stacked((Exp(), 1), (Identity(), self.mu_x.shape[0]))
        )


def make_normallognormal(seed: SeedOrGenerator = None, n_dims: int = 10,
                         dtype=torch.float32, device="cuda"):
    """Returns (target, mu_true, scale_diag_true): the analytic optimum of
    the unconstrained-space Gaussian approximation."""
    g = _generator(seed)
    mu_y = torch.randn((), generator=g, dtype=dtype)
    sigma_y = torch.tensor(0.7, dtype=dtype)
    mu_x = torch.randn(n_dims, generator=g, dtype=dtype)
    sigma_x = 0.5 + torch.rand(n_dims, generator=g, dtype=dtype)
    target = NormalLogNormal(mu_y=mu_y.to(device), sigma_y=sigma_y.to(device),
                             mu_x=mu_x.to(device), sigma_x=sigma_x.to(device))
    mu_true = torch.cat([target.mu_y[None], target.mu_x])
    scale_true = torch.cat([target.sigma_y[None], target.sigma_x])
    return target, mu_true, scale_true
