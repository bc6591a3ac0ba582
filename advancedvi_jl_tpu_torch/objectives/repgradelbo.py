"""Reparameterization-gradient ELBO (port of objectives/repgradelbo.py).

One step: draw the whole batch, evaluate the batched log-density, add the
entropy estimate, and differentiate -ELBO with torch.autograd in the
family's tensors.  On a CUDA family the draw is the fused sampler kernel.
A family that exposes its base draw and the solve-free pieces (mean-field,
full-rank) takes the fast entropy path from (z, u); any other (low-rank)
draws z and takes ``estimate_entropy`` on ``q_stop``, as the reference
decides by ``supports_fast_entropy``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.problem import maybe_wrap_custom_grad
from ..core.pytree import tree_stop_gradient, value_and_grad
from .entropy import (
    CLOSED_FORM,
    estimate_entropy,
    estimate_entropy_from_draw,
    supports_fast_entropy,
)


def _use_fast(q) -> bool:
    return supports_fast_entropy(q) and hasattr(q, "sample_with_base")


@dataclass(frozen=True)
class RepGradELBO:
    """ELBO with the reparameterization gradient.

    Args:
      n_samples: Monte-Carlo samples per gradient estimate.
      entropy: any of objectives/entropy.py ALL_ENTROPY_ESTIMATORS; the
        zero-gradient ones are for ``KLMinRepGradProxDescent``.
    """

    n_samples: int = 1
    entropy: str = CLOSED_FORM

    def init(self, seed, q, prob):
        return ()  # stateless

    def _draw_with_base(self, q, key, noise: Optional[torch.Tensor]):
        """(z, u): the family's sampler, or z = ``q.from_base(u)`` for
        injected base draws ``noise`` of the family's shape (n_samples,
        q.base_dim): (n, d) mean-field and full-rank, (n, d + r) low-rank."""
        if noise is None:
            return q.sample_with_base(key, self.n_samples)
        u = noise.to(device=q.location.device, dtype=q.location.dtype)
        if u.shape != (self.n_samples, q.base_dim):
            raise ValueError(
                f"noise must have shape {(self.n_samples, q.base_dim)}, got "
                f"{tuple(u.shape)}"
            )
        return q.from_base(u), u

    def loss(self, q, prob, key, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Differentiable -ELBO estimate (q_stop is a detached copy of q).
        A family with the fast-entropy pieces gives the entropy from (z, u)
        without whitening; any other goes through ``q_stop.log_prob``."""
        q_stop = tree_stop_gradient(q)
        samples, u = self._draw_with_base(q, key, noise)
        if _use_fast(q):
            ent = estimate_entropy_from_draw(self.entropy, samples, u, q, q_stop)
        else:
            ent = estimate_entropy(self.entropy, samples, q, q_stop)
        energy = torch.mean(prob.log_density(samples))
        return -(energy + ent)

    def _loss_and_aux(self, q, prob, key, noise: Optional[torch.Tensor] = None):
        """(differentiable -ELBO, {"elbo": detached ELBO}): the function a
        wrapper such as ``SubsampledObjective`` differentiates.  A target
        with its own gradient oracle is differentiated through it."""
        nelbo = self.loss(q, maybe_wrap_custom_grad(prob), key, noise)
        return nelbo, {"elbo": -nelbo.detach()}

    def value_and_grad(self, q, prob, key, obj_state=(), noise=None):
        """One gradient estimate; returns (grad family, obj_state, info)."""
        grad, info = value_and_grad(lambda live: self._loss_and_aux(live, prob, key, noise), q)
        return grad, obj_state, info

    @torch.no_grad()
    def estimate_objective(self, key, q, prob, n_samples: Optional[int] = None):
        """-ELBO point estimate (no gradient)."""
        n = self.n_samples if n_samples is None else n_samples
        samples = q.sample(key, n)
        ent = estimate_entropy(self.entropy, samples, q, q)
        energy = torch.mean(prob.log_density(samples))
        return -(energy + ent)
