"""Reparameterization-gradient ELBO (port of objectives/repgradelbo.py).

One step: draw (z, u) for the whole batch, evaluate the batched log-density,
add the entropy estimate, and differentiate -ELBO with torch.autograd in the
family's tensors.  On a CUDA family the draw is the fused sampler kernel.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from ..core.pytree import tensor_fields, tree_map, tree_stop_gradient
from .entropy import CLOSED_FORM, estimate_entropy, estimate_entropy_from_draw


@dataclass(frozen=True)
class RepGradELBO:
    """ELBO with the reparameterization gradient.

    Args:
      n_samples: Monte-Carlo samples per gradient estimate.
      entropy: CLOSED_FORM, MONTE_CARLO or STL (objectives/entropy.py).
    """

    n_samples: int = 1
    entropy: str = CLOSED_FORM

    def init(self, seed, q, prob):
        return ()  # stateless

    def _draw_with_base(self, q, key, noise: Optional[torch.Tensor]):
        """(z, u): the family's sampler, or z = u * scale + location for
        injected base draws ``noise`` of shape (n_samples, d)."""
        if noise is None:
            return q.sample_with_base(key, self.n_samples)
        u = noise.to(device=q.location.device, dtype=q.location.dtype)
        if u.shape != (self.n_samples, q.dim):
            raise ValueError(
                f"noise must have shape {(self.n_samples, q.dim)}, got "
                f"{tuple(u.shape)}"
            )
        return u * q.scale_diag + q.location, u

    def loss(self, q, prob, key, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Differentiable -ELBO estimate (q_stop is a detached copy of q).
        The slice's family exposes its base draw, so the entropy comes from
        (z, u) without whitening (the reference's fast-entropy path)."""
        q_stop = tree_stop_gradient(q)
        samples, u = self._draw_with_base(q, key, noise)
        ent = estimate_entropy_from_draw(self.entropy, samples, u, q, q_stop)
        energy = torch.mean(prob.log_density(samples))
        return -(energy + ent)

    def value_and_grad(self, q, prob, key, obj_state=(), noise=None):
        """One gradient estimate; returns (grad family, obj_state, info)."""
        with torch.enable_grad():
            live = tree_map(lambda t: t.detach().requires_grad_(True), q)
            nelbo = self.loss(live, prob, key, noise)
            names = tensor_fields(live)
            grads = torch.autograd.grad(nelbo, [getattr(live, n) for n in names])
        grad = dataclasses.replace(q, **dict(zip(names, grads)))
        return grad, obj_state, {"elbo": -nelbo.detach()}

    @torch.no_grad()
    def estimate_objective(self, key, q, prob, n_samples: Optional[int] = None):
        """-ELBO point estimate (no gradient)."""
        n = self.n_samples if n_samples is None else n_samples
        samples = q.sample(key, n)
        ent = estimate_entropy(self.entropy, samples, q, q)
        energy = torch.mean(prob.log_density(samples))
        return -(energy + ent)
