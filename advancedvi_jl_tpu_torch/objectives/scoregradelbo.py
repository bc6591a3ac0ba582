"""Score-function ELBO gradient via the VarGrad objective (port of
objectives/scoregradelbo.py; reference scoregradelbo.jl:15-117).

VarGrad, the leave-one-out control variate (Richter et al. 2020): draw
samples and evaluate the target with stopped gradients, then differentiate

    var_n(f) / 2,   f_i = log q(z_i) - log pi(z_i)

in the variational parameters.  Only ``q.log_prob`` is differentiated, so
the target need not be differentiable: this is the objective for value-only
(order-0) targets.  ``info["elbo"]`` is the plain ELBO estimate, not the
VarGrad value (reference scoregradelbo.jl:96-117).

Under a device mesh with ``mc_axis`` each rank draws its rows; the
gradient of var_n(f) / 2 is (1/n) sum_i (f_i - mean f) d log q(z_i), so the
ranks first sum f for the global mean (one reduction of a value) and then
differentiate their rows' part, which ``value_and_grad`` sums.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.pytree import tree_stop_gradient, value_and_grad
from ..parallel.mesh import psum
from .repgradelbo import draw, mc_share


@dataclass(frozen=True)
class ScoreGradELBO:
    """ELBO with the VarGrad score-function gradient.

    Args:
      n_samples: Monte-Carlo samples per gradient estimate, at least 2 (the
        control variate is a sample variance, identically 0 for one sample).
      mc_axis: the mesh axis that splits the samples (parallel/mesh.py), or
        None.
    """

    n_samples: int = 2
    mc_axis: Optional[str] = None

    def __post_init__(self):
        if self.n_samples < 2:
            raise ValueError(
                "ScoreGradELBO (VarGrad) needs n_samples >= 2: the "
                "leave-one-out control variate is a sample variance, which "
                f"is identically 0 for n_samples={self.n_samples}."
            )

    def init(self, seed, q, prob):
        return ()  # stateless

    def _draw(self, q, key, noise: Optional[torch.Tensor], rows=None) -> torch.Tensor:
        """Detached samples: the family's sampler, or its ``from_base`` of
        injected base draws ``noise`` of shape (n_samples, q.base_dim); this
        rank's ``rows`` of them under a mesh."""
        n = self.n_samples
        return draw(q, key, n, noise, rows)

    def loss_and_elbo(self, q, prob, key, noise: Optional[torch.Tensor] = None):
        """(differentiable VarGrad loss, detached plain ELBO estimate).
        Samples and log pi are detached; only ``q.log_prob`` is live.
        Weighted-density families are refused: VarGrad is quadratic in f, so
        a weight w would scale the gradient by w^2 instead of w."""
        if getattr(q, "weight", 1.0) != 1.0:
            raise ValueError(
                "ScoreGradELBO (VarGrad) does not support weighted-density "
                f"families ({type(q).__name__} with weight={q.weight}): the "
                "quadratic control variate mis-scales the subsampled "
                "gradient. Use RepGradELBO for amortized subsampling."
            )
        n = self.n_samples
        q_draw, rows = mc_share(tree_stop_gradient(q), n, self.mc_axis)
        with torch.no_grad():
            samples = self._draw(q_draw, key, noise, rows)
            log_pi = prob.log_density(samples)
        log_q = q.log_prob(samples)
        f = log_q - log_pi
        if rows is None:
            vargrad = (torch.mean(f * f) - torch.mean(f) ** 2) / 2.0
            return vargrad, torch.mean(log_pi - log_q.detach())
        # this rank's part of the gradient of var_n(f) / 2 about the global mean
        f = f.detach()
        f_mean = psum(torch.sum(f), self.mc_axis) / n
        return torch.sum((f - f_mean) * log_q) / n, torch.sum(log_pi - log_q.detach()) / n

    def _loss_and_aux(self, q, prob, key, noise: Optional[torch.Tensor] = None):
        """(VarGrad loss, {"elbo": plain ELBO estimate}): the function a
        wrapper such as ``SubsampledObjective`` differentiates."""
        loss, elbo = self.loss_and_elbo(q, prob, key, noise)
        return loss, {"elbo": elbo}

    def value_and_grad(self, q, prob, key, obj_state=(), noise=None):
        """One gradient estimate; returns (grad family, obj_state, info)."""
        grad, info = value_and_grad(lambda live: self._loss_and_aux(live, prob, key, noise), q,
                                    self.mc_axis)
        return grad, obj_state, info

    @torch.no_grad()
    def estimate_objective(self, key, q, prob, n_samples: Optional[int] = None):
        """-ELBO point estimate (reference scoregradelbo.jl:64-75)."""
        n = self.n_samples if n_samples is None else n_samples
        samples = q.sample(key, n)
        return -torch.mean(prob.log_density(samples) - q.log_prob(samples))
