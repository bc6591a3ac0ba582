"""Importance-weighted ELBO (IWAE bound) with doubly-reparameterized
gradients (port of objectives/iwelbo.py).

    IW-ELBO_k = E_{z_1..k ~ q} [ log (1/k) sum_j p(z_j) / q(z_j) ]

a lower bound tighter than the ELBO and non-decreasing in k (Burda et al.
2016).  ``dreg=False`` differentiates the logsumexp with a live q density
(the plain IWAE gradient); ``dreg=True`` (default) is the
doubly-reparameterized estimator (Tucker et al. 2019), the surrogate
``-sum_j sg(w~_j)^2 (log p - log q_stop)(z_j)`` with live reparameterized z
and w~ the self-normalized weights, whose signal-to-noise ratio does not
decay with k.  The k draws are one batched ``q.sample`` (the sampler kernel on a
float32 Normal family) and one batched log-density; a full-rank family
with ``solve_mode="pallas"`` whitens them with K8.  Weights are formed
only through ``softmax`` and ``logsumexp`` of the log-weights.

Under a device mesh with ``mc_axis`` each rank draws its rows of the k;
the log-sum-exp over the mesh is a maximum and then a sum of the rows'
exponentials (two reductions of values), the self-normalized weights are
normalized by that global sum, and each rank differentiates its rows'
surrogate terms (``-sum sg(w~) log w`` for the plain gradient); the first
rank of the axis carries the bound.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..algorithms.paramspace import ParamSpaceSGD, _subsampled
from ..core.problem import maybe_wrap_custom_grad
from ..core.pytree import tree_stop_gradient, value_and_grad
from ..optim.averaging import PolynomialAveraging
from ..optim.operators import IdentityOperator
from ..optim.rules import dowg
from ..parallel.mesh import own, pmax, psum
from .repgradelbo import draw, mc_share


@dataclass(frozen=True)
class IWELBO:
    """Importance-weighted ELBO objective (a drop-in for ParamSpaceSGD).

    Args:
      n_samples: k, the number of importance samples a step.
      dreg: the doubly-reparameterized gradient (default) or the plain IWAE
        gradient.
      mc_axis: the mesh axis that splits the samples (parallel/mesh.py), or
        None.

    Needs a family with a reparameterized draw and ``log_prob``.
    """

    n_samples: int = 8
    dreg: bool = True
    mc_axis: Optional[str] = None

    def init(self, seed, q, prob):
        self._check_family(q)
        return ()

    @staticmethod
    def _check_family(q) -> None:
        if not hasattr(q, "log_prob"):
            raise ValueError(
                "IWELBO requires a family with log_prob (importance weights "
                f"need the density at drawn points); {type(q).__name__} "
                "has none."
            )
        if getattr(q, "weight", 1.0) != 1.0:
            # log w = log p - weight * log q is the importance weight of no
            # distribution: weighted densities suit the pathwise ELBOs only
            raise ValueError(
                "IWELBO does not support weighted-density families "
                f"({type(q).__name__} with weight={q.weight}); use "
                "RepGradELBO for amortized subsampling."
            )

    def _loss_and_aux(self, q, prob, key, noise: Optional[torch.Tensor] = None):
        """(differentiable surrogate loss, {"elbo": the detached IW bound})."""
        self._check_family(q)
        prob = maybe_wrap_custom_grad(prob)
        k = self.n_samples
        q_draw, rows = mc_share(q, k, self.mc_axis)
        z = draw(q_draw, key, k, noise, rows)
        logp = prob.log_density(z)
        log_k = math.log(k)
        if rows is not None:
            return self._sharded_loss_and_aux(q, z, logp, log_k)
        if self.dreg:
            # the parameters enter only through z: a frozen density at live z
            logw = logp - tree_stop_gradient(q).log_prob(z)
            w_norm = torch.softmax(logw, dim=0).detach()
            # at k = 1 this is the STL ELBO surrogate (w~ = 1)
            loss = -torch.sum(w_norm * w_norm * logw)
            bound = (torch.logsumexp(logw, dim=0) - log_k).detach()
        else:
            logw = logp - q.log_prob(z)
            live = torch.logsumexp(logw, dim=0) - log_k
            loss, bound = -live, live.detach()
        return loss, {"elbo": bound}

    def _sharded_loss_and_aux(self, q, z, logp, log_k):
        """This rank's surrogate terms, normalized by the mesh's log-sum-exp;
        the bound on the axis's first rank (zero on the others)."""
        axis = self.mc_axis
        logw = logp - (tree_stop_gradient(q) if self.dreg else q).log_prob(z)
        lw = logw.detach()
        top = pmax(torch.max(lw), axis)
        total = psum(torch.sum(torch.exp(lw - top)), axis)
        w_norm = torch.exp(lw - top) / total
        loss = -torch.sum((w_norm * w_norm if self.dreg else w_norm) * logw)
        bound = top + torch.log(total) - log_k
        return loss, {"elbo": bound if own(axis) else torch.zeros_like(bound)}

    def loss(self, q, prob, key, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._loss_and_aux(q, prob, key, noise)[0]

    def value_and_grad(self, q, prob, key, obj_state=(), noise=None):
        """One gradient estimate; returns (grad family, obj_state, info)."""
        grad, info = value_and_grad(lambda live: self._loss_and_aux(live, prob, key, noise), q,
                                    self.mc_axis)
        return grad, obj_state, info

    @torch.no_grad()
    def estimate_objective(self, key, q, prob, n_samples: Optional[int] = None):
        """Negative IW-ELBO_k estimate (lower is better, like -ELBO)."""
        k = self.n_samples if n_samples is None else n_samples
        z = q.sample(key, k)
        logw = prob.log_density(z) - q.log_prob(z)
        return -(torch.logsumexp(logw, dim=0) - math.log(k))


def KLMinIWRepGradDescent(
    n_samples: int = 8,
    dreg: bool = True,
    optimizer=None,
    averager=None,
    operator=None,
    subsampling=None,
    mc_axis=None,
) -> ParamSpaceSGD:
    """SGD on the importance-weighted ELBO (IWAE bound; DReG by default),
    with KLMinRepGradDescent's defaults (DoWG, polynomial averaging).
    ``subsampling`` wraps the objective in ``SubsampledObjective``."""
    return ParamSpaceSGD(
        objective=_subsampled(IWELBO(n_samples=n_samples, dreg=dreg, mc_axis=mc_axis),
                              subsampling),
        optimizer=optimizer if optimizer is not None else dowg(),
        averager=averager if averager is not None else PolynomialAveraging(),
        operator=operator if operator is not None else IdentityOperator(),
    )
