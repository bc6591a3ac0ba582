"""Subsampled objective wrapper: doubly-stochastic VI (port of
objectives/subsampled.py; reference subsampledobjective.jl:10-90).

One gradient step advances the reshuffling schedule, restricts the target
to the step's batch with ``subsample`` (the likelihood rescaled by
n / batch), restricts the family inside the differentiated function (the
identity for the location-scale families, a row gather for amortized ones)
and differentiates the inner objective there.  The batch gather is an
``index_select`` on the target's device.  Under a device mesh every rank
forms the same batch (the schedule is a function of the seed), and a
target with a data axis takes its row block of it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..core.problem import subsample
from ..core.pytree import tree_leaves, value_and_grad
from ..ops.cuda.location_scale_kernels import PhiloxKey, as_key
from ..subsampling import ReshufflingBatchSubsampling


@dataclass(frozen=True)
class SubsampledObjective:
    objective: Any
    subsampling: ReshufflingBatchSubsampling

    @property
    def n_samples(self) -> int:
        return self.objective.n_samples

    def init(self, seed, q, prob):
        """The schedule's state, its permutation on the family's device.
        The inner objective's ``init`` runs too, so that its checks fire
        here; only stateless inner objectives compose."""
        inner = self.objective.init(seed, q, prob)
        if inner != ():
            raise NotImplementedError(
                "SubsampledObjective only composes with stateless objectives; "
                f"{type(self.objective).__name__}.init returned non-empty state."
            )
        return self.subsampling.init(seed, device=tree_leaves(q)[0].device)

    def _loss_and_aux(self, q, prob_sub, batch, key, noise=None):
        # the family is restricted inside the differentiated function, so an
        # amortized family's gradient is a scatter back into its full arrays
        return self.objective._loss_and_aux(subsample(q, batch), prob_sub, key, noise)

    def value_and_grad(self, q, prob, key, obj_state, noise: Optional[torch.Tensor] = None):
        """One gradient estimate on the schedule's next batch; returns (grad
        family, new schedule state, info with ``epoch`` and ``step``)."""
        batch, sub_state, sub_info = self.subsampling.step(obj_state)
        prob_sub = subsample(prob, batch)
        grad, info = value_and_grad(
            lambda live: self._loss_and_aux(live, prob_sub, batch, key, noise), q,
            getattr(self.objective, "mc_axis", None))
        return grad, sub_state, {**info, **sub_info}

    @torch.no_grad()
    def estimate_objective(self, key, q, prob, n_samples: Optional[int] = None):
        """The inner objective averaged over one full epoch of batches
        (reference subsampledobjective.jl:47-58): the epoch is the schedule's
        first permutation under ``key``'s seed words, batch ``i`` draws with
        ``PhiloxKey(seed, it + i)``."""
        k = as_key(key)
        batches = self.subsampling.epoch_batches(k.seed, device=tree_leaves(q)[0].device)
        total = 0.0
        for i, batch in enumerate(batches):
            total = total + self.objective.estimate_objective(
                PhiloxKey(k.seed, k.it + i), subsample(q, batch), subsample(prob, batch),
                n_samples,
            )
        return total / batches.shape[0]
