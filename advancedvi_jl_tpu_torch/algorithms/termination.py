"""Algorithm-driven early termination (port of algorithms/termination.py).

The reference's ``step`` returns ``(state, terminate, info)`` and
``optimize`` stops on ``terminate`` (reference src/optimize.jl:67-74).  Here
the channel is a boolean ``info["terminate"]``: ``optimize`` reads it after
every step of an algorithm that emits it and stops at that exact step, in
chunk mode and in callback mode.  ``WithTermination`` wraps any algorithm
with a criterion ``criterion(new_state, info) -> bool tensor``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


class WithTermination:
    """Wrap an algorithm (init/step/output) with a stopping criterion
    evaluated after every step; True stops the run at that step."""

    def __init__(self, algorithm: Any, criterion: Callable):
        self.algorithm = algorithm
        self.criterion = criterion

    @property
    def supports_grad(self) -> bool:
        return getattr(self.algorithm, "supports_grad", False)

    def init(self, seed, q_init, prob):
        return self.algorithm.init(seed, q_init, prob)

    def step(self, state, **kwargs):
        new_state, info = self.algorithm.step(state, **kwargs)
        info["terminate"] = torch.as_tensor(self.criterion(new_state, info), dtype=torch.bool)
        return new_state, info

    def output(self, state):
        return self.algorithm.output(state)

    def estimate_objective(self, *args, **kwargs):
        return self.algorithm.estimate_objective(*args, **kwargs)


def elbo_at_least(target_elbo: float) -> Callable:
    """Stop once the step's ELBO estimate reaches ``target_elbo`` (a noisy
    single estimate: use more samples, or a callback's moving average, for
    a robust criterion)."""

    def criterion(state, info):
        return info["elbo"] >= target_elbo

    return criterion
