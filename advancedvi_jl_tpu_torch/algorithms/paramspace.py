"""Parameter-space SGD: ADVI (port of algorithms/paramspace.py).

One ``step`` is gradient estimate -> optimizer update -> operator ->
averaging, run eagerly.  The iteration counter and the Philox seed words are
host integers in the state, so a step never waits for the device: the draw
of step ``it`` is keyed by (seed words, it), the reference's
``fold_in(state.key, it)`` contract, and a resumed run repeats an
uninterrupted one bitwise.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..core.problem import ORDER_VALUE_ONLY, order_of
from ..families.location_scale import is_location_scale
from ..objectives.entropy import CLOSED_FORM, MONTE_CARLO, STL
from ..objectives.repgradelbo import RepGradELBO
from ..ops.cuda.location_scale_kernels import PhiloxKey, SeedLike, seed_words
from ..optim.averaging import PolynomialAveraging
from ..optim.operators import IdentityOperator
from ..optim.rules import apply_updates, dowg


@dataclass(frozen=True)
class ParamSpaceSGDState:
    """Warm-startable optimization state."""

    prob: Any
    q: Any
    iteration: int
    opt_state: Any
    obj_state: Any
    avg_state: Any
    seed: Tuple[int, int]


class ParamSpaceSGD:
    """Shared init/step/output for parameter-space SGD algorithms."""

    supports_grad = True

    def __init__(self, objective, optimizer, averager, operator):
        self.objective = objective
        self.optimizer = optimizer
        self.averager = averager
        self.operator = operator

    def init(self, seed: SeedLike, q_init, prob) -> ParamSpaceSGDState:
        """``seed``: an int, a ``torch.Generator`` or two seed words; it is
        turned into the two uint32 Philox seed words here."""
        if order_of(prob) <= ORDER_VALUE_ONLY:
            raise ValueError(
                "Target has capability order 0 (value-only, not "
                "differentiable). Reparameterization-gradient objectives "
                "require a differentiable target."
            )
        if is_location_scale(q_init) and isinstance(self.operator, IdentityOperator):
            warnings.warn(
                "IdentityOperator is used with a location-scale variational "
                "family. Optimization can fail due to singular scale "
                "matrices; consider using ClipScale."
            )
        words = seed_words(seed)
        return ParamSpaceSGDState(
            prob=prob,
            q=q_init,
            iteration=0,
            opt_state=self.optimizer.init(q_init),
            obj_state=self.objective.init(words, q_init, prob),
            avg_state=self.averager.init(q_init),
            seed=words,
        )

    def step(
        self,
        state: ParamSpaceSGDState,
        noise: Optional[torch.Tensor] = None,
        with_grad: bool = False,
    ):
        """One SGD step.  ``noise``: optional (n_samples, d) base draws that
        replace the sampler (the parity tests inject the reference's draws)."""
        it = state.iteration
        grad, obj_state, info = self.objective.value_and_grad(
            state.q, state.prob, PhiloxKey(state.seed, it), state.obj_state,
            noise=noise,
        )
        if with_grad:
            info["gradient"] = grad
        updates, opt_state = self.optimizer.update(grad, state.opt_state, state.q)
        q_new = self.operator.apply(apply_updates(state.q, updates), opt_state)
        avg_state = self.averager.apply(state.avg_state, q_new)
        info["diverged"] = ~torch.isfinite(info["elbo"])
        new_state = ParamSpaceSGDState(
            prob=state.prob,
            q=q_new,
            iteration=it + 1,
            opt_state=opt_state,
            obj_state=obj_state,
            avg_state=avg_state,
            seed=state.seed,
        )
        return new_state, info

    def output(self, state: ParamSpaceSGDState):
        """Family built from the averaged parameters."""
        return self.averager.value(state.avg_state)

    def estimate_objective(
        self, key: SeedLike, q, prob, n_samples: Optional[int] = None,
        entropy: str = MONTE_CARLO,
    ):
        """-ELBO via RepGrad with the Monte-Carlo entropy, whatever the
        training objective (reference common.jl:29-38)."""
        n = n_samples if n_samples is not None else self.objective.n_samples
        return RepGradELBO(n_samples=n, entropy=entropy).estimate_objective(
            key, q, prob
        )


def KLMinRepGradDescent(
    entropy: str = CLOSED_FORM,
    optimizer=None,
    n_samples: int = 1,
    averager=None,
    operator=None,
) -> ParamSpaceSGD:
    """ADVI: SGD on the reparameterization-gradient ELBO (reference
    constructors.jl:44-79; defaults DoWG + polynomial averaging)."""
    if entropy not in (CLOSED_FORM, STL, MONTE_CARLO):
        raise ValueError(
            "KLMinRepGradDescent supports closed_form / stl / monte_carlo "
            f"entropy, got {entropy!r}"
        )
    return ParamSpaceSGD(
        objective=RepGradELBO(n_samples=n_samples, entropy=entropy),
        optimizer=optimizer if optimizer is not None else dowg(),
        averager=averager if averager is not None else PolynomialAveraging(),
        operator=operator if operator is not None else IdentityOperator(),
    )


ADVI = KLMinRepGradDescent
