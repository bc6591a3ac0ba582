"""Reparameterization-gradient ELBO (port of objectives/repgradelbo.py).

One step: draw the whole batch, evaluate the batched log-density, add the
entropy estimate, and differentiate -ELBO with torch.autograd in the
family's tensors.  A family that exposes its base draw and the solve-free
pieces (mean-field, full-rank) takes the fast entropy path from (z, u)
(``sample_with_base``) unless ``fast_entropy=False``; any other family
draws z with ``q.sample`` and takes ``estimate_entropy`` on ``q_stop``, as
the reference decides by ``supports_fast_entropy``.  On a CUDA family the
draw is a sampler kernel either way (``q.sample`` is the first half of
``sample_with_base`` for the location-scale families).  Injected base
draws ``noise`` go to the family's ``from_base``.

``antithetic`` draws n/2 rows and mirrors them through the location,
z' = 2 m - z with base draw u' = -u: unbiased for a symmetric base, and the
energy term's variance drops where log p is near-linear over q.  ``remat``
recomputes the log-density's graph in the backward pass instead of keeping
it (``torch.utils.checkpoint``); the draw happens before it.

``mc_axis`` (the samples over a device mesh's axis, parallel/mesh.py):
under a mesh with that axis each rank draws its rows of the n-row draw (the
samplers at a row offset: the one-process draw's rows bit for bit) and
takes the estimate on them weighted by rows / n, its share; the shares'
values and gradients are summed over the axis after the local backward.
An antithetic rank draws the base rows its mirrored rows need.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.problem import maybe_wrap_custom_grad
from ..core.pytree import tree_leaves, tree_stop_gradient, value_and_grad
from ..families.location_scale import is_location_scale, take_rows
from ..parallel.mesh import mc_rows
from .entropy import (
    CLOSED_FORM,
    estimate_entropy,
    estimate_entropy_from_draw,
    supports_fast_entropy,
)


def _use_fast(q) -> bool:
    """Whether the family takes the solve-free entropy from (z, u)."""
    return supports_fast_entropy(q) and hasattr(q, "sample_with_base")


def base_noise(q, noise: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Injected base draws on the family's device and dtype, of its shape
    (n_samples, q.base_dim)."""
    leaf = tree_leaves(q)[0]
    u = noise.to(device=leaf.device, dtype=leaf.dtype)
    if u.shape != (n_samples, q.base_dim):
        raise ValueError(
            f"noise must have shape {(n_samples, q.base_dim)}, got {tuple(u.shape)}"
        )
    return u


def mc_share(q, n_samples: int, mc_axis: Optional[str]):
    """(the family to draw from, this rank's rows) of an n_samples-row draw
    whose rows are cut over ``mc_axis`` (rows None outside a mesh with that
    axis).  Where the family's ``tp_axis`` is that same axis it draws
    without its column split: the rows split the product over the axis
    already, so each rank forms its rows with every column (the values of
    the one-process draw, as JAX's)."""
    if mc_axis is not None and getattr(q, "tp_axis", None) == mc_axis:
        q = dataclasses.replace(q, tp_axis=None)
    return q, mc_rows(n_samples, mc_axis)


def draw_with_base(q, key, n_samples: int, noise: Optional[torch.Tensor] = None,
                   rows=None):
    """(z, u): the family's sampler, or z = ``q.from_base(u)`` for injected
    base draws ``noise`` of the family's shape (n_samples, q.base_dim):
    (n, d) mean-field and full-rank, (n, d + r) low-rank.  ``rows=(row0,
    count)``: those rows of the n_samples-row draw, which a location-scale
    family draws alone; any other family draws them all and keeps them."""
    if noise is not None:
        u = take_rows(base_noise(q, noise, n_samples), rows)
        return q.from_base(u), u
    if is_location_scale(q):
        return q.sample_with_base(key, n_samples, rows)
    z, u = q.sample_with_base(key, n_samples)
    return take_rows(z, rows), take_rows(u, rows)


def draw(q, key, n_samples: int, noise: Optional[torch.Tensor] = None,
         rows=None) -> torch.Tensor:
    """z: ``q.sample``, or ``q.from_base`` of injected base draws.
    ``rows=(row0, count)``: those rows of the n_samples-row draw, which a
    location-scale family draws alone; any other family draws them all and
    keeps them."""
    if noise is not None:
        return q.from_base(take_rows(base_noise(q, noise, n_samples), rows))
    if is_location_scale(q):
        return q.sample(key, n_samples, rows)
    return take_rows(q.sample(key, n_samples), rows)


def antithetic_spans(n: int, rows):
    """The base rows that rows ``rows=(row0, count)`` of an antithetic
    n-row draw need: (the span drawn as it is, the span mirrored), each a
    (row0, count) of the n/2 base rows (row i >= n/2 mirrors base row
    i - n/2)."""
    half, (row0, count) = n // 2, rows
    end = row0 + count
    first = max(row0, half) - half
    return (row0, max(0, min(end, half) - row0)), (first, max(0, end - half - first))


def _mirror(q, z: torch.Tensor) -> torch.Tensor:
    """The antithetic image 2 m - z (the flat location: a per-datapoint
    family's is (rows, k))."""
    return 2.0 * q.location.reshape(-1) - z


def _antithetic_rows(q, n: int, rows, take):
    """Rows ``rows`` of an antithetic n-row draw from ``take(span)``, the
    tuple (z, [u]) of a span of base rows: the plain span as drawn, the
    mirrored one as (2 m - z, [-u])."""
    plain, mirrored = antithetic_spans(n, rows)
    parts = [take(plain)] if plain[1] else []
    if mirrored[1]:
        z, *u = take(mirrored)
        parts.append((_mirror(q, z), *(-t for t in u)))
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))


@dataclass(frozen=True)
class RepGradELBO:
    """ELBO with the reparameterization gradient.

    Args:
      n_samples: Monte-Carlo samples per gradient estimate.
      entropy: any of objectives/entropy.py ALL_ENTROPY_ESTIMATORS; the
        zero-gradient ones are for ``KLMinRepGradProxDescent``.
      mc_axis: the mesh axis that splits the samples (parallel/mesh.py), or
        None.
      remat: recompute the log-density's graph in the backward pass.
      antithetic: draw n/2 samples and mirror them, z' = 2 m - z (even n,
        a location-scale family with a symmetric base).
      fast_entropy: the solve-free entropy from (z, u) where the family
        allows it; False takes ``estimate_entropy`` (the A/B knob).
    """

    n_samples: int = 1
    entropy: str = CLOSED_FORM
    mc_axis: Optional[str] = None
    remat: bool = False
    antithetic: bool = False
    fast_entropy: bool = True

    def init(self, seed, q, prob):
        return ()  # stateless

    def _check_antithetic(self, q, n: int) -> None:
        if n % 2 != 0:
            raise ValueError(
                f"antithetic sampling requires an even n_samples, got {n}"
            )
        if not hasattr(q, "location"):
            raise ValueError(
                "antithetic sampling requires a location-scale family "
                f"(symmetric base); got {type(q).__name__}"
            )
        base = getattr(q, "base", None)
        if base is not None and not (
            hasattr(base, "symmetric") and base.symmetric()
        ):
            # z' = 2m - z has the law of q only when -u ~ u for the base
            raise ValueError(
                "antithetic sampling requires a symmetric base distribution "
                f"(-u ~ u); {type(base).__name__} does not declare "
                "symmetric() = True."
            )

    def _draw(self, q, key, noise: Optional[torch.Tensor] = None,
              n: Optional[int] = None, rows=None) -> torch.Tensor:
        """z of n draws (default ``n_samples``; their ``rows``) through
        ``q.sample``.  Antithetic: n/2 draws (``noise`` then holds n/2 rows)
        and their mirror images."""
        n = self.n_samples if n is None else n
        if not self.antithetic:
            return draw(q, key, n, noise, rows)
        self._check_antithetic(q, n)
        if rows is None:
            z = draw(q, key, n // 2, noise)
            return torch.cat([z, _mirror(q, z)], dim=0)
        return _antithetic_rows(q, n, rows, lambda span: (
            draw(q, key, n // 2, noise, span),))[0]

    def _draw_with_base(self, q, key, noise: Optional[torch.Tensor] = None,
                        n: Optional[int] = None, rows=None):
        """(z, u) for the fast entropy path; the antithetic mirror of u is -u."""
        n = self.n_samples if n is None else n
        if not self.antithetic:
            return draw_with_base(q, key, n, noise, rows)
        self._check_antithetic(q, n)
        if rows is None:
            z, u = draw_with_base(q, key, n // 2, noise)
            return torch.cat([z, _mirror(q, z)], dim=0), torch.cat([u, -u], dim=0)
        return _antithetic_rows(q, n, rows, lambda span: draw_with_base(
            q, key, n // 2, noise, span))

    def _energy(self, prob, samples: torch.Tensor) -> torch.Tensor:
        if self.remat:
            return torch.mean(checkpoint(prob.log_density, samples, use_reentrant=False))
        return torch.mean(prob.log_density(samples))

    def loss(self, q, prob, key, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Differentiable -ELBO estimate (q_stop is a detached copy of q).
        The fast path gives the entropy from (z, u) without whitening; any
        other goes through ``q_stop.log_prob``.  Under a mesh with
        ``mc_axis``: the estimate on this rank's rows times rows / n."""
        q, rows = mc_share(q, self.n_samples, self.mc_axis)
        q_stop = tree_stop_gradient(q)
        if self.fast_entropy and _use_fast(q):
            samples, u = self._draw_with_base(q, key, noise, rows=rows)
            ent = estimate_entropy_from_draw(self.entropy, samples, u, q, q_stop)
        else:
            samples = self._draw(q, key, noise, rows=rows)
            ent = estimate_entropy(self.entropy, samples, q, q_stop)
        nelbo = -(self._energy(prob, samples) + ent)
        return nelbo if rows is None else nelbo * (rows[1] / self.n_samples)

    def _loss_and_aux(self, q, prob, key, noise: Optional[torch.Tensor] = None):
        """(differentiable -ELBO, {"elbo": detached ELBO}): the function a
        wrapper such as ``SubsampledObjective`` differentiates.  A target
        with its own gradient oracle is differentiated through it."""
        nelbo = self.loss(q, maybe_wrap_custom_grad(prob), key, noise)
        return nelbo, {"elbo": -nelbo.detach()}

    def value_and_grad(self, q, prob, key, obj_state=(), noise=None):
        """One gradient estimate; returns (grad family, obj_state, info)."""
        grad, info = value_and_grad(lambda live: self._loss_and_aux(live, prob, key, noise), q,
                                    self.mc_axis)
        return grad, obj_state, info

    @torch.no_grad()
    def estimate_objective(self, key, q, prob, n_samples: Optional[int] = None):
        """-ELBO point estimate (no gradient).  Antithetic pairs the draws
        for any even n (plain draws for an odd n)."""
        n = self.n_samples if n_samples is None else n_samples
        if self.antithetic and n % 2 == 0:
            samples = self._draw(q, key, n=n)
        else:
            samples = q.sample(key, n)
        ent = estimate_entropy(self.entropy, samples, q, q)
        energy = torch.mean(prob.log_density(samples))
        return -(energy + ent)
