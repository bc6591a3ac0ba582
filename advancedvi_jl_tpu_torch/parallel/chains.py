"""Many independent VI chains of the general step (port of parallel/chains.py).

Run K restarts or replicates of one algorithm side by side: multi-start
fits, and sweeps whose per-chain values live in the family or the optimizer
state.  The JAX package vmaps the step over a leading chain axis; here the
step's samplers are kernels called through ``data_ptr()``, which
``torch.func.vmap`` cannot batch, so ``step_chains`` advances each chain's
``ParamSpaceSGDState`` in turn.  The general chains path is therefore
host-bound: a step of C chains costs C general steps' launches (the fused
engine ``FusedChainsADVI`` runs C chains in one launch per chunk).

The target is shared by the chains, not copied.  Chains differ in their
Philox seed words, ``chain_seed_words(seed, c)`` (the counterpart of
``jax.random.split(key, n_chains)``; chain c of ``optimize_chains`` is
``optimize`` keyed by those words, bit for bit) and, optionally, in their
initial parameters.  Outputs are families whose tensors carry a leading
chain axis.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from ..core.pytree import tree_leaves, tree_map
from ..ops.cuda.location_scale_kernels import chain_seed_words


def _state_axes(state):
    """The chain axis of each field of an algorithm state: 0 on everything
    except the shared target and the host iteration counter (the JAX
    package's vmap axis tree)."""
    kwargs = {}
    for f in dataclasses.fields(state):
        kwargs[f.name] = None if f.name in ("prob", "iteration") else 0
    return type(state)(**kwargs)


# Fields a chain jitter perturbs, in priority order: location-scale/low-rank
# families, mixtures (per-component locations), flows (base location).
_JITTER_FIELDS = ("location", "locations", "base_location")


def _jitter_field(q) -> str:
    for f in _JITTER_FIELDS:
        if hasattr(q, f):
            return f
    raise ValueError(
        f"jitter != 0 requires the family to expose one of {_JITTER_FIELDS}; "
        f"{type(q).__name__} has none — pass a pre-stacked q_init with "
        "stacked=True for custom per-chain initializations."
    )


def stack_families(qs):
    """One family whose tensors stack the chains' (leading chain axis)."""
    return tree_map(lambda *xs: torch.stack(xs), qs[0], *qs[1:])


def chain_slice(q, c: int):
    """Chain ``c`` of a stacked family."""
    return tree_map(lambda x: x[c], q)


@dataclass(frozen=True)
class ChainStates:
    """The states of K chains, one ``ParamSpaceSGDState`` each.  ``prob``
    is the one shared target; ``q`` stacks the chains' families."""

    chains: Tuple[Any, ...]

    @property
    def prob(self):
        return self.chains[0].prob

    @property
    def iteration(self) -> int:
        return self.chains[0].iteration

    @property
    def q(self):
        return stack_families([s.q for s in self.chains])


def _jitter(q, field: str, jitter: float, words: Tuple[int, int]):
    """q with ``jitter`` N(0, 1) noise on ``field``; the noise comes from a
    CPU ``torch.Generator`` keyed by the chain's seed words."""
    loc = getattr(q, field)
    g = torch.Generator().manual_seed((words[0] << 32) | words[1])
    noise = torch.randn(tuple(loc.shape), generator=g, dtype=loc.dtype).to(loc.device)
    return dataclasses.replace(q, **{field: loc + jitter * noise})


def init_chains(
    key,
    algorithm,
    q_init,
    prob,
    n_chains: int,
    jitter: float = 0.0,
    stacked: bool = False,
):
    """Initialize K chains: distinct Philox seed words
    (``chain_seed_words(key, c)``), optionally jittered inits.  Returns
    ``(states, axes)``.

    ``stacked=True`` declares ``q_init`` pre-stacked (every tensor leaf
    carries a leading chain axis of size ``n_chains``) for fully custom
    per-chain initializations.  ``jitter`` perturbs the family's location
    field (location-scale and low-rank families)."""
    words = [chain_seed_words(key, c) for c in range(n_chains)]
    if stacked:
        lead = {(x.shape[0] if x.ndim else None) for x in tree_leaves(q_init)}
        if lead != {n_chains}:
            raise ValueError(
                f"stacked q_init must have a leading chain axis of "
                f"{n_chains} on every leaf; got leading sizes "
                f"{sorted(lead, key=str)} (None = 0-d leaf, which cannot "
                "carry a chain axis)"
            )
        qs = [chain_slice(q_init, c) for c in range(n_chains)]
    else:
        loc = getattr(q_init, "location", None)
        if loc is not None and loc.ndim >= 2:
            raise ValueError(
                "q_init.location has a leading batch axis "
                f"{tuple(loc.shape)}; for pre-stacked per-chain initializations "
                "pass stacked=True."
            )
        if jitter != 0.0:
            field = _jitter_field(q_init)
            qs = [_jitter(q_init, field, jitter, w) for w in words]
        else:
            qs = [q_init] * n_chains
    states = ChainStates(tuple(algorithm.init(w, q, prob) for w, q in zip(words, qs)))
    return states, _state_axes(states.chains[0])


def _stack_infos(infos):
    out = {}
    for k in infos[0]:
        vals = [i[k] for i in infos]
        out[k] = torch.stack(vals) if isinstance(vals[0], torch.Tensor) else vals
    return out


def step_chains(algorithm, states: ChainStates, axes=None, noise=None):
    """One step of every chain, in turn; returns ``(states, info)`` with the
    info entries stacked over the chains.  ``noise``: optional base draws
    with a leading chain axis, row c replacing chain c's sampler (the
    ``noise=`` of ``algorithm.step``)."""
    if axes is not None and type(axes) is not type(states.chains[0]):
        raise ValueError(
            f"axes describe {type(axes).__name__}, the chains hold "
            f"{type(states.chains[0]).__name__}"
        )
    if noise is not None and noise.shape[0] != len(states.chains):
        raise ValueError(
            f"noise needs a leading chain axis of {len(states.chains)}, got "
            f"{tuple(noise.shape)}"
        )
    pairs = [algorithm.step(s, noise=None if noise is None else noise[c])
             for c, s in enumerate(states.chains)]
    return ChainStates(tuple(s for s, _ in pairs)), _stack_infos([i for _, i in pairs])


def optimize_chains(
    key,
    algorithm,
    max_iter: int,
    prob,
    q_init,
    n_chains: int,
    jitter: float = 0.0,
    stacked: bool = False,
    states=None,
    axes=None,
):
    """Run K independent optimizations; returns ``(outputs, final_infos,
    states, axes)``.  ``outputs`` is the family with a leading chain axis
    (the averaged parameters, as ``optimize``).  To pick the best chain,
    score with the negated objective (``estimate_objective`` returns the
    negative ELBO) and take ``best_chain``::

        scores = torch.stack([-estimate_objective(key, alg, chain_slice(outs, c), prob, n)
                              for c in range(n_chains)])
        q_best = best_chain(outs, scores)
    """
    if states is None:
        states, axes = init_chains(key, algorithm, q_init, prob, n_chains, jitter, stacked)
    info = {}
    for _ in range(max_iter):
        states, info = step_chains(algorithm, states, axes)
    outputs = stack_families([algorithm.output(s) for s in states.chains])
    return outputs, info, states, axes


def best_chain(outputs, scores):
    """The chain slice of ``outputs`` with the best (highest) score."""
    return chain_slice(outputs, int(torch.argmax(torch.as_tensor(scores))))
