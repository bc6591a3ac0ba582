"""Module-level ``estimate_objective`` (port of estimate.py).

The reference exposes ``estimate_objective([rng,] alg_or_obj, q, prob;
n_samples)`` as one function dispatched per algorithm or objective
(reference: src/algorithms/common.jl:29-38); here every algorithm and
objective carries an ``estimate_objective`` method and this function is
the uniform entry point.
"""

from __future__ import annotations

from typing import Any, Optional


def estimate_objective(key, alg_or_objective: Any, q: Any, prob: Any,
                       n_samples: Optional[int] = None):
    """Estimate the algorithm's monitoring objective (the negative ELBO for
    the KL minimizers).  ``key``: an int, two seed words or a ``PhiloxKey``."""
    return alg_or_objective.estimate_objective(key, q, prob, n_samples)
