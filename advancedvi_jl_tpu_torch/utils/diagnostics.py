"""Importance-weight reliability diagnostics, PSIS Pareto k-hat (port of
utils/diagnostics.py; the numpy part is the same code).

Companion to the IWELBO objective and to importance-reweighted evaluation of
any fitted q: the generalized-Pareto shape estimate k-hat of the largest
importance ratios (Vehtari, Simpson, Gelman, Yao & Gabry, "Pareto smoothed
importance sampling", JMLR 2024).  Interpretation:

    k-hat <= 0.5   excellent — IS/IWAE estimates converge fast
    0.5 < k < 0.7  usable — higher variance, still consistent
    k-hat >= 0.7   unreliable — q's tails are too light relative to pi;
                   refit with a heavier-tailed base (StudentT), a richer
                   family, or more expressive flows

For Gaussians the exact value is known (p = N(0,1), q = N(0,s^2) gives
k = 1 - s^2), which the tests pin.

Host-side numpy: a post-hoc diagnostic on a vector of log-weights, off the
training path.  ``importance_diagnostics`` draws its weights through the
family's sampler (K7b for a full-rank family on the card).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def pareto_khat(log_weights) -> float:
    """GPD shape k-hat of the upper tail of importance ratios.

    ``log_weights``: 1-D array of log(p(z)/q(z)) at draws z ~ q (any
    normalization constant cancels).  Uses the PSIS tail size
    M = min(0.2 S, 3 sqrt(S)) and the Zhang & Stephens (2009)
    profile-posterior estimator with the standard (M*k + 5*0.5)/(M+10)
    regularization toward 0.5.
    """
    logw = np.asarray(log_weights, dtype=np.float64).ravel()
    logw = logw[np.isfinite(logw)]
    S = logw.size
    if S < 16:
        raise ValueError(f"need >= 16 weights for a tail fit, got {S}")
    M = int(min(0.2 * S, 3.0 * np.sqrt(S)))
    logw = np.sort(logw)
    # tail exceedances over the threshold, in ratio space (max-normalized
    # for overflow safety; shifts cancel in exceedances)
    lw_tail = logw[S - M:]
    cutoff = logw[S - M - 1]
    x = np.exp(lw_tail - logw[-1]) - np.exp(cutoff - logw[-1])
    x = x[x > 0]
    if x.size < 5 or np.ptp(x) == 0.0:
        return -np.inf  # (near-)constant weights: no tail, k -> -inf
    n = x.size
    x = np.sort(x)

    # Zhang & Stephens profile "posterior" over theta = -xi/sigma
    m_grid = 30 + int(np.sqrt(n))
    j = np.arange(1, m_grid + 1, dtype=np.float64)
    x_star = x[int(n / 4.0 + 0.5) - 1]  # lower quartile
    theta = 1.0 / x[-1] + (1.0 - np.sqrt(m_grid / (j - 0.5))) / (
        3.0 * x_star
    )
    # GPD shape given theta: k(theta) = mean(log1p(-theta x)) (loo/arviz
    # sign convention: k > 0 = heavy tail); profile likelihood
    # l(theta) = n (log(-theta/k) - k - 1).
    k_theta = np.mean(np.log1p(-theta[:, None] * x[None, :]), axis=1)
    log_lik = n * (np.log(-theta / k_theta) - k_theta - 1.0)
    w = np.exp(log_lik - log_lik.max())
    w = w / w.sum()
    theta_hat = float(np.sum(theta * w))
    khat = float(np.mean(np.log1p(-theta_hat * x)))
    # regularization toward 0.5 (10 pseudo-observations), as in loo/arviz
    return (n * khat + 5.0 * 0.5) / (n + 10.0)


def importance_diagnostics(
    key,
    q: Any,
    prob: Any,
    n_samples: int = 2048,
    log_weights: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """k-hat and normalized effective sample size of q as an IS proposal.

    Either pass precomputed ``log_weights`` or (key, q, prob) to draw
    ``n_samples`` fresh ones (``key``: an int, two seed words or a
    ``PhiloxKey``).  ``ess`` is the self-normalized-IS effective sample size
    fraction 1 / (S * sum wn^2) in (0, 1].
    """
    if log_weights is None:
        with torch.no_grad():
            z = q.sample(key, n_samples)
            log_weights = (prob.log_density(z) - q.log_prob(z)).cpu().numpy()
    logw = np.asarray(log_weights, dtype=np.float64).ravel()
    logw = logw - logw.max()
    w = np.exp(logw)
    wn = w / w.sum()
    ess = float(1.0 / (wn.size * np.sum(wn**2)))
    return {"khat": pareto_khat(log_weights), "ess": ess}
