"""Pathfinder: quasi-Newton variational inference (port of
algorithms/pathfinder.py; Zhang et al., JMLR 2022).

Follow an L-BFGS trajectory toward the mode, build a Gaussian
N(theta_t, H_t) at every iterate from the curvature pairs (H_t the dense
BFGS inverse Hessian over a window of ``history`` pairs), score each with a
K-sample ELBO and return the argmax: a posterior approximation in tens of
gradient evaluations, and the warm start of ADVI and the measure-space
algorithms.

The trajectory is the port's own L-BFGS (``_lbfgs_trajectory``: the
two-loop recursion over 10 pairs, a strong-Wolfe line search with optax's
tolerances), one iteration a recorded iterate; it is not the JAX package's optax L-BFGS with
its zoom line search, so the iterates differ between the two packages.  Everything after it is the JAX package's, step for step
(``pathfinder_from_trajectory``): the windowed inverse Hessians of all T
iterates as one batch, the ridged Cholesky factors, and each iterate's
ELBO from K draws through the full-rank sampler (one K7b launch an iterate
on the card).  Multi-path Pathfinder pools draws from every path's q with
self-normalized importance weights over the mixture proposal, resamples
them (``torch.multinomial`` on a generator keyed by the seed words) and
reports the PSIS k-hat (utils/diagnostics.py).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from ..core.problem import dim_of, log_density_and_grad
from ..families.location_scale import FullRankGaussian
from ..ops.base_draws import generator
from ..ops.cuda.location_scale_kernels import PhiloxKey, SeedLike, chain_seed_words, seed_words
from ..utils.diagnostics import importance_diagnostics
from .measure_space import cholesky


class PathfinderResult(NamedTuple):
    q: Any  # FullRankGaussian at the ELBO-argmax iterate
    elbo: torch.Tensor  # its K-sample ELBO estimate
    best_iter: torch.Tensor  # the trajectory index selected
    elbos: torch.Tensor  # (T,) per-iterate ELBOs
    trajectory: torch.Tensor  # (T + 1, d) iterates


LBFGS_MEMORY = 10  # optax.lbfgs's default memory


def _lbfgs_direction(g: torch.Tensor, pairs) -> torch.Tensor:
    """-H g by the two-loop recursion over the (s, y) pairs, oldest first,
    with H0 = (s.y) / (y.y) I of the newest pair."""
    q, coefs = -g, []
    for s, y in reversed(pairs):
        rho = 1.0 / torch.dot(y, s)
        a = rho * torch.dot(s, q)
        q = q - a * y
        coefs.append((rho, a, s, y))
    s, y = pairs[-1]
    r = (torch.dot(s, y) / torch.dot(y, y)) * q
    for rho, a, s, y in reversed(coefs):
        r = r + (a - rho * torch.dot(y, r)) * s
    return r


def _line_search(f_and_g, theta, f, g, d, gtd, t):
    """A step size t along d that meets the strong Wolfe conditions with the
    approximate sufficient decrease of Hager and Zhang (2006) as optax's
    zoom line search takes them (slope 1e-4, curvature 0.9, value 1e-6): in
    float32 the exact decrease cannot be seen near the mode, where the
    quasi-Newton step is the most accurate.  Bisection inside a bracket,
    doubling before one; after 20 evaluations the longest step that met the
    decrease condition, else none.  Returns (t, f, g) or None."""
    lo, hi, best = 0.0, math.inf, None
    for _ in range(20):
        f_new, g_new = f_and_g(theta + t * d)
        slope = float(torch.dot(g_new, d))
        armijo = f_new <= f + 1e-4 * t * gtd
        approx = slope <= (2e-4 - 1.0) * gtd and f_new <= f + 1e-6 * abs(f)
        if not (math.isfinite(f_new) and (armijo or approx)):
            hi = t
        elif abs(slope) > 0.9 * abs(gtd):
            best = (t, f_new, g_new)
            if slope < 0.0:
                lo = t
            else:
                hi = t
        else:
            return t, f_new, g_new
        t = 0.5 * (lo + hi) if hi < math.inf else 2.0 * t
    return best


def _lbfgs_trajectory(prob, theta0: torch.Tensor, n_steps: int):
    """(thetas (T + 1, d), grads, logps) of L-BFGS on -log pi from theta0:
    the two-loop recursion over the last ``LBFGS_MEMORY`` curvature pairs,
    the first step scaled by min(1, 1 / ||g||) as optax does, then the line
    search above from the unit step.  A step whose line search finds no
    point (or that has no descent direction) ends the search: theta, the
    pairs and the direction stay as they were, so every later step would
    repeat the same failed search; the remaining iterates repeat theta."""

    def f_and_g(theta):
        logp, grad = log_density_and_grad(prob, theta)
        return -float(logp), -grad

    theta = theta0.detach()
    f, g = f_and_g(theta)
    thetas, pairs = [theta], []
    for _ in range(n_steps):
        if pairs:
            d = _lbfgs_direction(g, pairs)
        else:
            gnorm = float(torch.linalg.vector_norm(g))
            d = -(1.0 / gnorm if gnorm > 1.0 else 1.0) * g
        gtd = float(torch.dot(g, d))
        found = _line_search(f_and_g, theta, f, g, d, gtd, 1.0) if gtd < 0.0 else None
        if found is None:
            break
        t, f_new, g_new = found
        s, y = t * d, g_new - g
        if float(torch.dot(s, y)) > 0.0:
            pairs = (pairs + [(s, y)])[-LBFGS_MEMORY:]
        theta, f, g = theta + s, f_new, g_new
        thetas.append(theta)
    thetas = torch.stack(thetas + [theta] * (n_steps + 1 - len(thetas)))
    logps, grads = log_density_and_grad(prob, thetas)
    return thetas, grads, logps


def _inverse_hessian(s_win: torch.Tensor, y_win: torch.Tensor, valid: torch.Tensor):
    """Dense BFGS inverse Hessians from windows of curvature pairs, a batch
    of T: ``s_win``/``y_win`` (T, m, d) oldest first, ``valid`` (T, m) (False
    for padding; a pair with s.y <= 0 is skipped too, which keeps H PSD).
    H0 = gamma I with gamma = (s.y) / (y.y) of the newest usable pair."""
    T, m, d = s_win.shape
    sy = torch.sum(s_win * y_win, dim=-1)
    yy = torch.sum(y_win * y_win, dim=-1)
    ok = valid & (sy > 1e-12 * torch.clamp_min(yy, 1e-30))
    pos = torch.arange(m, device=s_win.device).expand(T, m)
    newest = torch.argmax(torch.where(ok, pos, -1), dim=-1, keepdim=True)
    gamma = torch.where(
        ok.any(dim=-1),
        (sy.gather(1, newest) / torch.clamp_min(yy.gather(1, newest), 1e-30))[:, 0],
        1.0,
    )
    H = gamma[:, None, None] * torch.eye(d, dtype=s_win.dtype, device=s_win.device)
    for j in range(m):
        s, y = s_win[:, j], y_win[:, j]
        rho = (1.0 / torch.clamp_min(sy[:, j], 1e-30))[:, None, None]
        Hy = (H @ y[:, :, None])[:, :, 0]
        yHy = torch.sum(y * Hy, dim=-1)[:, None, None]
        ss = s[:, :, None] * s[:, None, :]
        # BFGS: H' = (I - rho s y^T) H (I - rho y s^T) + rho s s^T
        H_new = (H - rho * (s[:, :, None] * Hy[:, None, :] + Hy[:, :, None] * s[:, None, :])
                 + (rho * rho * yHy + rho) * ss)
        H = torch.where(ok[:, j, None, None], H_new, H)
    return (H + H.transpose(1, 2)) / 2.0


@torch.no_grad()
def pathfinder_from_trajectory(seed: SeedLike, prob, thetas: torch.Tensor,
                               grads: torch.Tensor, history: int = 6,
                               n_elbo_samples: int = 32,
                               noise: Optional[torch.Tensor] = None) -> PathfinderResult:
    """Pathfinder after its trajectory: the (T + 1, d) iterates ``thetas``
    and the gradients of log pi there.  Iterate t (1..T) gets the inverse
    Hessian of the ``history`` pairs ending at it and the ELBO of K draws
    keyed by ``PhiloxKey(seed, t - 1)``; ``noise`` (T, K, d) replaces the
    draws (the parity tests inject the reference's)."""
    words = seed_words(seed)
    T, d = thetas.shape[0] - 1, thetas.shape[1]
    s_all = thetas[1:] - thetas[:-1]
    # grads are of log pi; BFGS runs on -log pi, so y_t = g_t - g_{t+1}
    y_all = grads[:-1] - grads[1:]
    starts = (torch.arange(T, device=thetas.device)[:, None] - history
              + torch.arange(history, device=thetas.device))
    idx = starts.clamp(0, T - 1)
    H = _inverse_hessian(s_all[idx], y_all[idx], starts >= 0)
    eye = torch.eye(d, dtype=H.dtype, device=H.device)
    C = cholesky(H + 1e-8 * eye)  # a tiny ridge for float32
    bad = torch.isnan(C).flatten(1).any(dim=1)
    C_safe = torch.where(bad[:, None, None], eye, C)
    mus = thetas[1:]
    if noise is None:
        zu = [FullRankGaussian(mus[t], C_safe[t]).sample_with_base(PhiloxKey(words, t),
                                                                   n_elbo_samples)
              for t in range(T)]
        z, u = torch.stack([a for a, _ in zu]), torch.stack([b for _, b in zu])
    else:
        u = noise.to(device=mus.device, dtype=mus.dtype)
        z = u @ C_safe.transpose(1, 2) + mus[:, None, :]
    logq = (-0.5 * torch.sum(u * u, dim=-1) - 0.5 * d * math.log(2.0 * math.pi)
            - torch.sum(torch.log(torch.abs(torch.diagonal(C_safe, dim1=1, dim2=2))),
                        dim=-1)[:, None])
    elbos = torch.mean(prob.log_density(z) - logq, dim=-1)
    elbos = torch.where(bad | ~torch.isfinite(elbos), -math.inf, elbos)
    best = torch.argmax(elbos)
    return PathfinderResult(q=FullRankGaussian(mus[best], C[best]), elbo=elbos[best],
                            best_iter=best + 1, elbos=elbos, trajectory=thetas)


def pathfinder(seed: SeedLike, prob, theta0: Optional[torch.Tensor] = None,
               n_steps: int = 30, history: int = 6, n_elbo_samples: int = 32,
               jitter: float = 2.0, device="cuda") -> PathfinderResult:
    """Single-path Pathfinder; returns the ELBO-argmax Gaussian.

    ``theta0``: the start (default: uniform in [-jitter, jitter]^d on
    ``device``, drawn from the seed).  The budget is ``n_steps`` L-BFGS
    iterations (plus line-search probes)."""
    words = seed_words(seed)
    if theta0 is None:
        g = generator(chain_seed_words(words, 0), device)
        theta0 = jitter * (2.0 * torch.rand(dim_of(prob), generator=g, device=device) - 1.0)
    thetas, grads, _ = _lbfgs_trajectory(prob, theta0, n_steps)
    return pathfinder_from_trajectory(chain_seed_words(words, 1), prob, thetas, grads,
                                      history, n_elbo_samples)


@torch.no_grad()
def multipath_pathfinder(seed: SeedLike, prob, n_paths: int = 8, n_draws: int = 1000,
                         **kwargs):
    """Multi-path Pathfinder: ``n_paths`` paths from jittered starts, their
    draws pooled with self-normalized importance weights over the mixture
    proposal (the paper's PS-IS step), and the PSIS k-hat.

    Returns ``(draws, diagnostics, results)``: (n_draws, d) resampled
    draws, {"khat", "ess"}, and the list of each path's PathfinderResult.
    """
    words = seed_words(seed)
    results = [pathfinder(chain_seed_words(words, p), prob, **kwargs)
               for p in range(n_paths)]
    draw_words = chain_seed_words(words, n_paths)
    per_path = max(1, (2 * n_draws) // n_paths)
    z_all = torch.cat([r.q.sample(PhiloxKey(draw_words, p), per_path)
                       for p, r in enumerate(results)])
    logq_mix = (torch.logsumexp(torch.stack([r.q.log_prob(z_all) for r in results]), dim=0)
                - math.log(float(n_paths)))
    logw = prob.log_density(z_all) - logq_mix
    diag = importance_diagnostics(None, None, None, log_weights=logw.cpu().numpy())
    g = generator(chain_seed_words(words, n_paths + 1), z_all.device)
    idx = torch.multinomial(torch.softmax(logw, dim=0), n_draws, replacement=True,
                            generator=g)
    return z_all[idx], diag, results
