"""Measure-space / natural-gradient VI algorithms (port of
algorithms/measure_space.py).

- KLMinNaturalGradDescent (variational online Newton in precision space;
  reference klminnaturalgraddescent.jl:45-191)
- KLMinSqrtNaturalGradDescent (natural gradient in the Cholesky factor;
  reference klminsqrtnaturalgraddescent.jl:39-165)
- KLMinWassFwdBwd (Wasserstein forward-backward; reference
  klminwassfwdbwd.jl:39-160)
- FisherMinBatchMatch (batch-and-match for the covariance-weighted Fisher
  divergence; reference fisherminbatchmatch.jl:40-195)

Each step is one full-rank draw (K7b on the card) and a handful of (d, d)
operations run eagerly.  The iteration counter and the Philox seed words are
host integers in the state: the draw of step ``it`` is keyed by
``PhiloxKey(seed, it)``, the reference's ``fold_in(state.key, it)``, so
chunked and resumed runs repeat an uninterrupted one bitwise.  A Cholesky
factor of a matrix that is not positive definite is NaN (``cholesky``
below), as in the JAX package, with no host sync: the step's ELBO turns
non-finite and ``optimize`` names the step.  The scalar schedule terms are
rounded in float32 as the JAX package computes them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core.problem import log_density_and_grad, subsample
from ..families.base import Normal
from ..families.location_scale import FullRankLocationScale
from ..objectives.entropy import MONTE_CARLO
from ..objectives.repgradelbo import RepGradELBO, draw_with_base
from ..objectives.subsampled import SubsampledObjective
from ..ops.cuda.location_scale_kernels import PhiloxKey, SeedLike, seed_words
from ..ops.sqrtm import _symmetrize, sqrtm_newton_schulz
from .gauss_expected import (
    check_capability_at_least_grad,
    check_mc_axis,
    gaussian_expected_grad_hess,
)


@dataclass(frozen=True)
class MeasureSpaceState:
    """q, the target, the algorithm's auxiliary tensor (NGD's precision,
    Wass's covariance, else ()), the schedule state and the seed words."""

    q: FullRankLocationScale
    prob: Any
    aux: Any
    iteration: int
    sub_state: Any
    seed: Tuple[int, int]


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (a batch of) A, NaN where A is not positive
    definite (``cholesky_ex`` checks nothing on the host), row-major as the
    sampler kernel reads a scale (LAPACK's factor is column-major)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, float("nan")).contiguous()


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^{-1} B from A's lower Cholesky factor L: two triangular solves."""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.T, Y, upper=True)


def _check_q(q, alg_name: str) -> None:
    if not isinstance(q, FullRankLocationScale) or not isinstance(q.base, Normal):
        raise ValueError(
            f"{alg_name} requires a FullRankGaussian variational family "
            "(reference requirement)."
        )


class MeasureSpaceAlgorithm:
    """Shared init/step/output skeleton of the algorithms above.

    ``hessian``: "auto", "stein" or "exact" (gauss_expected.py).
    ``mc_axis`` (the samples over a device mesh) is not ported.
    """

    name = "MeasureSpaceAlgorithm"

    def __init__(self, n_samples=1, subsampling=None, mc_axis=None, hessian="auto"):
        check_mc_axis(mc_axis)
        self.n_samples = n_samples
        self.subsampling = subsampling
        self.mc_axis = mc_axis
        self.hessian = hessian

    def _init_aux(self, q: FullRankLocationScale):
        return ()

    def _update(self, q, aux, grad, hess, iteration):
        raise NotImplementedError

    def init(self, seed: SeedLike, q_init, prob) -> MeasureSpaceState:
        """``seed``: an int, a ``torch.Generator`` or two seed words."""
        _check_q(q_init, self.name)
        check_capability_at_least_grad(prob, self.name)
        words = seed_words(seed)
        sub_state = (self.subsampling.init(words, device=q_init.location.device)
                     if self.subsampling is not None else ())
        return MeasureSpaceState(q=q_init, prob=prob, aux=self._init_aux(q_init),
                                 iteration=0, sub_state=sub_state, seed=words)

    def _advance_subsampling(self, state: MeasureSpaceState):
        """(target for this step, new schedule state, schedule info)."""
        if self.subsampling is None:
            return state.prob, state.sub_state, {}
        batch, sub_state, sub_info = self.subsampling.step(state.sub_state)
        return subsample(state.prob, batch), sub_state, dict(sub_info)

    @torch.no_grad()
    def step(self, state: MeasureSpaceState, noise: Optional[torch.Tensor] = None):
        """One step.  ``noise``: optional (n_samples, d) base draws in place
        of the sampler (the parity tests inject the reference's draws)."""
        it = state.iteration + 1
        prob_sub, sub_state, info = self._advance_subsampling(state)
        logpi_avg, grad, hess = gaussian_expected_grad_hess(
            PhiloxKey(state.seed, state.iteration), state.q, self.n_samples, prob_sub,
            hessian=self.hessian, noise=noise,
        )
        q_new, aux_new = self._update(state.q, state.aux, grad, hess, it)
        # elbo = E[log pi] + H(q') (BaM logs H(q) itself, as the reference)
        info["elbo"] = logpi_avg + q_new.entropy()
        info["diverged"] = ~torch.isfinite(info["elbo"])
        return dataclasses.replace(state, q=q_new, aux=aux_new, iteration=it,
                                   sub_state=sub_state), info

    def output(self, state: MeasureSpaceState):
        return state.q

    def estimate_objective(self, key: SeedLike, q, prob, n_samples: Optional[int] = None,
                           entropy: str = MONTE_CARLO):
        """-ELBO by RepGrad with the Monte-Carlo entropy; a full epoch of
        batches under subsampling (reference
        klminnaturalgraddescent.jl:172-191)."""
        n = n_samples if n_samples is not None else self.n_samples
        obj = RepGradELBO(n_samples=n, entropy=entropy)
        if self.subsampling is None:
            return obj.estimate_objective(key, q, prob)
        return SubsampledObjective(objective=obj, subsampling=self.subsampling
                                   ).estimate_objective(key, q, prob)


class KLMinNaturalGradDescent(MeasureSpaceAlgorithm):
    """Variational online Newton in precision space (Khan & Lin 2017):
    S' = S - eta (S + H) [+ eta^2/2 G Sigma G, the posdef correction of Lin
    et al. ICML 2020]; m' = m + eta S'^-1 g (reference
    klminnaturalgraddescent.jl:95-153)."""

    name = "KLMinNaturalGradDescent"

    def __init__(self, stepsize: float, n_samples: int = 1, ensure_posdef: bool = True,
                 subsampling=None, mc_axis=None, hessian: str = "auto"):
        super().__init__(n_samples=n_samples, subsampling=subsampling, mc_axis=mc_axis,
                         hessian=hessian)
        self.stepsize = stepsize
        self.ensure_posdef = ensure_posdef

    def _init_aux(self, q):
        # the precision S = C^-T C^-1 (reference :72-90)
        C = q.tril_scale()
        eye = torch.eye(C.shape[0], dtype=C.dtype, device=C.device)
        Cinv = torch.linalg.solve_triangular(C, eye, upper=False)
        return _symmetrize(Cinv.T @ Cinv)

    def _update(self, q, S, grad, hess, iteration):
        eta = np.float32(self.stepsize)
        if self.ensure_posdef:
            # G_hat = S + H;  S' = S - eta G_hat + eta^2/2 G_hat Sigma G_hat
            G_hat = S + hess
            S_new = _symmetrize(S - float(eta) * G_hat
                                + float(eta * eta / np.float32(2)) * (G_hat @ q.cov() @ G_hat))
        else:
            S_new = _symmetrize(float(np.float32(1) - eta) * S - float(eta) * hess)
        L = cholesky(S_new)
        m_new = q.location + float(eta) * cho_solve(L, grad[:, None])[:, 0]
        eye = torch.eye(S_new.shape[0], dtype=S_new.dtype, device=S_new.device)
        scale_new = cholesky(_symmetrize(cho_solve(L, eye)))
        return dataclasses.replace(q, location=m_new, scale=scale_new), S_new


class KLMinSqrtNaturalGradDescent(MeasureSpaceAlgorithm):
    """Natural-gradient flow in the Cholesky factor: C' = C - eta C
    tril_half(C^T (-H) C - I), m' = m + eta C C^T g (reference
    klminsqrtnaturalgraddescent.jl:79-127).  No Cholesky a step."""

    name = "KLMinSqrtNaturalGradDescent"

    def __init__(self, stepsize: float, n_samples: int = 1, subsampling=None,
                 mc_axis=None, hessian: str = "auto"):
        super().__init__(n_samples=n_samples, subsampling=subsampling, mc_axis=mc_axis,
                         hessian=hessian)
        self.stepsize = stepsize

    def _update(self, q, aux, grad, hess, iteration):
        eta = float(np.float32(self.stepsize))
        C = q.tril_scale()
        M = C.T @ (-hess) @ C - torch.eye(C.shape[0], dtype=C.dtype, device=C.device)
        M_tril = torch.tril(M) - torch.diag(torch.diagonal(M)) / 2.0
        m_new = q.location + eta * (C @ (C.T @ grad))
        C_new = C - eta * (C @ M_tril)
        return dataclasses.replace(q, location=m_new, scale=C_new), aux


class KLMinWassFwdBwd(MeasureSpaceAlgorithm):
    """Wasserstein proximal gradient (JKO forward-backward, Diao et al. 2023):
    m' = m + eta g; Sigma_half = M Sigma M^T with M = I + eta H^T; then the
    closed-form prox Sigma' = (Sigma_half + 2 eta I + sqrtm(Sigma_half
    (Sigma_half + 4 eta I))) / 2 (reference klminwassfwdbwd.jl:80-122).

    ``sqrtm="eigh"``: one symmetric eigendecomposition with the eigenvalue
    map lam' = (lam + 2 eta + sqrt(lam (lam + 4 eta))) / 2 (the two factors
    commute); ``"newton_schulz"``: ``sqrtm_iters`` Newton-Schulz steps of
    (d, d) products for sqrtm(Sigma_half^2 + 4 eta Sigma_half).
    """

    name = "KLMinWassFwdBwd"

    def __init__(self, stepsize: float, n_samples: int = 1, subsampling=None,
                 sqrtm: str = "eigh", sqrtm_iters: int = 20, mc_axis=None,
                 hessian: str = "auto"):
        super().__init__(n_samples=n_samples, subsampling=subsampling, mc_axis=mc_axis,
                         hessian=hessian)
        self.stepsize = stepsize
        if sqrtm not in ("eigh", "newton_schulz"):
            raise ValueError(
                f"sqrtm must be 'eigh' or 'newton_schulz', got {sqrtm!r}"
            )
        self.sqrtm = sqrtm
        # 20 suits a well-conditioned sigma; spectra spanning more than ~1e4
        # need more (the small eigenvalues converge linearly at first)
        self.sqrtm_iters = sqrtm_iters

    def _init_aux(self, q):
        return q.cov()

    def _update(self, q, sigma, grad, hess, iteration):
        eta = np.float32(self.stepsize)
        two_eta, four_eta = float(np.float32(2) * eta), float(np.float32(4) * eta)
        eye = torch.eye(q.dim, dtype=sigma.dtype, device=sigma.device)
        m_new = q.location + float(eta) * grad
        M = eye + float(eta) * hess.T
        sigma_half = _symmetrize(M @ sigma @ M.T)
        if self.sqrtm == "newton_schulz":
            S = sqrtm_newton_schulz(
                _symmetrize(sigma_half @ sigma_half + four_eta * sigma_half),
                n_iter=self.sqrtm_iters,
            )
            sigma_new = _symmetrize((sigma_half + two_eta * eye + S) / 2.0)
        else:
            lam, V = torch.linalg.eigh(sigma_half)
            lam = torch.clamp_min(lam, 0.0)
            lam_new = (lam + two_eta + torch.sqrt(lam * (lam + four_eta))) / 2.0
            sigma_new = _symmetrize((V * lam_new) @ V.T)
        return dataclasses.replace(q, location=m_new, scale=cholesky(sigma_new)), sigma_new


class FisherMinBatchMatch(MeasureSpaceAlgorithm):
    """Batch-and-match: proximal point for the covariance-weighted Fisher
    divergence, schedule lam_t = d n / t (reference
    fisherminbatchmatch.jl:40-195).

    The backward map Sigma' = 2 V (I + sqrt(I + 4 U V))^-1 is taken in
    factored form: for any V = F F^T, Sigma' = 2 F (I + sqrt(I + 4 F^T U
    F))^-1 F^T.  U = G G^T and the increment of V = C C^T + E E^T are of
    rank n + 1, so each matrix function is a thin SVD of a (d, n + 1) matrix
    (``torch.linalg.svd(..., full_matrices=False)``, cuSOLVER on the card),
    with the null directions exact.  The dense form's lam^2-sized
    intermediates lose the small eigenvalues in float32 (the JAX package's
    measurement: sigma's least eigenvalue fell ~10x a step at d = 256,
    n = 32 until the Cholesky failed).  Every formula is P f(s) P^T, so the
    singular vectors' signs do not matter.
    """

    name = "FisherMinBatchMatch"

    def __init__(self, n_samples: int = 32, subsampling=None, mc_axis=None):
        if n_samples < 2:
            raise ValueError(
                "FisherMinBatchMatch needs n_samples >= 2: its update uses "
                "CENTERED sample moments (the lam/(n-1) weighting divides by "
                f"zero for n_samples={n_samples})."
            )
        super().__init__(n_samples=n_samples, subsampling=subsampling, mc_axis=mc_axis)

    @torch.no_grad()
    def step(self, state: MeasureSpaceState, noise: Optional[torch.Tensor] = None):
        # BaM needs the per-sample gradients with their draws, so it takes
        # its own (u, z) pairs (reference rand_batch_match_samples_with_objective!,
        # :101-129)
        it = state.iteration + 1
        q = state.q
        n, d = self.n_samples, q.dim
        prob_sub, sub_state, info = self._advance_subsampling(state)
        mu = q.location
        C = q.tril_scale()
        z, u = draw_with_base(q, PhiloxKey(state.seed, state.iteration), n, noise)
        logpi, grads = log_density_and_grad(prob_sub, z)
        # F = E || -u - C^T grad ||^2 (reference :101-110)
        fisher = torch.sum(torch.square(-u - grads @ C)) / n
        zbar = torch.mean(z, dim=0)
        gbar = torch.mean(grads, dim=0)
        zc, gc = z - zbar, grads - gbar

        lam = np.float32(d * n) / np.float32(it)
        w = lam / (np.float32(1) + lam)
        sl, sw = float(np.sqrt(lam / np.float32(n - 1))), float(np.sqrt(w))
        # U = G G^T, V = C C^T + E E^T: (d, n + 1) factors
        G = torch.cat([sl * gc, sw * gbar[None, :]], dim=0).T
        E = torch.cat([sl * zc, sw * (mu - zbar)[None, :]], dim=0).T
        # V = F F^T with F = C (I + P1 (sqrt(1 + s1^2) - 1) P1^T), C^-1 E = P1 s1 Q1^T
        Et = torch.linalg.solve_triangular(C, E, upper=False)
        P1, s1, _ = torch.linalg.svd(Et, full_matrices=False)
        F = C + (C @ P1) * (torch.sqrt(1.0 + torch.square(s1)) - 1.0) @ P1.T
        # M^{1/2} = I - P2 (1 - sqrt(2 / (1 + r2))) P2^T with F^T G = P2 s2 Q2^T,
        # r2 = sqrt(1 + 4 s2^2)
        P2, s2, _ = torch.linalg.svd(F.T @ G, full_matrices=False)
        r2 = torch.sqrt(1.0 + 4.0 * torch.square(s2))
        F_new = F - (F @ P2) * (1.0 - torch.sqrt(2.0 / (1.0 + r2))) @ P2.T
        mu_new = (mu + float(lam) * (F_new @ (F_new.T @ gbar) + zbar)) / float(np.float32(1) + lam)
        q_new = dataclasses.replace(q, location=mu_new,
                                    scale=cholesky(_symmetrize(F_new @ F_new.T)))
        # BaM logs the entropy of the pre-update q (reference :157)
        info["elbo"] = torch.mean(logpi) + q.entropy()
        info["covweighted_fisher"] = fisher
        info["diverged"] = ~torch.isfinite(info["elbo"])
        return dataclasses.replace(state, q=q_new, iteration=it, sub_state=sub_state), info

    @torch.no_grad()
    def estimate_objective(self, key: SeedLike, q, prob, n_samples: Optional[int] = None):
        """Covariance-weighted Fisher divergence estimate (reference
        fisherminbatchmatch.jl:186-195)."""
        n = n_samples if n_samples is not None else self.n_samples
        z, u = q.sample_with_base(key, n)
        _, grads = log_density_and_grad(prob, z)
        return torch.sum(torch.square(-u - grads @ q.tril_scale())) / n
