"""Carry weights, states and noise between the JAX package and the port.

Works on numpy arrays (anything ``np.asarray`` accepts, so JAX arrays pass
through too) and imports no JAX.  The JAX fused engine keeps its state and
its injected noise in TPU lane/sublane padding; the port keeps ``(d,)`` and
``(d, d)`` tensors and ``(steps, n_samples, d)`` noise.  The padding widths are the JAX
package's ``d_pad_for`` and ``n_pad_for`` (ops/pallas/fused_advi.py), restated
here so the port never imports it; a test pins the two against each other.
The JAX chains engine pads the chain axis to ``c_pad_for(C)`` rows and keeps a
step's draws as (n_samples * c_pad, d_pad) rows, row ``s * c_pad + c`` for
sample s of chain c; the port keeps ``(C, d)`` state rows and ``(steps, C,
n_samples, d)`` noise.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .algorithms.measure_space import MeasureSpaceState
from .algorithms.pathfinder import PathfinderResult, pathfinder_from_trajectory
from .families.location_scale import (
    FullRankGaussian,
    FullRankLocationScale,
    MeanFieldGaussian,
    MeanFieldLocationScale,
)
from .families.low_rank import LowRankGaussian, LowRankLocationScale
from .models.bnn import BayesianMLP
from .models.logreg import LogReg
from .models.normal import NormalTarget
from .models.normallognormal import NormalLogNormal
from .models.subsampled_normals import SubsampledNormals
from .ops.cuda.fused_advi import (
    FR_MAT_FIELDS,
    LOGREG_MB,
    MINIBATCH_MODELS,
    STATE_FIELDS,
    FusedADVIState,
    FusedModelSpec,
)
from .ops.cuda.fused_chains import FusedChainsState
from .ops.cuda.location_scale_kernels import seed_words
from .subsampling import ReshufflingState

D_PAD = 128  # JAX fused engine: lane padding unit
N_PAD = 16   # JAX fused engine: minimum sample-row padding


def d_pad_for(d: int) -> int:
    """The JAX fused engine's lane padding of a d-dimensional model."""
    return max(D_PAD, -(-d // D_PAD) * D_PAD)


def n_pad_for(n: int) -> int:
    """The JAX fused engine's row padding of n samples per step."""
    return max(N_PAD, -(-n // 8) * 8)


def c_pad_for(n_chains: int) -> int:
    """The JAX chains engine's chain-axis padding (a multiple of 8)."""
    return -(-n_chains // 8) * 8


def to_tensor(a: Any, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """A float32 tensor copy of an array-like, on ``device`` (the card unless
    the caller asks for the CPU)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def logreg_from_numpy(X, y, likeadj=1.0, prior_scale: float = 3.0,
                      device="cuda") -> LogReg:
    """The port's LogReg from a JAX LogReg's ``X, y, likeadj, prior_scale``."""
    return LogReg(
        X=to_tensor(X, device), y=to_tensor(y, device),
        likeadj=to_tensor(likeadj, device), prior_scale=float(prior_scale),
    )


def meanfield_from_numpy(location, scale_diag, device="cuda") -> MeanFieldLocationScale:
    """The port's MeanFieldGaussian from a JAX one's ``location, scale_diag``."""
    return MeanFieldGaussian(to_tensor(location, device), to_tensor(scale_diag, device))


def fullrank_from_numpy(location, scale, solve_mode: str = "solve",
                        device="cuda") -> FullRankLocationScale:
    """The port's FullRankGaussian from a JAX one's ``location, scale``."""
    return FullRankGaussian(to_tensor(location, device), to_tensor(scale, device),
                            solve_mode=solve_mode)


def lowrank_from_numpy(location, scale_diag, scale_factors,
                       device="cuda") -> LowRankLocationScale:
    """The port's LowRankGaussian from a JAX one's ``location, scale_diag,
    scale_factors``."""
    return LowRankGaussian(to_tensor(location, device), to_tensor(scale_diag, device),
                           to_tensor(scale_factors, device))


def normal_target_from_numpy(mu, scale_tril, inv_scale_tril=None,
                             device="cuda") -> NormalTarget:
    """The port's NormalTarget from a JAX one's ``mu, scale_tril`` (and
    ``inv_scale_tril`` of a ``solve_free`` target)."""
    return NormalTarget(
        mu=to_tensor(mu, device), scale_tril=to_tensor(scale_tril, device),
        inv_scale_tril=None if inv_scale_tril is None else to_tensor(inv_scale_tril, device),
    )


def normallognormal_from_numpy(mu_y, sigma_y, mu_x, sigma_x,
                               device="cuda") -> NormalLogNormal:
    """The port's NormalLogNormal from a JAX one's ``mu_y, sigma_y, mu_x,
    sigma_x``."""
    return NormalLogNormal(mu_y=to_tensor(mu_y, device), sigma_y=to_tensor(sigma_y, device),
                           mu_x=to_tensor(mu_x, device), sigma_x=to_tensor(sigma_x, device))


def fused_state_from_numpy(jax_state: Any, d: int, device="cuda") -> FusedADVIState:
    """The port's FusedADVIState from a JAX ``FusedADVIState`` (any object
    with its field names), stripping the padding: the first row and the
    first ``d`` lanes of each ``(1, d_pad)`` field, and the leading
    ``(d, d)`` block of each ``(d_pad, d_pad)`` full-rank scale field (its
    padded diagonal, 1.0 in the JAX engine, is dropped).  COCOB's ``ext``
    rows come across the same way (three location-shaped, then three
    scale-shaped); DoWG's and DoG's [v, r] sit in lanes 0 and 1 of
    ``v_mu``, so they need d >= 2, as the port's engine does."""
    full_rank = np.asarray(jax_state.sig).shape[0] > 1

    def strip(a, scale_shaped):
        a = np.asarray(a)
        return a[:d, :d] if full_rank and scale_shaped else a[0, :d]

    rows = {f: to_tensor(strip(getattr(jax_state, f), f in FR_MAT_FIELDS), device)
            for f in STATE_FIELDS}
    if d < 2 and np.any(np.asarray(jax_state.v_mu)[0, 1:2] != 0.0):
        raise ValueError("a DoWG/DoG state keeps r in lane 1 of v_mu: it needs d >= 2")
    ext = getattr(jax_state, "ext", None)
    if ext is not None:
        ext = tuple(to_tensor(strip(a, k >= 3), device) for k, a in enumerate(ext))
    return FusedADVIState(
        **rows, iteration=int(np.asarray(jax_state.iteration)),
        elbo=to_tensor(jax_state.elbo, device), ext=ext,
    )


def pack_noise(noise, n_pad: Optional[int] = None,
               d_pad: Optional[int] = None) -> np.ndarray:
    """The port's ``(steps, n_samples, d)`` base draws in the JAX fused
    engine's ``(steps * n_pad, d_pad)`` layout (zero padding)."""
    noise = np.asarray(noise, dtype=np.float32)
    steps, n, d = noise.shape
    n_pad = n_pad_for(n) if n_pad is None else n_pad
    d_pad = d_pad_for(d) if d_pad is None else d_pad
    out = np.zeros((steps, n_pad, d_pad), np.float32)
    out[:, :n, :d] = noise
    return out.reshape(steps * n_pad, d_pad)


def bnn_from_numpy(X, y, likeadj=1.0, hidden: int = 32, noise_scale: float = 0.1,
                   device="cuda") -> BayesianMLP:
    """The port's BayesianMLP from a JAX one's ``X, y, likeadj, hidden,
    noise_scale``."""
    return BayesianMLP(X=to_tensor(X, device), y=to_tensor(y, device),
                       likeadj=to_tensor(likeadj, device), hidden=int(hidden),
                       noise_scale=float(noise_scale))


def subsampled_normals_from_numpy(mus, likeadj=1.0, device="cuda") -> SubsampledNormals:
    """The port's SubsampledNormals from a JAX one's ``mus, likeadj``."""
    return SubsampledNormals(mus=to_tensor(mus, device), likeadj=to_tensor(likeadj, device))


def reshuffling_state_from_numpy(perm, epoch: int, step: int, seed=(0, 0),
                                 device="cuda") -> ReshufflingState:
    """A ``ReshufflingState`` on a given (truncated) permutation, e.g. a JAX
    schedule's ``perm``, at 1-based ``epoch`` and 0-based ``step``."""
    perm = torch.tensor(np.asarray(perm), dtype=torch.int64, device=device)
    return ReshufflingState(perm=perm, epoch=int(epoch), step=int(step),
                            seed=(int(seed[0]), int(seed[1])))


def minibatch_spec_from_numpy(X_perm, yX, n_data: int, batch_size: int,
                              prior_scale: float = 3.0, transport: str = LOGREG_MB,
                              device="cuda", db: Optional[int] = None) -> FusedModelSpec:
    """A minibatch fused spec from packed consts: the permuted design and the
    per-batch label sums, e.g. a JAX minibatch spec's ``consts`` (their lane
    and row padding is cut to ``db`` features, default all columns, and
    n_data // batch_size batches).  ``transport``: one of MINIBATCH_MODELS.
    The spec has no ``reshuffle`` (it does not hold the unpermuted data)."""
    if transport not in MINIBATCH_MODELS:
        raise ValueError(f"transport must be one of {MINIBATCH_MODELS}, got {transport!r}")
    X_perm = np.asarray(X_perm, dtype=np.float32)
    db = X_perm.shape[1] if db is None else int(db)
    nb = n_data // batch_size
    return FusedModelSpec(
        dim=db + 1,
        consts=(to_tensor(X_perm[: nb * batch_size, :db], device),
                to_tensor(np.asarray(yX, dtype=np.float32)[:nb, :db], device)),
        scalars=(n_data / batch_size, float(prior_scale)), model=transport,
    )


def chains_state_from_numpy(jax_state: Any, n_chains: int, d: int,
                            device="cuda") -> FusedChainsState:
    """The port's FusedChainsState from a JAX ``FusedChainsState`` (any
    object with its field names), stripping the padding: the first
    ``n_chains`` rows and ``d`` lanes of each ``(c_pad, d_pad)`` field and of
    COCOB's ext fields, and the first ``n_chains`` entries of ``elbo``."""
    rows = {f: to_tensor(np.asarray(getattr(jax_state, f))[:n_chains, :d], device)
            for f in STATE_FIELDS}
    ext = getattr(jax_state, "ext", None)
    if ext is not None:
        ext = tuple(to_tensor(np.asarray(a)[:n_chains, :d], device) for a in ext)
    return FusedChainsState(
        **rows, iteration=int(np.asarray(jax_state.iteration)),
        elbo=to_tensor(np.asarray(jax_state.elbo)[:n_chains], device), ext=ext,
    )


def chains_state_to_numpy(state: FusedChainsState, optimizer="adam",
                          c_pad: Optional[int] = None, d_pad: Optional[int] = None) -> dict:
    """A port FusedChainsState in the JAX engine's padded layout, as a dict of
    numpy arrays under the JAX field names (``FusedChainsState(**out)``
    rebuilds it).  The padding is what the JAX engine's ``init`` writes:
    1.0 in ``sig`` and ``avg_sig``, and in ``m_sig`` for chains whose
    ``optimizer`` (one rule name, or one per chain) keeps x0 or x1 there
    (DoWG, DoG, COCOB); 0 elsewhere, padded chains included."""
    C, d = state.mu.shape
    c_pad = c_pad_for(C) if c_pad is None else c_pad
    d_pad = d_pad_for(d) if d_pad is None else d_pad
    rules = [optimizer] * C if isinstance(optimizer, str) else list(optimizer)
    copies = np.array([r in ("dowg", "dog", "cocob") for r in rules])

    def pad(t, fill_real, fill_pad_rows):
        a = np.zeros((c_pad, d_pad), np.float32)
        a[:C] = fill_real[:, None] if isinstance(fill_real, np.ndarray) else fill_real
        a[C:] = fill_pad_rows
        a[:C, :d] = t.detach().cpu().numpy()
        return a

    out = {}
    for f in STATE_FIELDS:
        if f in ("sig", "avg_sig"):
            out[f] = pad(getattr(state, f), 1.0, 1.0)
        elif f == "m_sig":
            out[f] = pad(state.m_sig, copies.astype(np.float32), 0.0)
        else:
            out[f] = pad(getattr(state, f), 0.0, 0.0)
    out["iteration"] = np.int32(state.iteration)
    elbo = np.zeros(c_pad, np.float32)
    elbo[:C] = state.elbo.detach().cpu().numpy()
    out["elbo"] = elbo
    out["ext"] = (None if state.ext is None
                  else tuple(pad(a, 0.0, 0.0) for a in state.ext))
    return out


def pack_chains_noise(noise, c_pad: Optional[int] = None,
                      d_pad: Optional[int] = None) -> np.ndarray:
    """The port's ``(steps, C, n_samples, d)`` chain draws in the JAX chains
    engine's ``(steps * n_samples * c_pad, d_pad)`` layout: step t, sample s
    of chain c on row ``t * R + s * c_pad + c``, R = n_samples * c_pad (zero
    padding)."""
    noise = np.asarray(noise, dtype=np.float32)
    steps, C, n, d = noise.shape
    c_pad = c_pad_for(C) if c_pad is None else c_pad
    d_pad = d_pad_for(d) if d_pad is None else d_pad
    out = np.zeros((steps, n, c_pad, d_pad), np.float32)
    out[:, :, :C, :d] = noise.transpose(0, 2, 1, 3)
    return out.reshape(steps * n * c_pad, d_pad)


def measure_space_state_from_numpy(jax_state: Any, prob, seed=(0, 0),
                                   device="cuda") -> MeasureSpaceState:
    """The port's MeasureSpaceState from a JAX one (any object with its field
    names): q's ``location`` and ``scale``, ``aux`` (NGD's precision, Wass's
    covariance; () for the others), the iteration and the schedule's
    permutation, epoch and step.  ``prob`` is the port's target.  The JAX
    key does not carry over: the port's draws are keyed by ``seed``'s words
    (the parity tests inject the JAX draws instead)."""
    aux, sub = jax_state.aux, jax_state.sub_state
    return MeasureSpaceState(
        q=fullrank_from_numpy(jax_state.q.location, jax_state.q.scale, device=device),
        prob=prob,
        aux=() if isinstance(aux, tuple) and not aux else to_tensor(aux, device),
        iteration=int(np.asarray(jax_state.iteration)),
        sub_state=(() if isinstance(sub, tuple) and not sub else
                   reshuffling_state_from_numpy(sub.perm, int(np.asarray(sub.epoch)),
                                                int(np.asarray(sub.step)), seed, device)),
        seed=seed_words(seed),
    )


def pathfinder_from_numpy(seed, prob, thetas, grads, history: int = 6,
                          n_elbo_samples: int = 32, noise=None,
                          device="cuda") -> PathfinderResult:
    """Pathfinder's stage after the trajectory on a given one, e.g. the JAX
    package's L-BFGS iterates ``thetas`` (T + 1, d) and the gradients of log
    pi there (its log densities are not read after the trajectory);
    ``noise`` (T, K, d): each iterate's base draws."""
    return pathfinder_from_trajectory(
        seed, prob, to_tensor(thetas, device), to_tensor(grads, device), history,
        n_elbo_samples, None if noise is None else to_tensor(noise, device))
