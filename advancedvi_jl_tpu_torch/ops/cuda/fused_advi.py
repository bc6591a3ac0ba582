"""Whole-loop fused ADVI engine (CUDA): one kernel launch per chunk of steps.

Port of ops/pallas/fused_advi.py in its reparameterization-gradient x STL x
Adam x ClipScale x polynomial-averaging branch (``KLMinRepGradDescent(
entropy=STL, n_samples, optimizer=adam(lr), operator=ClipScale())`` with
``PolynomialAveraging``), for two families:

- mean-field, on hierarchical logistic regression
  (csrc/fused_advi_meanfield.cu, plain version ``fused_run_chunk_reference``);
- full-rank, on logistic regression or a dense Gaussian target
  (``mvnormal_spec``), d <= D_FULLRANK_MAX (csrc/fused_advi_fullrank.cu,
  plain version ``fused_fullrank_run_chunk_reference``).

The engine's state holds ``(d,)`` location rows and ``(d,)`` (mean-field) or
``(d, d)`` (full-rank) scale rows: the TPU lane and sublane padding
(``D_PAD``, ``N_PAD``) of the reference is gone, and ``convert.py`` moves
states and noise between the two layouts.

Draws are step-indexed Philox normals (csrc/philox.cuh), keyed by the seed
words and the GLOBAL iteration, and they are the very draws of the general
path's samplers (``sample_with_base`` at ``PhiloxKey(seed, it)``): with one
seed the fused engine and ``KLMinRepGradDescent`` consume the same base
normals, and ``run_chunk(a + b)`` equals ``run_chunk(a)`` then
``run_chunk(b)`` bit for bit.  ``noise=`` injects base draws of shape
``(steps, n_samples, d)`` instead (the parity tests feed the reference's
draws through it).

``fused_run_chunk`` and ``fused_fullrank_run_chunk`` launch their kernel
for CUDA tensors and run its plain PyTorch version for CPU tensors; there is
no fallback between the two.

Logreg gradient (theta = [beta (db), t], sigma = e^t, s = prior_scale):

    log pi(z) = likeadj * sum_j [y_j l_j - softplus(l_j)]   (l = X beta)
              - |beta|^2 e^{-2t} / 2 - db*t - t^2/(2 s^2)
              - log s - (db+1)/2 * log 2 pi
    d/dbeta   = likeadj * X^T (y - sigmoid(l)) - beta e^{-2t}
    d/dt      = |beta|^2 e^{-2t} - db - t/s^2

Dense Gaussian N(m, L L^T) with precision P = L^{-T} L^{-1}:
grad = -(z - m) P, log pi = (z - m) . grad / 2 + lognorm.

STL: dL/dz_i = -(1/n) [grad log pi(z_i) + w_i], w_i the whitened draw
(u_i / sigma mean-field, C^{-T} u_i full-rank); dmu = sum_i dL/dz_i;
dsig = sum_i dL/dz_i * u_i (mean-field), dC = tril(sum_i dL/dz_i u_i^T)
(full-rank).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ...families.location_scale import FullRankGaussian, MeanFieldGaussian
from ...optimize import DivergenceError
from . import _build
from .location_scale_kernels import (
    SeedLike,
    check_f32,
    philox_normals_reference,
    seed_words,
)

MEANFIELD = "meanfield"
FULLRANK = "fullrank"
LOGREG = "logreg"
MVNORMAL = "mvnormal"
MODEL_CODES = {LOGREG: 0, MVNORMAL: 1}  # the full-rank kernel's model switch
# The JAX engine's bound on the full-rank width (its reason was TPU VMEM);
# the port keeps it until an H100 measurement says otherwise.
D_FULLRANK_MAX = 512
_L2PI = math.log(2.0 * math.pi)
STATE_FIELDS = ("mu", "sig", "m_mu", "v_mu", "m_sig", "v_sig", "avg_mu", "avg_sig")
# full-rank kernel layout: (4, d) location rows and (4, d, d) scale matrices
FR_VEC_FIELDS = ("mu", "m_mu", "v_mu", "avg_mu")
FR_MAT_FIELDS = ("sig", "m_sig", "v_sig", "avg_sig")


@dataclass(frozen=True)
class FusedModelSpec:
    """A target the fused engine inlines.  Model kinds: ``"logreg"``, with
    ``consts = (X (n_data, db), y (n_data,))`` float32, ``scalars =
    (likeadj, prior_scale)`` and ``dim = db + 1``; ``"mvnormal"``
    (full-rank engine only), with ``consts = (mean (d,), precision (d, d))``
    and ``scalars = (lognorm,)``."""

    dim: int
    consts: Tuple[torch.Tensor, ...]
    scalars: Tuple[float, ...]
    model: str = LOGREG

    @property
    def device(self) -> torch.device:
        return self.consts[0].device


def logreg_spec(
    X: torch.Tensor, y: torch.Tensor, prior_scale: float = 3.0,
    likeadj: float = 1.0,
) -> FusedModelSpec:
    """Hierarchical logistic regression (models/logreg.py, Exp bijector on
    sigma) as a fused-engine model."""
    if X.ndim != 2 or y.shape != (X.shape[0],):
        raise ValueError(
            f"expected X (n_data, db) and y (n_data,), got {tuple(X.shape)} "
            f"and {tuple(y.shape)}"
        )
    X = X.to(torch.float32).contiguous()
    y = y.to(device=X.device, dtype=torch.float32).contiguous()
    return FusedModelSpec(
        dim=X.shape[1] + 1, consts=(X, y),
        scalars=(float(likeadj), float(prior_scale)), model=LOGREG,
    )


def mvnormal_spec(mean: torch.Tensor, scale_tril: torch.Tensor) -> FusedModelSpec:
    """Dense-covariance Gaussian target N(mean, L L^T) (models/normal.py
    NormalTarget) as a fused-engine model: the precision is computed once
    here, in float32 as the JAX engine does, so a step's gradient is one
    (n, d) x (d, d) product."""
    mean = torch.as_tensor(mean).to(torch.float32).contiguous()
    L = torch.as_tensor(scale_tril).to(device=mean.device, dtype=torch.float32)
    d = mean.shape[0]
    if L.shape != (d, d):
        raise ValueError(f"expected a ({d}, {d}) scale_tril, got {tuple(L.shape)}")
    eye = torch.eye(d, dtype=torch.float32, device=mean.device)
    Linv = torch.linalg.solve_triangular(torch.tril(L), eye, upper=False)
    prec = (Linv.T @ Linv).contiguous()
    lognorm = float(-torch.sum(torch.log(torch.abs(torch.diagonal(L)))) - 0.5 * d * _L2PI)
    return FusedModelSpec(dim=d, consts=(mean, prec), scalars=(lognorm,), model=MVNORMAL)


@dataclass(frozen=True)
class FusedHyper:
    """Adam, averaging and ClipScale constants of the fused engine."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    avg_eta: float = 8.0
    clip_eps: float = 1e-5


@dataclass(frozen=True)
class FusedADVIState:
    """Engine state: eight float32 tensors, ``(d,)`` for the location rows
    and the mean-field scale rows, ``(d, d)`` for the full-rank scale rows
    (``sig``, ``m_sig``, ``v_sig``, ``avg_sig``; upper triangle inert), the
    host iteration count and the last step's ELBO estimate (a 0-dim tensor
    on the device).  With Adam, ``m_*``/``v_*`` are the first and second
    moments."""

    mu: torch.Tensor
    sig: torch.Tensor
    m_mu: torch.Tensor
    v_mu: torch.Tensor
    m_sig: torch.Tensor
    v_sig: torch.Tensor
    avg_mu: torch.Tensor
    avg_sig: torch.Tensor
    iteration: int
    elbo: torch.Tensor

    def stacked(self) -> torch.Tensor:
        """The ``(8, d)`` rows in kernel order (STATE_FIELDS)."""
        return torch.stack([getattr(self, f) for f in STATE_FIELDS])

    @classmethod
    def from_stacked(cls, rows: torch.Tensor, iteration: int, elbo: torch.Tensor):
        return cls(**dict(zip(STATE_FIELDS, rows.unbind(0))),
                   iteration=iteration, elbo=elbo)

    def stacked_fullrank(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full-rank kernel's ``(4, d)`` rows (FR_VEC_FIELDS) and
        ``(4, d, d)`` matrices (FR_MAT_FIELDS)."""
        return (torch.stack([getattr(self, f) for f in FR_VEC_FIELDS]),
                torch.stack([getattr(self, f) for f in FR_MAT_FIELDS]))

    @classmethod
    def from_fullrank(cls, vec: torch.Tensor, mat: torch.Tensor, iteration: int,
                      elbo: torch.Tensor):
        return cls(**dict(zip(FR_VEC_FIELDS, vec.unbind(0))),
                   **dict(zip(FR_MAT_FIELDS, mat.unbind(0))),
                   iteration=iteration, elbo=elbo)


# ---------------------------------------------------------------------------
# The plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


def logreg_logpi_grad(z, X, y, likeadj: float, prior_scale: float):
    """(log pi (n,), grad (n, d)) of the unconstrained logreg target for
    samples ``z`` of shape (n, db + 1) (ops/pallas/fused_advi.py
    ``_logreg_step_factory``)."""
    db = X.shape[1]
    beta, t = z[:, :db], z[:, db]
    inv_sig2 = torch.exp(-2.0 * t)
    beta_sq = torch.sum(beta * beta, dim=1)
    logits = beta @ X.T
    p = torch.sigmoid(logits)
    sp = torch.clamp_min(logits, 0.0) + torch.log1p(torch.exp(-torch.abs(logits)))
    loglike = torch.sum(y * logits - sp, dim=1)
    s = prior_scale
    logpi = (
        likeadj * loglike
        - 0.5 * beta_sq * inv_sig2
        - db * t
        - t * t / (2.0 * s * s)
        - math.log(s)
        - 0.5 * (db + 1) * _L2PI
    )
    gbeta = (likeadj * (y - p)) @ X
    gt = beta_sq * inv_sig2 - db - t / (s * s)
    grad = torch.cat([gbeta - beta * inv_sig2[:, None], gt[:, None]], dim=1)
    return logpi, grad


def _f32(x) -> float:
    return float(np.float32(x))


def _adam_candidate(h: FusedHyper, bc1, bc2, m, v, g):
    """One Adam update (optax scale_by_adam, then scale by -lr).  As in the
    kernel (and the JAX fused kernel), 1 - b is formed from float32 b in
    float32: 1 - f32(0.999) is 1.3e-5 away from optax's 1 - 0.999."""
    b1, b2 = np.float32(h.b1), np.float32(h.b2)
    m2 = float(b1) * m + _f32(1 - b1) * g
    v2 = float(b2) * v + _f32(1 - b2) * g * g
    upd = _f32(-h.lr) * (m2 / bc1) / (torch.sqrt(v2 / bc2) + _f32(h.eps))
    return m2, v2, upd


def fused_run_chunk_reference(
    X, y, scalars, state, seed, it0: int, steps: int, n_samples: int,
    hyp: FusedHyper, noise=None, log_every: int = 0,
):
    """Plain version of csrc/fused_advi_meanfield.cu: a Python loop over
    steps with the kernel's math.  ``state``: (8, d) rows (STATE_FIELDS);
    returns ``(state (8, d), elbo (), trace (steps // log_every,) or None)``."""
    likeadj, prior_scale = scalars
    d = state.shape[1]
    n = n_samples
    inv_n = _f32(1.0 / n)
    mu, sig, m_mu, v_mu, m_sig, v_sig, a_mu, a_sig = state.unbind(0)
    ln_b1 = np.log(np.float32(hyp.b1))
    ln_b2 = np.log(np.float32(hyp.b2))
    elbo = torch.zeros((), dtype=torch.float32, device=state.device)
    trace = []
    for s in range(steps):
        it = it0 + s
        if noise is not None:
            u = noise[s]
        else:
            u = philox_normals_reference(seed, it, n, d, device=state.device)
        z = mu + sig * u
        logpi, grad = logreg_logpi_grad(z, X, y, likeadj, prior_scale)
        g_z = -inv_n * (grad + u / sig)
        dmu = torch.sum(g_z, dim=0)
        dsig = torch.sum(g_z * u, dim=0)
        logdet = torch.sum(torch.log(sig))
        elbo = inv_n * torch.sum(logpi) + (
            logdet + inv_n * (0.5 * torch.sum(u * u)) + 0.5 * d * _L2PI
        )
        c = np.float32(it) + np.float32(1.0)
        bc1 = _f32(np.float32(1.0) - np.exp(c * ln_b1))
        bc2 = _f32(np.float32(1.0) - np.exp(c * ln_b2))
        m_mu, v_mu, upd = _adam_candidate(hyp, bc1, bc2, m_mu, v_mu, dmu)
        mu = mu + upd
        m_sig, v_sig, upd = _adam_candidate(hyp, bc1, bc2, m_sig, v_sig, dsig)
        sig = torch.clamp_min(sig + upd, hyp.clip_eps)
        w = _f32((np.float32(hyp.avg_eta) + 1) / (c + np.float32(hyp.avg_eta)))
        a_mu = (1.0 - w) * a_mu + w * mu
        a_sig = (1.0 - w) * a_sig + w * sig
        if log_every and (s + 1) % log_every == 0:
            trace.append(elbo)
    out = torch.stack([mu, sig, m_mu, v_mu, m_sig, v_sig, a_mu, a_sig])
    tr = torch.stack(trace) if log_every else None
    if log_every and not trace:
        tr = torch.zeros(0, dtype=torch.float32, device=state.device)
    return out, elbo, tr


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

_FUSED_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 4
    + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64]
    + [ctypes.c_float] * 8
    + [ctypes.c_void_p]
)



def fused_run_chunk_cuda(
    X, y, scalars, state, seed, it0: int, steps: int, n_samples: int,
    hyp: FusedHyper, noise=None, log_every: int = 0,
):
    """Launch csrc/fused_advi_meanfield.cu on the current stream (same
    signature and results as ``fused_run_chunk_reference``).  Adds one to
    ``fused_run_chunk_cuda.launches`` per launch."""
    dev = X.device
    if not X.is_cuda:
        raise ValueError(f"fused_run_chunk_cuda needs CUDA tensors, got {dev}")
    n_data, db = X.shape
    d = db + 1
    n = int(n_samples)
    check_f32("X", X, (n_data, db), dev)
    check_f32("y", y, (n_data,), dev)
    check_f32("state", state, (8, d), dev)
    if noise is not None:
        check_f32("noise", noise, (steps, n, d), dev)
    smem = _build.function(
        "fused_advi_meanfield", "fused_advi_meanfield_smem_bytes",
        [ctypes.c_int] * 4, restype=ctypes.c_size_t,
    )(n_data, db, n, d)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"the fused kernel keeps X, the draws and the logits in shared "
            f"memory: {smem} bytes for n_data={n_data}, d={d}, n={n} is over "
            f"the {_build.SMEM_LIMIT}-byte limit of one block"
        )
    fn = _build.function("fused_advi_meanfield", "fused_advi_meanfield", _FUSED_ARGTYPES)
    out = torch.empty((8, d), dtype=torch.float32, device=dev)
    elbo = torch.empty((), dtype=torch.float32, device=dev)
    trace = (
        torch.empty(steps // log_every, dtype=torch.float32, device=dev)
        if log_every else None
    )
    likeadj, prior_scale = scalars
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            X.data_ptr(), y.data_ptr(), n_data, db, state.data_ptr(),
            out.data_ptr(), elbo.data_ptr(),
            trace.data_ptr() if trace is not None else None,
            noise.data_ptr() if noise is not None else None,
            n, d, steps, log_every, seed[0], seed[1], it0,
            hyp.lr, hyp.b1, hyp.b2, hyp.eps, hyp.avg_eta, hyp.clip_eps,
            likeadj, prior_scale, stream,
        )
    _build.check(err, "fused_advi_meanfield launch")
    fused_run_chunk_cuda.launches += 1
    return out, elbo, trace


fused_run_chunk_cuda.launches = 0


def fused_run_chunk(X, y, scalars, state, seed, it0, steps, n_samples, hyp,
                    noise=None, log_every=0):
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if X.is_cuda:
        return fused_run_chunk_cuda(X, y, scalars, state, seed, it0, steps,
                                    n_samples, hyp, noise, log_every)
    if X.device.type == "cpu":
        return fused_run_chunk_reference(X, y, scalars, state, seed, it0, steps,
                                         n_samples, hyp, noise, log_every)
    raise ValueError(f"no fused engine for device {X.device}")


# ---------------------------------------------------------------------------
# The full-rank branch: plain version and kernel wrapper
# ---------------------------------------------------------------------------


def mvnormal_logpi_grad(z, mean, prec, lognorm: float):
    """(log pi (n,), grad (n, d)) of N(mean, P^{-1}) for samples ``z``
    (ops/pallas/fused_advi.py ``_mvnormal_step_factory``)."""
    diff = z - mean
    grad = -(diff @ prec)
    return 0.5 * torch.sum(diff * grad, dim=1) + lognorm, grad


def _model_logpi_grad(model: str, consts, scalars, z):
    if model == LOGREG:
        return logreg_logpi_grad(z, *consts, *scalars)
    if model == MVNORMAL:
        return mvnormal_logpi_grad(z, *consts, *scalars)
    raise ValueError(f"unknown fused model {model!r}")


def fused_fullrank_run_chunk_reference(
    model: str, consts, scalars, vec, mat, seed, it0: int, steps: int,
    n_samples: int, hyp: FusedHyper, noise=None, log_every: int = 0,
):
    """Plain version of csrc/fused_advi_fullrank.cu (the reference kernel's
    FULLRANK branch): a Python loop over steps with the kernel's math.
    ``vec``: (4, d) rows FR_VEC_FIELDS; ``mat``: (4, d, d) FR_MAT_FIELDS.
    Returns ``(vec, mat, elbo (), trace (steps // log_every,) or None)``."""
    d = vec.shape[1]
    n = n_samples
    inv_n = _f32(1.0 / n)
    mu, m_mu, v_mu, a_mu = vec.unbind(0)
    sig, m_sig, v_sig, a_sig = mat.unbind(0)
    ln_b1 = np.log(np.float32(hyp.b1))
    ln_b2 = np.log(np.float32(hyp.b2))
    elbo = torch.zeros((), dtype=torch.float32, device=vec.device)
    trace = []
    for s in range(steps):
        it = it0 + s
        if noise is not None:
            u = noise[s]
        else:
            u = philox_normals_reference(seed, it, n, d, device=vec.device)
        C = torch.tril(sig)
        z = u @ C.T + mu
        logpi, grad = _model_logpi_grad(model, consts, scalars, z)
        # whitening C^{-T} u_i, row form u C^{-1}
        whiten = torch.linalg.solve_triangular(C, u, upper=False, left=False)
        g_z = -inv_n * (grad + whiten)
        dmu = torch.sum(g_z, dim=0)
        dsig = torch.tril(g_z.T @ u)
        logdet = torch.sum(torch.log(torch.diagonal(sig)))
        elbo = inv_n * torch.sum(logpi) + (
            logdet + inv_n * (0.5 * torch.sum(u * u)) + 0.5 * d * _L2PI
        )
        c = np.float32(it) + np.float32(1.0)
        bc1 = _f32(np.float32(1.0) - np.exp(c * ln_b1))
        bc2 = _f32(np.float32(1.0) - np.exp(c * ln_b2))
        m_mu, v_mu, upd = _adam_candidate(hyp, bc1, bc2, m_mu, v_mu, dmu)
        mu = mu + upd
        m_sig, v_sig, upd = _adam_candidate(hyp, bc1, bc2, m_sig, v_sig, dsig)
        sig = sig + upd
        # ClipScale on the diagonal only
        sig = torch.diagonal_scatter(sig, torch.clamp_min(torch.diagonal(sig), hyp.clip_eps))
        w = _f32((np.float32(hyp.avg_eta) + 1) / (c + np.float32(hyp.avg_eta)))
        a_mu = (1.0 - w) * a_mu + w * mu
        a_sig = (1.0 - w) * a_sig + w * sig
        if log_every and (s + 1) % log_every == 0:
            trace.append(elbo)
    tr = None
    if log_every:
        tr = torch.stack(trace) if trace else torch.zeros(0, dtype=torch.float32, device=vec.device)
    return (torch.stack([mu, m_mu, v_mu, a_mu]), torch.stack([sig, m_sig, v_sig, a_sig]),
            elbo, tr)


_FULLRANK_ARGTYPES = (
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_float]
    + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 4
    + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64]
    + [ctypes.c_float] * 6
    + [ctypes.c_void_p]
)


def fused_fullrank_run_chunk_cuda(
    model: str, consts, scalars, vec, mat, seed, it0: int, steps: int,
    n_samples: int, hyp: FusedHyper, noise=None, log_every: int = 0,
):
    """Launch csrc/fused_advi_fullrank.cu on the current stream (same
    signature and results as ``fused_fullrank_run_chunk_reference``).  Adds
    one to ``fused_fullrank_run_chunk_cuda.launches`` per launch."""
    dev = vec.device
    if not vec.is_cuda:
        raise ValueError(f"fused_fullrank_run_chunk_cuda needs CUDA tensors, got {dev}")
    d = vec.shape[1]
    n = int(n_samples)
    check_f32("vec", vec, (4, d), dev)
    check_f32("mat", mat, (4, d, d), dev)
    if model == LOGREG:
        X, y = consts
        n_data, db = X.shape
        check_f32("X", X, (n_data, db), dev)
        check_f32("y", y, (n_data,), dev)
        if db + 1 != d:
            raise ValueError(f"logreg with {db} features needs d = {db + 1}, got {d}")
        s0, s1 = scalars
    elif model == MVNORMAL:
        X, y = consts  # the mean and the precision
        n_data, db = 0, 0
        check_f32("mean", X, (d,), dev)
        check_f32("precision", y, (d, d), dev)
        s0, s1 = scalars[0], 0.0
    else:
        raise ValueError(f"unknown fused model {model!r}")
    if noise is not None:
        check_f32("noise", noise, (steps, n, d), dev)
    code = MODEL_CODES[model]
    smem = _build.function(
        "fused_advi_fullrank", "fused_advi_fullrank_smem_bytes",
        [ctypes.c_int] * 5, restype=ctypes.c_size_t,
    )(code, n_data, db, n, d)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"the full-rank fused kernel keeps the draws and the model's "
            f"per-step arrays in shared memory: {smem} bytes for d={d}, n={n} "
            f"is over the {_build.SMEM_LIMIT}-byte limit of one block"
        )
    fn = _build.function("fused_advi_fullrank", "fused_advi_fullrank", _FULLRANK_ARGTYPES)
    vec_out = torch.empty_like(vec)
    mat_out = torch.empty_like(mat)
    elbo = torch.empty((), dtype=torch.float32, device=dev)
    trace = (
        torch.empty(steps // log_every, dtype=torch.float32, device=dev)
        if log_every else None
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            code, X.data_ptr(), y.data_ptr(), n_data, db, s0, s1,
            vec.data_ptr(), mat.data_ptr(), vec_out.data_ptr(), mat_out.data_ptr(),
            elbo.data_ptr(), trace.data_ptr() if trace is not None else None,
            noise.data_ptr() if noise is not None else None,
            n, d, steps, log_every, seed[0], seed[1], it0,
            hyp.lr, hyp.b1, hyp.b2, hyp.eps, hyp.avg_eta, hyp.clip_eps, stream,
        )
    _build.check(err, "fused_advi_fullrank launch")
    fused_fullrank_run_chunk_cuda.launches += 1
    return vec_out, mat_out, elbo, trace


fused_fullrank_run_chunk_cuda.launches = 0


def fused_fullrank_run_chunk(model, consts, scalars, vec, mat, seed, it0, steps,
                             n_samples, hyp, noise=None, log_every=0):
    """The full-rank kernel for CUDA tensors, its plain version for CPU tensors."""
    args = (model, consts, scalars, vec, mat, seed, it0, steps, n_samples, hyp,
            noise, log_every)
    if vec.is_cuda:
        return fused_fullrank_run_chunk_cuda(*args)
    if vec.device.type == "cpu":
        return fused_fullrank_run_chunk_reference(*args)
    raise ValueError(f"no fused engine for device {vec.device}")


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


class FusedADVI:
    """Whole-loop fused engine: mean-field or full-rank ADVI + STL + Adam +
    ClipScale + polynomial averaging on a ``FusedModelSpec`` target, one
    kernel launch per ``steps`` chunk.  The engine runs where the model's
    tensors lie.  Mean-field takes the logreg model; full-rank takes logreg
    and mvnormal at d <= D_FULLRANK_MAX."""

    def __init__(
        self,
        model: FusedModelSpec,
        family: str = MEANFIELD,
        n_samples: int = 10,
        lr: float = 1e-3,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        avg_eta: float = 8.0,
        clip_eps: float = 1e-5,
    ):
        if family not in (MEANFIELD, FULLRANK):
            raise ValueError(
                f"family must be '{MEANFIELD}' or '{FULLRANK}', got {family!r}"
            )
        ported = (LOGREG,) if family == MEANFIELD else (LOGREG, MVNORMAL)
        if model.model not in ported:
            raise NotImplementedError(
                f"fused model {model.model!r} is not ported yet for the "
                f"{family} engine; it has {ported} (ROADMAP Queue 2, kernels "
                "K4 and K5)"
            )
        if family == FULLRANK and model.dim > D_FULLRANK_MAX:
            raise ValueError(
                f"the full-rank fused engine supports dim <= {D_FULLRANK_MAX}, "
                f"got {model.dim}"
            )
        if n_samples < 1:
            raise ValueError(f"n_samples must be >= 1, got {n_samples}")
        self.model = model
        self.family = family
        self.dim = model.dim
        self.n_samples = n_samples
        self.hyp = FusedHyper(lr, b1, b2, eps, avg_eta, clip_eps)

    def init(self, location: torch.Tensor, scale: torch.Tensor) -> FusedADVIState:
        """``scale``: the (d,) diagonal (mean-field) or the (d, d) factor
        (full-rank; its lower triangle is taken)."""
        d = self.dim
        dev = self.model.device
        scale_shape = (d,) if self.family == MEANFIELD else (d, d)
        if tuple(location.shape) != (d,) or tuple(scale.shape) != scale_shape:
            raise ValueError(
                f"expected a ({d},) location and a {scale_shape} scale, got "
                f"{tuple(location.shape)} and {tuple(scale.shape)}"
            )
        mu = location.detach().to(device=dev, dtype=torch.float32).clone()
        sig = scale.detach().to(device=dev, dtype=torch.float32).clone()
        if self.family == FULLRANK:
            sig = torch.tril(sig)
        zeros, zeros_s = torch.zeros_like(mu), torch.zeros_like(sig)
        return FusedADVIState(
            mu=mu, sig=sig, m_mu=zeros, v_mu=zeros.clone(), m_sig=zeros_s,
            v_sig=zeros_s.clone(), avg_mu=mu.clone(), avg_sig=sig.clone(),
            iteration=0, elbo=torch.zeros((), dtype=torch.float32, device=dev),
        )

    def run_chunk(self, state: FusedADVIState, key: SeedLike, steps: int,
                  noise: Optional[torch.Tensor] = None,
                  model: Optional[FusedModelSpec] = None) -> FusedADVIState:
        """Advance ``steps`` iterations in one kernel launch.

        ``key``: an int, two seed words or a ``PhiloxKey`` (a
        ``torch.Generator`` is read once per call, so a chunked run needs
        one of the others).  ``noise``: optional (steps, n_samples, d) base
        draws replacing the Philox stream.  ``model``: a spec of the same
        kind and shapes replacing ``self.model`` (new data, same engine)."""
        return self._run(state, key, steps, noise, 0, model)[0]

    def run_chunk_traced(self, state: FusedADVIState, key: SeedLike, steps: int,
                         log_every: int, noise: Optional[torch.Tensor] = None,
                         model: Optional[FusedModelSpec] = None):
        """Like ``run_chunk``, and also returns the ``(steps // log_every,)``
        on-device trace of the ELBO estimate of every ``log_every``-th step."""
        if log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {log_every}")
        return self._run(state, key, steps, noise, log_every, model)

    def _check_model(self, model: FusedModelSpec) -> None:
        ref = self.model
        if model.model != ref.model or model.dim != ref.dim or any(
            a.shape != b.shape or a.device != b.device
            for a, b in zip(model.consts, ref.consts)
        ):
            raise ValueError(
                "model= must be a spec of the engine's kind, shapes and device"
            )

    def _run(self, state, key, steps, noise, log_every, model=None):
        model = self.model if model is None else model
        if model is not self.model:
            self._check_model(model)
        if steps < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        if log_every and steps % log_every:
            raise ValueError(
                f"traced chunks need steps % log_every == 0, got "
                f"{steps}/{log_every}"
            )
        dev = model.device
        if noise is not None:
            noise = noise.to(device=dev, dtype=torch.float32).contiguous()
            expect = (steps, self.n_samples, self.dim)
            if tuple(noise.shape) != expect:
                raise ValueError(
                    f"noise must have shape {expect}, got {tuple(noise.shape)}"
                )
        if steps == 0:
            empty = torch.zeros(0, dtype=torch.float32, device=dev)
            return state, (empty if log_every else None)
        it_end = state.iteration + steps
        if self.family == FULLRANK:
            vec, mat = state.stacked_fullrank()
            vec, mat, elbo, trace = fused_fullrank_run_chunk(
                model.model, model.consts, model.scalars, vec, mat,
                seed_words(key), state.iteration, steps, self.n_samples,
                self.hyp, noise, log_every,
            )
            return FusedADVIState.from_fullrank(vec, mat, it_end, elbo), trace
        X, y = model.consts
        rows, elbo, trace = fused_run_chunk(
            X, y, model.scalars, state.stacked(), seed_words(key),
            state.iteration, steps, self.n_samples, self.hyp, noise, log_every,
        )
        return FusedADVIState.from_stacked(rows, it_end, elbo), trace

    # -- the optimize loop with the library contract ------------------------

    def optimize(
        self,
        key: SeedLike,
        max_iter: int,
        q_init=None,
        *,
        state: Optional[FusedADVIState] = None,
        chunk_size: int = 50_000,
        log_every: int = 100,
        check_divergence: bool = True,
    ):
        """Drive the engine with the ``optimize`` contract: returns ``(q,
        infos, state)``, the averaged-parameter family, ``{"iteration",
        "elbo"}`` rows on the ``log_every`` grid (recorded in the kernel,
        read once per chunk) and the warm-startable state.

        Divergence is checked per recorded row, so the raise names the first
        non-finite row's iteration at ``log_every`` granularity."""
        if state is None:
            if q_init is None:
                raise ValueError("pass q_init or state")
            scale = q_init.scale_diag if self.family == MEANFIELD else q_init.scale_matrix()
            state = self.init(q_init.location, scale)
        words = seed_words(key)  # once, so every chunk reads one stream

        def record(elbo: float, iteration: int) -> None:
            infos.append({"elbo": elbo, "iteration": iteration})
            if check_divergence and not math.isfinite(elbo):
                raise DivergenceError(
                    "The objective became non-finite by iteration "
                    f"{iteration} (log_every={log_every} granularity). This "
                    "indicates that the optimization diverged."
                )

        chunk = max(log_every, (chunk_size // log_every) * log_every)
        infos: list = []
        start = done = state.iteration
        end = start + max_iter
        while done < end:
            n = min(chunk, end - done)
            every = min(log_every, n)
            state, trace = self.run_chunk_traced(
                state, words, steps=(n // every) * every, log_every=every,
            )
            for g, e in enumerate(trace.tolist()):  # the chunk's one sync
                record(e, done + (g + 1) * every - start)
            done = state.iteration
            rem = n - (n // log_every) * log_every if n >= log_every else 0
            if rem:
                state = self.run_chunk(state, words, steps=rem)
                done = state.iteration
                record(float(state.elbo), done - start)
        if infos and infos[-1]["iteration"] != max_iter:
            record(float(state.elbo), max_iter)
        return self.q(state), infos, state

    # -- output in library types ------------------------------------------

    def q(self, state: FusedADVIState, averaged: bool = True):
        """The variational family (averaged parameters by default, as
        ``ParamSpaceSGD.output``)."""
        mu, sig = (state.avg_mu, state.avg_sig) if averaged else (state.mu, state.sig)
        if self.family == MEANFIELD:
            return MeanFieldGaussian(mu, sig)
        return FullRankGaussian(mu, sig)


class FusedLogRegADVI(FusedADVI):
    """The flagship engine: mean-field ADVI on hierarchical logreg (see
    FusedADVI and logreg_spec)."""

    def __init__(
        self,
        X: torch.Tensor,
        y: torch.Tensor,
        prior_scale: float = 3.0,
        likeadj: float = 1.0,
        n_samples: int = 10,
        lr: float = 1e-3,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        avg_eta: float = 8.0,
        clip_eps: float = 1e-5,
    ):
        super().__init__(
            logreg_spec(X, y, prior_scale=prior_scale, likeadj=likeadj),
            family=MEANFIELD, n_samples=n_samples, lr=lr, b1=b1, b2=b2,
            eps=eps, avg_eta=avg_eta, clip_eps=clip_eps,
        )
