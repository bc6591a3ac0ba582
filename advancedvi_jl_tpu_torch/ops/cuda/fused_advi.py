"""Whole-loop fused ADVI engines (CUDA): one kernel launch per chunk of steps.

Port of ops/pallas/fused_advi.py: the whole optimisation loop of the three
algorithm constructors in one kernel,

- ``FusedADVI``: ``KLMinRepGradDescent(entropy=STL, optimizer=adam(lr),
  operator=ClipScale())``;
- ``FusedProxADVI``: ``KLMinRepGradProxDescent`` with descent, DoWG or DoG,
  a zero-gradient entropy and the closed-form entropy proximal step;
- ``FusedScoreGradVI``: ``KLMinScoreGradDescent`` (VarGrad) with Adam,
  descent, DoWG, DoG or COCOB and ClipScale or no operator (mean-field);

each with polynomial averaging, for two families:

- mean-field, on hierarchical logistic regression, on its doubly-stochastic
  minibatch version (``logreg_minibatch_spec``, ``logreg_minibatch_hbm_spec``),
  a dense Gaussian (``mvnormal_spec``) or a diagonal Gaussian
  (``gaussian_spec``, ``normallognormal_spec``), d <= D_PAD_MAX
  (csrc/fused_advi_meanfield.cu, plain version ``fused_run_chunk_reference``);
- full-rank, on the same logistic regressions, a dense Gaussian or a
  diagonal Gaussian, d <= D_FULLRANK_MAX (csrc/fused_advi_fullrank.cu, plain
  version ``fused_fullrank_run_chunk_reference``);

and, in both families, on ANY target whose log density is a traceable
function of torch ops (``ad_spec``, ``fused_spec_for``,
``FusedModelSpec.from_log_density``): K5, a model body generated as CUDA
from the target's autograd graph at the engine's (n_samples, d) and built
into the kernels at first use (ops/cuda/ad_body.py); its plain version
replays the graph.

The mean-field kernel keeps a launch in one block's shared memory where it
fits; the diagonal Gaussian always does, on its own kGauss instances
(csrc/fused_gauss_body.cuh: one column-fused pass a step, no u, z or g
arrays); a dense model that does not fit (a wide design, a wide d or many
samples, K5's body included) runs its kWide layout
instead (csrc/fused_meanfield_body.cuh ``wide_layout``), and the dense
Gaussian its own instance of that layout, kMvn (``mvn_layout``: the
precision staged in shared memory, or streamed by rows through a TMA ring,
csrc/mvnormal_product.cuh; the kernels take it with rows of round4(d)
floats, ``kernel_precision``): the state rows and
the row sums stay in shared memory, and the model's data, then the logits
(K5: its scratch), then the draws, samples and gradients move to device
memory, the last two into a workspace the wrapper allocates
(``fused_layout``).  A minibatch launch that does not fit runs the kMbWide
layout (``mb_layout``): the logits, then the staged slab (read where it
lies), then the beta copy, draws, samples and gradients.  The full-rank
kernel's single-block launches do the same after its scale matrices and
panel operators (csrc/fused_advi_fullrank.cu ``tier_layout``,
``fullrank_layout``): the model's data, then the logits (K5: its scratch),
then u, z, g and the whitened draws.

The branch is chosen by the engine's attributes ``algo``, ``entropy``,
``grad_est`` and ``operator`` (JAX's string values) and passed to the kernel
as integer codes (``FusedBranch``); one compiled kernel serves every branch.

The engine's state holds ``(d,)`` location rows and ``(d,)`` (mean-field) or
``(d, d)`` (full-rank) scale rows: the TPU lane and sublane padding
(``D_PAD``, ``N_PAD``) of the reference is gone, and ``convert.py`` moves
states and noise between the two layouts.  As in the reference, DoWG and DoG
keep x0 in ``m_*`` and [v, r] in ``v_mu[0:2]`` (so they need d >= 2), and
COCOB keeps x1 in ``m_*``, L in ``v_*`` and (G, reward, theta) for the
location and then the scale in ``ext``.

Draws are step-indexed Philox normals (csrc/philox.cuh), keyed by the seed
words and the GLOBAL iteration, and they are the very draws of the general
path's samplers (``sample_with_base`` at ``PhiloxKey(seed, it)``): with one
seed the fused engine and the general path consume the same base normals,
and ``run_chunk(a + b)`` equals ``run_chunk(a)`` then ``run_chunk(b)`` bit
for bit.  ``noise=`` injects base draws of shape ``(steps, n_samples, d)``
instead (the parity tests feed the reference's draws through it).

``fused_run_chunk`` and ``fused_fullrank_run_chunk`` launch their kernel
for CUDA tensors and run its plain PyTorch version for CPU tensors; there is
no fallback between the two.

Logreg gradient (theta = [beta (db), t], sigma = e^t, s = prior_scale):

    log pi(z) = likeadj * sum_j [y_j l_j - softplus(l_j)]   (l = X beta)
              - |beta|^2 e^{-2t} / 2 - db*t - t^2/(2 s^2)
              - log s - (db+1)/2 * log 2 pi
    d/dbeta   = likeadj * X^T (y - sigmoid(l)) - beta e^{-2t}
    d/dt      = |beta|^2 e^{-2t} - db - t/s^2

Minibatch logreg (K4's minibatch factories): the data are the permuted
design X_perm (n_used, db), n_used = nb * B, and the per-batch label sums
yX (nb, db); step ``it`` uses batch k = it mod nb (rows k B .. k B + B - 1),
likeadj = n_data / B, and log pi = likeadj (beta . yX_k - sum softplus(X_k
beta)) + the prior terms above, d/dbeta = likeadj (yX_k - sigmoid(X_k
beta) X_k) - beta e^{-2t}.  The kernels read the slab in place, stage it in
shared memory each step, or stage it and pull the next slab into L2; the
three transports compute the same bits.  ``FusedADVI.optimize`` reshuffles
the data between chunks (the spec's ``reshuffle``, keyed by the seed words
and the iterations done), never mutating the engine's spec.

Dense Gaussian N(m, L L^T) with precision P = L^{-T} L^{-1}:
grad = -(z - m) P, log pi = (z - m) . grad / 2 + lognorm.  Diagonal Gaussian
N(m, diag(1/v)): grad = -(z - m) v, log pi = -sum (z - m)^2 v / 2 + lognorm.

STL: dL/dz_i = -(1/n) [grad log pi(z_i) + w_i], w_i the whitened draw
(u_i / sigma mean-field, C^{-T} u_i full-rank); dmu = sum_i dL/dz_i;
dsig = sum_i dL/dz_i * u_i (mean-field), dC = tril(sum_i dL/dz_i u_i^T)
(full-rank).  The closed-form zero-gradient entropy drops w_i; the STL
zero-gradient one adds 1/sigma to the scale diagonal's gradient.  VarGrad:
f_i = log q(z_i) - log pi(z_i), dL = (1/n) sum_i (f_i - fbar) dlogq_i with
dlogq/dmu = u/sigma and dlogq/dsigma = (u^2 - 1)/sigma.
"""

from __future__ import annotations

import ctypes
import math
import warnings
import weakref
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ...core.problem import ORDER_AUTOGRAD, dim_of, fn_target, order_of
from ...families.location_scale import FullRankGaussian, MeanFieldGaussian
from ...optimize import DivergenceError
from ...subsampling import keyed_permutation
from . import _build
from .ad_body import ADModel, ADProgram, check_leaves, leaf_device
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
GAUSSIAN = "gaussian"
# the minibatch logreg, one name per slab transport (JAX's three factories)
LOGREG_MB = "logreg_minibatch"                    # in place
LOGREG_MB_STAGED = "logreg_minibatch_staged"      # staged in shared memory
LOGREG_MB_PREFETCH = "logreg_minibatch_prefetch"  # staged, next slab into L2
MINIBATCH_MODELS = (LOGREG_MB, LOGREG_MB_STAGED, LOGREG_MB_PREFETCH)
AD = "ad"  # K5: a generated body of any traceable target
MODEL_CODES = {LOGREG: 0, MVNORMAL: 1, GAUSSIAN: 2, LOGREG_MB: 3, LOGREG_MB_STAGED: 4,
               LOGREG_MB_PREFETCH: 5, AD: 6}  # the kernels' model switch
# The JAX engine's bound on the full-rank width (its reason was TPU VMEM);
# the port keeps it until an H100 measurement says otherwise.
D_FULLRANK_MAX = 512
# The JAX engines' bound on d (every fused engine): one block keeps the
# state rows, 16 d floats with COCOB's, in shared memory (128 KB at 2,048)
D_PAD_MAX = 2048
_L2PI = math.log(2.0 * math.pi)

# The kernels' branch switches, with the JAX engine's string values
# (ops/pallas/fused_advi.py:120-140).
ENT_STL = "stl"
ENT_CF_ZERO = "closed_form_zero_grad"
ENT_STL_ZERO = "stl_zero_grad"
ALGO_ADAM = "adam"
ALGO_DESCENT = "descent"
ALGO_DOWG = "dowg"
ALGO_DOG = "dog"
ALGO_COCOB = "cocob"
ETA_ALGOS = (ALGO_DESCENT, ALGO_DOWG, ALGO_DOG)  # rules with a step size to read
OP_CLIP = "clip"
OP_PROX = "prox"
OP_NONE = "none"
GE_REPGRAD = "repgrad"
GE_SCOREGRAD = "scoregrad"
ALGO_CODES = {ALGO_ADAM: 0, ALGO_DESCENT: 1, ALGO_DOWG: 2, ALGO_DOG: 3, ALGO_COCOB: 4}
ENTROPY_CODES = {ENT_STL: 0, ENT_CF_ZERO: 1, ENT_STL_ZERO: 2}
GRAD_EST_CODES = {GE_REPGRAD: 0, GE_SCOREGRAD: 1}
OPERATOR_CODES = {OP_CLIP: 0, OP_PROX: 1, OP_NONE: 2}

STATE_FIELDS = ("mu", "sig", "m_mu", "v_mu", "m_sig", "v_sig", "avg_mu", "avg_sig")
# full-rank kernel layout: (4, d) location rows and (4, d, d) scale matrices,
# each followed by COCOB's three ext rows or matrices
FR_VEC_FIELDS = ("mu", "m_mu", "v_mu", "avg_mu")
FR_MAT_FIELDS = ("sig", "m_sig", "v_sig", "avg_sig")

# Launch groups a chip run counts separately: the branches beyond the
# STL x Adam x ClipScale one (rules, entropies, operators), VarGrad, the
# diagonal-Gaussian model body, the minibatch body's three transports and
# K5's generated body.
GROUP_RULES = "k3_rules"
GROUP_VARGRAD = "k3_vargrad"
GROUP_GAUSSIAN = "k4_gaussian"
GROUP_MB = {LOGREG_MB: "k4_minibatch_inplace", LOGREG_MB_STAGED: "k4_minibatch_staged",
            LOGREG_MB_PREFETCH: "k4_minibatch_prefetch"}
GROUP_AD = "k5_ad"
# the mean-field and chains kernels only: the dense-Gaussian body, and the
# kWide layout with an array in device memory (its tier >= 1), a hand model's
# or K5's body's; the kMbWide layout of the minibatch transports
GROUP_MVNORMAL = "k4_mvnormal"
GROUP_DEVICE_LAYOUT = "k1_device_layout"
GROUP_AD_DEVICE_LAYOUT = "k5_device_layout"
GROUP_MB_DEVICE_LAYOUT = "k4_minibatch_device_layout"
# the full-rank single-block kernel on its tiered layout (tier >= 1)
GROUP_FR_DEVICE_LAYOUT = "k3_fullrank_device_layout"
LAUNCH_GROUPS = ((GROUP_RULES, GROUP_VARGRAD, GROUP_GAUSSIAN) + tuple(GROUP_MB.values())
                 + (GROUP_AD, GROUP_MVNORMAL, GROUP_DEVICE_LAYOUT, GROUP_AD_DEVICE_LAYOUT,
                    GROUP_MB_DEVICE_LAYOUT, GROUP_FR_DEVICE_LAYOUT))


@dataclass(frozen=True)
class FusedModelSpec:
    """A target the fused engine inlines.  Model kinds: ``"logreg"``, with
    ``consts = (X (n_data, db), y (n_data,))`` float32, ``scalars =
    (likeadj, prior_scale)`` and ``dim = db + 1``; ``"mvnormal"``,
    with ``consts = (mean (d,), precision (d, d))``
    and ``scalars = (lognorm,)``; ``"gaussian"``, with ``consts = (mean
    (d,), inverse variance (d,))`` and ``scalars = (lognorm,)``; the three
    MINIBATCH_MODELS, with ``consts = (X_perm (nb * B, db), yX (nb, db))``,
    ``scalars = (n_data / B, prior_scale)`` and ``reshuffle(seed words,
    iterations done) -> consts``, which draws a new data order; ``"ad"``
    (``ad_spec``), with ``ad`` the target's ``ADModel`` (its traced graph,
    one program per sample count) and ``consts = (float32 constants,
    int32 constants)``, the graph's packed leaves."""

    dim: int
    consts: Tuple[torch.Tensor, ...]
    scalars: Tuple[float, ...]
    model: str = LOGREG
    reshuffle: Optional[Callable] = None
    ad: Optional[ADModel] = None

    @property
    def device(self) -> torch.device:
        return self.consts[0].device

    @classmethod
    def from_log_density(cls, fn: Callable, dim: int, data: Any = None,
                         device=None) -> "FusedModelSpec":
        """A spec of ANY log density of torch ops, no hand-derived gradient
        needed (JAX :182-198): ``fn(theta, data)`` maps (..., dim) samples to
        (...) values; ``data`` (tensors, possibly in dicts, lists, tuples)
        is closed over as the kernel's constants.  See ``ad_spec``."""
        return ad_spec(fn_target(fn, dim, data=data), device=device)


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


def gaussian_spec(mean: torch.Tensor, stddev: torch.Tensor) -> FusedModelSpec:
    """Diagonal-Gaussian target N(mean, diag(stddev)^2) as a fused-engine
    model; this is exactly the unconstrained normal-lognormal target
    (``normallognormal_spec``)."""
    mean = torch.as_tensor(mean).to(torch.float32).contiguous()
    stddev = torch.as_tensor(stddev).to(device=mean.device, dtype=torch.float32)
    d = mean.shape[0]
    if mean.ndim != 1 or stddev.shape != (d,):
        raise ValueError(
            f"expected a (d,) mean and stddev, got {tuple(mean.shape)} and "
            f"{tuple(stddev.shape)}"
        )
    lognorm = float(-torch.sum(torch.log(stddev)) - 0.5 * d * _L2PI)
    inv_var = (1.0 / (stddev * stddev)).contiguous()
    return FusedModelSpec(dim=d, consts=(mean, inv_var), scalars=(lognorm,), model=GAUSSIAN)


def normallognormal_spec(prob) -> FusedModelSpec:
    """The fused-engine model of a models/normallognormal.py NormalLogNormal
    in its unconstrained space (a diagonal Gaussian in [log y, x]): the Exp
    bijector's log-det +t cancels the LogNormal's -log y."""
    mean = torch.cat([prob.mu_y.reshape(1), prob.mu_x])
    stddev = torch.cat([prob.sigma_y.reshape(1), prob.sigma_x])
    return gaussian_spec(mean, stddev)


def ad_spec(target, device=None) -> FusedModelSpec:
    """A spec of ANY autograd target (order ``ORDER_AUTOGRAD``) whose
    batched ``log_density`` is a traceable function of the ops on K5's list
    (ops/cuda/ad_body.py ``ALLOWED``: elementwise math, sums, matrix
    products, views, concatenation): the engines run a body generated from
    its autograd graph (JAX ``ad_spec``, :1548-1607; the reference's AD glue
    serves any model in its hot loop, src/algorithms/repgradelbo.jl:142-149).

    An oracle target, a bool or complex leaf, an op off the list or
    data-dependent control flow raises ValueError; so does, when an engine
    is built on the spec, a body whose scratch does not fit one block's
    shared memory beside the engine's arrays.  The hand-derived specs
    (``logreg_spec``, ``gaussian_spec``, ...) remain the faster choice where
    they exist (``fused_spec_for`` takes them).  The tensors go where the
    target's lie (``device``, when it has none)."""
    if order_of(target) != ORDER_AUTOGRAD:
        raise ValueError(
            f"ad_spec needs an autograd-traceable target (order {ORDER_AUTOGRAD}); "
            f"{type(target).__name__} has order {order_of(target)}: oracle and "
            "external targets cannot run inside a kernel"
        )
    check_leaves(target)
    d = dim_of(target)
    dev = torch.device(device) if device is not None else leaf_device(target)
    model = ADModel(target.log_density, d, dev, name=type(target).__name__)
    prog = model.program(1)  # trace, check and pack now: errors at spec build
    return FusedModelSpec(dim=d, consts=prog.consts, scalars=(), model=AD, ad=model)


def fused_spec_for(target) -> FusedModelSpec:
    """The fused spec of a target (JAX :1610-1650): a hand-derived spec
    where one exists (faster), otherwise ``ad_spec``.

    Hand specs: models.normal.NormalTarget (``mvnormal_spec``, both
    families), and a ``TransformedTarget`` over models.logreg.LogReg or
    models.normallognormal.NormalLogNormal under the model's own
    ``unconstrained()`` transform.  A TransformedTarget under any other
    transform goes to ``ad_spec`` (the hand gradients hard-code the Exp
    bijector).  A constrained LogReg or NormalLogNormal raises: a Gaussian
    family on a bounded support is a modelling error."""
    from ...core.transforms import TransformedTarget
    from ...models.logreg import LogReg
    from ...models.normal import NormalTarget
    from ...models.normallognormal import NormalLogNormal

    if isinstance(target, NormalTarget):
        return mvnormal_spec(target.mu, target.scale_tril)
    if isinstance(target, TransformedTarget):
        inner = target.prob
        if isinstance(inner, (LogReg, NormalLogNormal)) \
                and target.transform == inner.unconstrained().transform:
            if isinstance(inner, LogReg):
                return logreg_spec(inner.X, inner.y, prior_scale=inner.prior_scale,
                                   likeadj=float(inner.likeadj))
            return normallognormal_spec(inner)
        return ad_spec(target)
    if isinstance(target, (LogReg, NormalLogNormal)):
        raise ValueError(
            f"{type(target).__name__} is constrained-space; the fused engine works on "
            "target.unconstrained()"
        )
    return ad_spec(target)


def pack_minibatch_consts(Xp: torch.Tensor, yp: torch.Tensor, batch_size: int):
    """(X_perm (n_used, db), yX (nb, db)) of permuted data: yX[k] is the sum
    of y_j X_j over batch k (ops/pallas/fused_advi.py:1075-1088 without the
    lane padding)."""
    n_used, db = Xp.shape
    nb = n_used // batch_size
    yX = (yp[:, None] * Xp).reshape(nb, batch_size, db).sum(dim=1)
    return Xp.contiguous(), yX.contiguous()


def _logreg_mb_build(X, y, batch_size, prior_scale, generator, perm, model):
    """What the two minibatch specs share (JAX ``_logreg_mb_build``):
    validation, the drop-trailing-batch permutation, likeadj = n_data / B and
    the reshuffle closure.  The data stay on X's device; ``perm`` (an index
    tensor) or ``generator`` (a seed, keyed as the reshuffles are) orders
    them; with neither, the given order is kept.  As in JAX, the closure
    keeps X and y alive beside the packed copy, so a spec holds the design
    twice on the device (2 x 120 MB at 500,000 x 60)."""
    if X.ndim != 2 or y.shape != (X.shape[0],):
        raise ValueError(
            f"expected X (n_data, db) and y (n_data,), got {tuple(X.shape)} and "
            f"{tuple(y.shape)}"
        )
    n_data, db = X.shape
    if batch_size % 8 != 0:
        raise ValueError(f"batch_size must be a multiple of 8, got {batch_size}")
    nb = n_data // batch_size
    if nb < 1:
        raise ValueError(f"batch_size {batch_size} exceeds n_data {n_data}")
    n_used = nb * batch_size
    X = X.to(torch.float32).contiguous()
    y = y.to(device=X.device, dtype=torch.float32).contiguous()
    if perm is None and generator is not None:
        perm = keyed_permutation(n_data, seed_words(generator), 0, X.device)
    if perm is None:
        Xp, yp = X[:n_used], y[:n_used]
    else:
        perm = perm.to(X.device)[:n_used]
        Xp, yp = X.index_select(0, perm), y.index_select(0, perm)

    def reshuffle(words, done):
        p = keyed_permutation(n_data, words, done, X.device)[:n_used]
        return pack_minibatch_consts(X.index_select(0, p), y.index_select(0, p), batch_size)

    return FusedModelSpec(
        dim=db + 1, consts=pack_minibatch_consts(Xp, yp, batch_size),
        scalars=(n_data / batch_size, float(prior_scale)), model=model,
        reshuffle=reshuffle,
    )


def logreg_minibatch_spec(
    X: torch.Tensor, y: torch.Tensor, batch_size: int, prior_scale: float = 3.0,
    generator=None, perm: Optional[torch.Tensor] = None,
) -> FusedModelSpec:
    """Doubly-stochastic hierarchical logreg as a fused-engine model (JAX
    ``logreg_minibatch_spec``): the permuted data stay in device memory and
    step ``it`` reads batch k = it mod nb where it lies, the likelihood
    rescaled by n_data / B (the ``subsample`` contract), trailing rows
    beyond nb * B dropped.  Within a chunk the order is fixed (cyclic
    passes); ``FusedADVI.optimize`` reshuffles between chunks, a coarser
    schedule than the general path's per-epoch one with the same unbiased
    estimator."""
    return _logreg_mb_build(X, y, batch_size, prior_scale, generator, perm, LOGREG_MB)


def logreg_minibatch_hbm_spec(
    X: torch.Tensor, y: torch.Tensor, batch_size: int, prior_scale: float = 3.0,
    generator=None, prefetch: bool = True, perm: Optional[torch.Tensor] = None,
) -> FusedModelSpec:
    """The minibatch logreg with the slab staged (JAX
    ``logreg_minibatch_hbm_spec``): each step the block copies its B-row slab
    into shared memory, overlapped with the slab-independent work; with
    ``prefetch`` (the default) step it also pulls slab it+1 into L2.  Same
    estimator, schedule and results as ``logreg_minibatch_spec``; n_data is
    bounded by device memory only."""
    model = LOGREG_MB_PREFETCH if prefetch else LOGREG_MB_STAGED
    return _logreg_mb_build(X, y, batch_size, prior_scale, generator, perm, model)


@dataclass(frozen=True)
class FusedHyper:
    """Adam, averaging and ClipScale constants of the fused engine (``lr``
    is also descent's step size)."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    avg_eta: float = 8.0
    clip_eps: float = 1e-5


@dataclass(frozen=True)
class FusedBranch:
    """Which branch of the kernel a launch runs: the update rule, the
    entropy estimator, the gradient estimator and the post-update operator
    (JAX's string values), and COCOB's bet-fraction floor."""

    algo: str = ALGO_ADAM
    entropy: str = ENT_STL
    grad_est: str = GE_REPGRAD
    operator: str = OP_CLIP
    cocob_alpha: float = 100.0

    def codes(self) -> Tuple[int, int, int, int]:
        for name, table in (("algo", ALGO_CODES), ("entropy", ENTROPY_CODES),
                            ("grad_est", GRAD_EST_CODES), ("operator", OPERATOR_CODES)):
            if getattr(self, name) not in table:
                raise ValueError(
                    f"{name} must be one of {tuple(table)}, got {getattr(self, name)!r}"
                )
        if self.operator == OP_PROX and self.algo not in ETA_ALGOS:
            raise ValueError(
                f"the proximal operator needs a step size: algo must be one of "
                f"{ETA_ALGOS}, got {self.algo!r}"
            )
        return (ALGO_CODES[self.algo], ENTROPY_CODES[self.entropy],
                GRAD_EST_CODES[self.grad_est], OPERATOR_CODES[self.operator])

    @property
    def ext_rows(self) -> int:
        return 6 if self.algo == ALGO_COCOB else 0

    def groups(self, model: str) -> Tuple[str, ...]:
        """The launch groups (LAUNCH_GROUPS) this branch on ``model`` runs."""
        out = []
        if (self.algo, self.entropy, self.operator) != (ALGO_ADAM, ENT_STL, OP_CLIP):
            out.append(GROUP_RULES)
        if self.grad_est == GE_SCOREGRAD:
            out.append(GROUP_VARGRAD)
        if model == GAUSSIAN:
            out.append(GROUP_GAUSSIAN)
        if model in GROUP_MB:
            out.append(GROUP_MB[model])
        if model == AD:
            out.append(GROUP_AD)
        return tuple(out)


DEFAULT_BRANCH = FusedBranch()


@dataclass(frozen=True)
class FusedADVIState:
    """Engine state: eight float32 tensors, ``(d,)`` for the location rows
    and the mean-field scale rows, ``(d, d)`` for the full-rank scale rows
    (``sig``, ``m_sig``, ``v_sig``, ``avg_sig``; upper triangle inert), the
    host iteration count and the last step's ELBO estimate (a 0-dim tensor
    on the device).  ``m_*``/``v_*``: Adam's moments; DoWG/DoG: x0 and
    [v, r] in ``v_mu[0:2]``; COCOB: x1 and L.  ``ext``: None, or COCOB's
    six tensors: G, reward and theta of the location, then of the scale."""

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
    ext: Optional[Tuple[torch.Tensor, ...]] = None

    def stacked(self, with_ext: bool = True) -> torch.Tensor:
        """The ``(8, d)`` rows in kernel order (STATE_FIELDS), then the six
        ext rows when there are any and ``with_ext``."""
        rows = [getattr(self, f) for f in STATE_FIELDS]
        if with_ext and self.ext is not None:
            rows += list(self.ext)
        return torch.stack(rows)

    @classmethod
    def from_stacked(cls, rows: torch.Tensor, iteration: int, elbo: torch.Tensor,
                     ext=None):
        """From ``(8, d)`` rows (``ext`` kept as given) or ``(14, d)`` rows."""
        parts = rows.unbind(0)
        if len(parts) == 14:
            ext = tuple(parts[8:])
        return cls(**dict(zip(STATE_FIELDS, parts[:8])), iteration=iteration,
                   elbo=elbo, ext=ext)

    def stacked_fullrank(self, with_ext: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full-rank kernel's ``(4, d)`` rows (FR_VEC_FIELDS) and
        ``(4, d, d)`` matrices (FR_MAT_FIELDS), each followed by COCOB's
        three ext rows or matrices when there are any and ``with_ext``."""
        vec = [getattr(self, f) for f in FR_VEC_FIELDS]
        mat = [getattr(self, f) for f in FR_MAT_FIELDS]
        if with_ext and self.ext is not None:
            vec += list(self.ext[:3])
            mat += list(self.ext[3:])
        return torch.stack(vec), torch.stack(mat)

    @classmethod
    def from_fullrank(cls, vec: torch.Tensor, mat: torch.Tensor, iteration: int,
                      elbo: torch.Tensor, ext=None):
        v, m = vec.unbind(0), mat.unbind(0)
        if len(v) == 7:
            ext = tuple(v[4:]) + tuple(m[4:])
        return cls(**dict(zip(FR_VEC_FIELDS, v[:4])), **dict(zip(FR_MAT_FIELDS, m[:4])),
                   iteration=iteration, elbo=elbo, ext=ext)


# ---------------------------------------------------------------------------
# The plain PyTorch versions of the kernels
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


def mvnormal_logpi_grad(z, mean, prec, lognorm: float):
    """(log pi (n,), grad (n, d)) of N(mean, P^{-1}) for samples ``z``
    (ops/pallas/fused_advi.py ``_mvnormal_step_factory``)."""
    diff = z - mean
    grad = -(diff @ prec)
    return 0.5 * torch.sum(diff * grad, dim=1) + lognorm, grad


def gaussian_logpi_grad(z, mean, inv_var, lognorm: float):
    """(log pi (n,), grad (n, d)) of N(mean, diag(1/inv_var)) for samples
    ``z`` (ops/pallas/fused_advi.py ``_gaussian_step_factory``)."""
    diff = z - mean
    return -0.5 * torch.sum(diff * diff * inv_var, dim=1) + lognorm, -diff * inv_var


def logreg_minibatch_logpi_grad(z, X_perm, yX, it: int, likeadj: float, prior_scale: float):
    """(log pi (n,), grad (n, d)) of the minibatch logreg at iteration
    ``it``: batch k = it mod nb of the permuted data, likelihood rescaled by
    likeadj (ops/pallas/fused_advi.py ``_logreg_mb_math``)."""
    nb, db = yX.shape
    B = X_perm.shape[0] // nb
    k = it % nb
    Xb, yXb = X_perm[k * B:(k + 1) * B], yX[k]
    beta, t = z[:, :db], z[:, db]
    inv_sig2 = torch.exp(-2.0 * t)
    beta_sq = torch.sum(beta * beta, dim=1)
    logits = beta @ Xb.T
    p = torch.sigmoid(logits)
    sp = torch.clamp_min(logits, 0.0) + torch.log1p(torch.exp(-torch.abs(logits)))
    loglike = beta @ yXb - torch.sum(sp, dim=1)
    s = prior_scale
    logpi = (
        likeadj * loglike
        - 0.5 * beta_sq * inv_sig2
        - db * t
        - t * t / (2.0 * s * s)
        - math.log(s)
        - 0.5 * (db + 1) * _L2PI
    )
    gbeta = likeadj * (yXb - p @ Xb)
    gt = beta_sq * inv_sig2 - db - t / (s * s)
    return logpi, torch.cat([gbeta - beta * inv_sig2[:, None], gt[:, None]], dim=1)


def _model_logpi_grad(model: str, consts, scalars, z, it: int, ad=None):
    if model == AD:
        return ad.logpi_grad(z)
    if model == LOGREG:
        return logreg_logpi_grad(z, *consts, *scalars)
    if model in MINIBATCH_MODELS:
        return logreg_minibatch_logpi_grad(z, *consts, it, *scalars)
    if model == MVNORMAL:
        return mvnormal_logpi_grad(z, *consts, *scalars)
    if model == GAUSSIAN:
        return gaussian_logpi_grad(z, *consts, *scalars)
    raise ValueError(f"unknown fused model {model!r}")


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


def _cocob_update(ca: float, x, x1, L, G, R, th, g):
    """One COCOB-Backprop update per coordinate (fused_advi.py:242-256):
    returns (x, L, G, R, theta)."""
    L2 = torch.maximum(L, torch.abs(g))
    G2 = G + torch.abs(g)
    R2 = torch.clamp_min(R + (x - x1) * (-g), 0.0)
    t2 = th - g
    den = L2 * torch.maximum(G2 + L2, _f32(ca) * L2)
    bet = torch.where(den > 0, t2 / torch.where(den > 0, den, torch.ones_like(den)),
                      torch.zeros_like(den))
    return x1 + bet * (L2 + R2), L2, G2, R2, t2


def _rule_step(branch: FusedBranch, h: FusedHyper, c, st, dmu, dsig, lower=None):
    """The update rule on the state dict ``st`` (mu, sig, m_mu, v_mu, m_sig,
    v_sig, ext) for gradients (dmu, dsig); returns the step size eta used
    (None for Adam and COCOB).  ``lower``: the full-rank lower-triangle mask
    (the kernel moves nothing above the diagonal)."""
    if branch.algo == ALGO_ADAM:
        bc1 = _f32(np.float32(1.0) - np.exp(c * np.log(np.float32(h.b1))))
        bc2 = _f32(np.float32(1.0) - np.exp(c * np.log(np.float32(h.b2))))
        st["m_mu"], st["v_mu"], upd = _adam_candidate(h, bc1, bc2, st["m_mu"], st["v_mu"], dmu)
        st["mu"] = st["mu"] + upd
        st["m_sig"], st["v_sig"], upd = _adam_candidate(h, bc1, bc2, st["m_sig"],
                                                        st["v_sig"], dsig)
        st["sig"] = st["sig"] + upd
        return None
    if branch.algo == ALGO_COCOB:
        g_mu, r_mu, t_mu, g_sig, r_sig, t_sig = st["ext"]
        st["mu"], st["v_mu"], g_mu, r_mu, t_mu = _cocob_update(
            branch.cocob_alpha, st["mu"], st["m_mu"], st["v_mu"], g_mu, r_mu, t_mu, dmu)
        old = (st["sig"], st["v_sig"], g_sig, r_sig, t_sig)
        new = _cocob_update(branch.cocob_alpha, st["sig"], st["m_sig"], st["v_sig"],
                            g_sig, r_sig, t_sig, dsig)
        if lower is not None:
            new = tuple(torch.where(lower, a, b) for a, b in zip(new, old))
        st["sig"], st["v_sig"], g_sig, r_sig, t_sig = new
        st["ext"] = (g_mu, r_mu, t_mu, g_sig, r_sig, t_sig)
        return None
    if branch.algo in (ALGO_DOWG, ALGO_DOG):
        dx = st["sig"] - st["m_sig"]
        if lower is not None:
            dx = torch.where(lower, dx, torch.zeros_like(dx))
        dl = st["mu"] - st["m_mu"]
        dist = torch.sqrt(torch.sum(dl * dl) + torch.sum(dx * dx))
        v_prev, r_prev = st["v_mu"][0], st["v_mu"][1]
        r = torch.maximum(dist, r_prev)
        gsq = torch.sum(dmu * dmu) + torch.sum(dsig * dsig)
        if branch.algo == ALGO_DOWG:
            v = v_prev + r * r * gsq
            eta = r * r / torch.sqrt(torch.clamp_min(v, 1e-30))
        else:
            v = v_prev + gsq
            eta = r / torch.sqrt(torch.clamp_min(v, 1e-30))
        st["v_mu"] = torch.cat([v.reshape(1), r.reshape(1), torch.zeros_like(st["v_mu"][2:])])
    else:
        eta = torch.tensor(_f32(h.lr), dtype=dmu.dtype, device=dmu.device)
    st["mu"] = st["mu"] - eta * dmu
    st["sig"] = st["sig"] - eta * dsig
    return eta


def _prox(s, eta):
    return 0.5 * s + 0.5 * torch.sqrt(s * s + 4.0 * eta)


def _entropy_value(branch: FusedBranch, logdet, u, inv_n: float):
    """The ELBO estimate's entropy term: closed form for the closed-form
    zero-gradient estimator, the STL value otherwise (-H(q) + H(q_stop) of
    the STL zero-gradient estimator is 0)."""
    d = u.shape[1]
    if branch.entropy == ENT_CF_ZERO:
        return logdet + 0.5 * d * (1.0 + _L2PI)
    return logdet + inv_n * (0.5 * torch.sum(u * u)) + 0.5 * d * _L2PI


def _avg(h: FusedHyper, c, a, x):
    w = _f32((np.float32(h.avg_eta) + 1) / (c + np.float32(h.avg_eta)))
    return (1.0 - w) * a + w * x


def _draw(noise, seed, it, s, n, d, device):
    return noise[s] if noise is not None else philox_normals_reference(
        seed, it, n, d, device=device)


def _trace_out(trace, log_every, device):
    if not log_every:
        return None
    return torch.stack(trace) if trace else torch.zeros(0, dtype=torch.float32, device=device)


def fused_run_chunk_reference(
    model: str, consts, scalars, state, seed, it0: int, steps: int, n_samples: int,
    hyp: FusedHyper, noise=None, log_every: int = 0, branch: FusedBranch = DEFAULT_BRANCH,
    ad: Optional[ADProgram] = None,
):
    """Plain version of csrc/fused_advi_meanfield.cu: a Python loop over
    steps with the kernel's math, every branch.  ``state``: (8, d) rows
    (STATE_FIELDS), then COCOB's six ext rows; ``ad``: model "ad"'s program
    (its graph is replayed); returns ``(state, elbo (), trace (steps //
    log_every,) or None)``."""
    branch.codes()
    d = state.shape[1]
    n = n_samples
    inv_n = _f32(1.0 / n)
    rows = state.unbind(0)
    st = dict(zip(STATE_FIELDS, rows[:8]))
    st["ext"] = tuple(rows[8:])
    elbo = torch.zeros((), dtype=torch.float32, device=state.device)
    trace = []
    for s in range(steps):
        it = it0 + s
        u = _draw(noise, seed, it, s, n, d, state.device)
        mu, sig = st["mu"], st["sig"]
        z = mu + sig * u
        logpi, grad = _model_logpi_grad(model, consts, scalars, z, it, ad)
        logdet = torch.sum(torch.log(sig))
        if branch.grad_est == GE_SCOREGRAD:
            logq = -(torch.sum(0.5 * u * u, dim=1) + logdet + 0.5 * d * _L2PI)
            f = logq - logpi
            ci = ((f - inv_n * torch.sum(f)) * inv_n)[:, None]
            dmu = torch.sum(ci * (u / sig), dim=0)
            dsig = torch.sum(ci * ((u * u - 1.0) / sig), dim=0)
            elbo = inv_n * torch.sum(logpi - logq)
        else:
            g_z = -inv_n * (grad if branch.entropy == ENT_CF_ZERO else grad + u / sig)
            dmu = torch.sum(g_z, dim=0)
            dsig = torch.sum(g_z * u, dim=0)
            if branch.entropy == ENT_STL_ZERO:
                dsig = dsig + 1.0 / sig
            elbo = inv_n * torch.sum(logpi) + _entropy_value(branch, logdet, u, inv_n)
        c = np.float32(it) + np.float32(1.0)
        eta = _rule_step(branch, hyp, c, st, dmu, dsig)
        if branch.operator == OP_CLIP:
            st["sig"] = torch.clamp_min(st["sig"], hyp.clip_eps)
        elif branch.operator == OP_PROX:
            st["sig"] = _prox(st["sig"], eta)
        st["avg_mu"] = _avg(hyp, c, st["avg_mu"], st["mu"])
        st["avg_sig"] = _avg(hyp, c, st["avg_sig"], st["sig"])
        if log_every and (s + 1) % log_every == 0:
            trace.append(elbo)
    out = torch.stack([st[f] for f in STATE_FIELDS] + list(st["ext"]))
    return out, elbo, _trace_out(trace, log_every, state.device)


def fused_fullrank_run_chunk_reference(
    model: str, consts, scalars, vec, mat, seed, it0: int, steps: int,
    n_samples: int, hyp: FusedHyper, noise=None, log_every: int = 0,
    branch: FusedBranch = DEFAULT_BRANCH, ad: Optional[ADProgram] = None,
):
    """Plain version of csrc/fused_advi_fullrank.cu (the reference kernel's
    FULLRANK branches, VarGrad excepted): a Python loop over steps with the
    kernel's math.  ``vec``: (4, d) rows FR_VEC_FIELDS; ``mat``: (4, d, d)
    FR_MAT_FIELDS; each followed by COCOB's three ext rows or matrices.
    Only lower triangles move.  Returns ``(vec, mat, elbo (), trace
    (steps // log_every,) or None)``."""
    branch.codes()
    if branch.grad_est != GE_REPGRAD:
        raise ValueError("the full-rank fused engine has no VarGrad branch (mean-field only)")
    d = vec.shape[1]
    n = n_samples
    inv_n = _f32(1.0 / n)
    v, m = vec.unbind(0), mat.unbind(0)
    st = dict(zip(FR_VEC_FIELDS, v[:4]), **dict(zip(FR_MAT_FIELDS, m[:4])))
    st["ext"] = tuple(v[4:]) + tuple(m[4:])
    lower = torch.ones(d, d, dtype=torch.bool, device=vec.device).tril()
    elbo = torch.zeros((), dtype=torch.float32, device=vec.device)
    trace = []
    for s in range(steps):
        it = it0 + s
        u = _draw(noise, seed, it, s, n, d, vec.device)
        sig = st["sig"]
        C = torch.tril(sig)
        z = u @ C.T + st["mu"]
        logpi, grad = _model_logpi_grad(model, consts, scalars, z, it, ad)
        if branch.entropy == ENT_CF_ZERO:
            g_z = -inv_n * grad
        else:
            # whitening C^{-T} u_i, row form u C^{-1}
            whiten = torch.linalg.solve_triangular(C, u, upper=False, left=False)
            g_z = -inv_n * (grad + whiten)
        dmu = torch.sum(g_z, dim=0)
        dsig = torch.tril(g_z.T @ u)
        diag = torch.diagonal(sig)
        if branch.entropy == ENT_STL_ZERO:
            dsig = dsig + torch.diag(1.0 / diag)
        logdet = torch.sum(torch.log(diag))
        elbo = inv_n * torch.sum(logpi) + _entropy_value(branch, logdet, u, inv_n)
        c = np.float32(it) + np.float32(1.0)
        eta = _rule_step(branch, hyp, c, st, dmu, dsig, lower)
        post = torch.diagonal(st["sig"])
        if branch.operator == OP_CLIP:
            st["sig"] = torch.diagonal_scatter(st["sig"], torch.clamp_min(post, hyp.clip_eps))
        elif branch.operator == OP_PROX:
            st["sig"] = torch.diagonal_scatter(st["sig"], _prox(post, eta))
        st["avg_mu"] = _avg(hyp, c, st["avg_mu"], st["mu"])
        st["avg_sig"] = _avg(hyp, c, st["avg_sig"], st["sig"])
        if log_every and (s + 1) % log_every == 0:
            trace.append(elbo)
    ext = st["ext"]
    return (torch.stack([st[f] for f in FR_VEC_FIELDS] + list(ext[:3])),
            torch.stack([st[f] for f in FR_MAT_FIELDS] + list(ext[3:])),
            elbo, _trace_out(trace, log_every, vec.device))


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

_ARGS_HEAD = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_float, ctypes.c_float]
_ARGS_TAIL = (
    [ctypes.c_int] * 4
    + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64]
    + [ctypes.c_float] * 6
    + [ctypes.c_int] * 4 + [ctypes.c_float]
    + [ctypes.c_void_p]
)
_MEANFIELD_ARGTYPES = _ARGS_HEAD + [ctypes.c_void_p] * 5 + _ARGS_TAIL[:-1] \
    + [ctypes.c_void_p] * 2  # the workspace, the stream
_FULLRANK_ARGTYPES = _ARGS_HEAD + [ctypes.c_void_p] * 8 + _ARGS_TAIL
# the fused kernels' builds with per-phase cycle counters (phase_cycles,
# meanfield_phase_cycles)
PHASE_CLOCKS = ("AVI_PHASE_CLOCKS",)
PHASES = ("draws", "z", "model", "whitening", "rule")
# the mean-field step's phases (csrc/fused_meanfield_body.cuh): K5's body
# counts up to the barrier after log pi as "logits", the rest as "logpi"
MF_PHASES = ("draws_z", "row_sums", "logits", "logpi", "grad", "rule", "elbo_wait")


def _model_args(model: str, consts, scalars, d: int, dev, n: int = 0,
                ad: Optional[ADProgram] = None):
    """(c0, c1, n_data, db, batch, s0, s1) of a model, its shapes checked."""
    c0, c1 = consts
    if model == AD:
        if ad is None or (ad.n, ad.d) != (n, d):
            raise ValueError(
                f"model 'ad' needs the program of its (n, d) = ({n}, {d}); got "
                f"{None if ad is None else (ad.n, ad.d)}"
            )
        check_f32("AD float constants", c0, tuple(c0.shape), dev)
        if c1.dtype != torch.int32 or c1.device != dev or not c1.is_contiguous():
            raise ValueError("the AD int constants must be a contiguous int32 tensor")
        return c0, c1, 0, 0, 0, 0.0, 0.0
    if model == LOGREG or model in MINIBATCH_MODELS:
        n_data, db = c0.shape
        check_f32("X", c0, (n_data, db), dev)
        if db + 1 != d:
            raise ValueError(f"logreg with {db} features needs d = {db + 1}, got {d}")
        batch = 0
        if model == LOGREG:
            check_f32("y", c1, (n_data,), dev)
        else:
            nb = c1.shape[0]
            check_f32("yX", c1, (nb, db), dev)
            batch = n_data // max(nb, 1)
            if nb < 1 or batch * nb != n_data or batch % 8 or c0.data_ptr() % 16:
                raise ValueError(
                    f"a minibatch model needs X_perm of nb * B rows (B a multiple "
                    f"of 8, 16-byte aligned) and yX of nb rows, got {n_data} and {nb}"
                )
        return c0, c1, n_data, db, batch, float(scalars[0]), float(scalars[1])
    if model == MVNORMAL:
        check_f32("mean", c0, (d,), dev)
        check_f32("precision", c1, (d, d), dev)
    elif model == GAUSSIAN:
        check_f32("mean", c0, (d,), dev)
        check_f32("inverse variance", c1, (d,), dev)
    else:
        raise ValueError(f"no fused model {model!r} for this family")
    return c0, c1, 0, 0, 0, float(scalars[0]), 0.0


# the mean-field kernels' model groups of the device-memory layout, of the
# minibatch transports' device-memory layout, of the dense Gaussian and of
# the diagonal Gaussian (csrc/fused_meanfield_body.cuh ModelGroup kWide,
# kMbWide, kMvn, kGauss; the last csrc/fused_gauss_body.cuh, one
# column-fused pass a step, no workspace at any width)
KWIDE = 3
KMB_WIDE = 4
KMVN = 5
KGAUSS = 6

_KERNEL_PRECISION: dict = {}


def kernel_precision(P: torch.Tensor) -> torch.Tensor:
    """The dense Gaussian's precision P (d, d) as the mean-field and chains
    kernels read it (csrc/mvnormal_product.cuh): rows of round4(d) floats,
    zeros beyond column d, 16-byte aligned, so that every row is whole
    16-byte units for the TMA copies.  P itself where it already is (d a
    multiple of 4, contiguous and aligned); else a copy, made once per
    tensor and kept while the tensor lives and is not changed in place, so
    a chunk's launch copies nothing."""
    d = P.shape[0]
    ld = _round4(d)
    if ld == d and P.is_contiguous() and P.data_ptr() % 16 == 0:
        return P
    key = id(P)
    hit = _KERNEL_PRECISION.get(key)
    if hit is not None and hit[0]() is P and hit[1] == P._version:
        return hit[2]
    out = P.new_zeros(d, ld)
    out[:, :d] = P
    _KERNEL_PRECISION[key] = (weakref.ref(P, lambda _: _KERNEL_PRECISION.pop(key, None)),
                              P._version, out)
    return out


def fused_layout(lib: str, body: Optional[str] = None, defines=()):
    """``(code, n_data, db, batch, n, d, n_rows[, G]) -> (group, shared
    bytes, workspace floats a block, tier)`` of a launch of the mean-field
    (``lib`` "fused_advi_meanfield") or chains ("fused_chains", with G, the
    chains a block) kernel: the C side's ``launch_layout``
    (csrc/fused_meanfield_body.cuh).  The tier is -1 outside KWIDE and
    KMB_WIDE and KMVN; the diagonal Gaussian takes KGAUSS, with no
    workspace."""
    entry = "fused_chains_layout" if lib == "fused_chains" else "fused_advi_meanfield_layout"
    ints = 8 if lib == "fused_chains" else 7
    fn = _build.function(lib, entry, [ctypes.c_int] * ints + [ctypes.c_void_p],
                         restype=None, body=body, defines=defines)

    def query(*args):
        out = (ctypes.c_longlong * 4)()
        fn(*args, ctypes.addressof(out))
        return tuple(int(v) for v in out)

    return query


def workspace(floats: int, dev, what: str) -> Optional[torch.Tensor]:
    """The device workspace of a tiered launch (None when it needs none),
    allocated on ``dev`` for this launch and returned to the caching
    allocator after it (a later chunk reuses it).  A workspace the card
    cannot hold raises, naming its bytes."""
    if floats <= 0:
        return None
    try:
        return torch.empty(floats, dtype=torch.float32, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(f"{what}: its device workspace of {4 * floats} bytes does not fit "
                           f"the card's memory") from e


def layout_groups(model: str, group: int, tier: int) -> Tuple[str, ...]:
    """The LAUNCH_GROUPS a mean-field or chains launch adds by its model and
    layout: GROUP_MVNORMAL, and from tier 1 GROUP_DEVICE_LAYOUT (KWIDE, a
    hand model), GROUP_AD_DEVICE_LAYOUT (KWIDE, K5's body) or
    GROUP_MB_DEVICE_LAYOUT (KMB_WIDE)."""
    tiered = ()
    if tier >= 1:
        tiered = (GROUP_MB_DEVICE_LAYOUT if group == KMB_WIDE else
                  GROUP_AD_DEVICE_LAYOUT if model == AD else GROUP_DEVICE_LAYOUT,)
    return ((GROUP_MVNORMAL,) if model == MVNORMAL else ()) + tiered


def _check_branch_shape(branch: FusedBranch, d: int) -> Tuple[int, int, int, int]:
    codes = branch.codes()
    if branch.algo in (ALGO_DOWG, ALGO_DOG) and d < 2:
        raise ValueError(
            f"{branch.algo} keeps [v, r] in lanes 0 and 1 of v_mu: it needs d >= 2, got {d}"
        )
    return codes


def _count(wrapper, model: str, branch: FusedBranch, counter: str = "launches") -> None:
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    for g in branch.groups(model):
        wrapper.group_launches[g] += 1


def fused_run_chunk_cuda(
    model: str, consts, scalars, state, seed, it0: int, steps: int, n_samples: int,
    hyp: FusedHyper, noise=None, log_every: int = 0, branch: FusedBranch = DEFAULT_BRANCH,
    ad: Optional[ADProgram] = None, instrumented: bool = False,
):
    """Launch csrc/fused_advi_meanfield.cu on the current stream (same
    signature and results as ``fused_run_chunk_reference``; model "ad" runs
    the library built with ``ad``'s generated body).  Adds one to
    ``fused_run_chunk_cuda.launches`` per launch, and to each of the
    branch's LAUNCH_GROUPS in ``group_launches``.  ``instrumented``
    launches the build with per-phase cycle counters instead (PHASE_CLOCKS;
    read them with ``meanfield_phase_cycles``)."""
    dev = state.device
    if not state.is_cuda:
        raise ValueError(f"fused_run_chunk_cuda needs CUDA tensors, got {dev}")
    d = state.shape[1]
    n = int(n_samples)
    codes = _check_branch_shape(branch, d)
    if branch.grad_est == GE_SCOREGRAD and n < 2:
        raise ValueError(f"VarGrad needs n_samples >= 2, got {n}")
    n_rows = 8 + branch.ext_rows
    check_f32("state", state, (n_rows, d), dev)
    c0, c1, n_data, db, batch, s0, s1 = _model_args(model, consts, scalars, d, dev, n, ad)
    if model == MVNORMAL:
        c1 = kernel_precision(c1)
    if noise is not None:
        check_f32("noise", noise, (steps, n, d), dev)
    code = MODEL_CODES[model]
    body = ad.source if model == AD else None
    defines = PHASE_CLOCKS if instrumented else ()
    group, smem, ws_floats, tier = fused_layout("fused_advi_meanfield", body, defines)(
        code, n_data, db, batch, n, d, n_rows)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"the fused kernel keeps the state rows, the row sums and the block "
            f"reduction in shared memory at its last tier: {smem} bytes for "
            f"n_data={n_data}, batch={batch}, d={d}, n={n}, {n_rows} state rows is "
            f"over the {_build.SMEM_LIMIT}-byte limit of one block"
        )
    ws = workspace(ws_floats, dev, "fused_advi_meanfield")
    fn = _build.function("fused_advi_meanfield", "fused_advi_meanfield", _MEANFIELD_ARGTYPES,
                         body=body, defines=defines)
    out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    elbo = torch.empty((), dtype=torch.float32, device=dev)
    trace = (
        torch.empty(steps // log_every, dtype=torch.float32, device=dev)
        if log_every else None
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            code, c0.data_ptr(), c1.data_ptr(), n_data, db, batch, s0, s1,
            state.data_ptr(), out.data_ptr(), elbo.data_ptr(),
            trace.data_ptr() if trace is not None else None,
            noise.data_ptr() if noise is not None else None,
            n, d, steps, log_every, seed[0], seed[1], it0,
            hyp.lr, hyp.b1, hyp.b2, hyp.eps, hyp.avg_eta, hyp.clip_eps,
            *codes, branch.cocob_alpha, ws.data_ptr() if ws is not None else None, stream,
        )
    _build.check(err, f"fused_advi_meanfield launch (group {group}, tier {tier})")
    _count(fused_run_chunk_cuda, model, branch)
    for g in layout_groups(model, group, tier):
        fused_run_chunk_cuda.group_launches[g] += 1
    return out, elbo, trace


fused_run_chunk_cuda.launches = 0
fused_run_chunk_cuda.group_launches = dict.fromkeys(LAUNCH_GROUPS, 0)


def fused_run_chunk(model, consts, scalars, state, seed, it0, steps, n_samples, hyp,
                    noise=None, log_every=0, branch=DEFAULT_BRANCH, ad=None,
                    interpret=False):
    """The mean-field kernel for CUDA tensors, its plain version for CPU
    tensors or when ``interpret`` asks for it."""
    args = (model, consts, scalars, state, seed, it0, steps, n_samples, hyp, noise,
            log_every, branch, ad)
    if interpret:
        return fused_run_chunk_reference(*args)
    if state.is_cuda:
        return fused_run_chunk_cuda(*args)
    if state.device.type == "cpu":
        return fused_run_chunk_reference(*args)
    raise ValueError(f"no fused engine for device {state.device}")


# ---------------------------------------------------------------------------
# The full-rank kernel on a thread-block cluster (csrc/fused_advi_fullrank.cu
# fused_advi_fullrank_cluster_kernel): one chunk on cs blocks, split by
# output, bitwise the single-block kernel at every cs.
# ---------------------------------------------------------------------------

PANEL = 32  # the whitening's panel width (trisolve_rows.cuh kTriPanel)
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is non-portable: the card is asked before a launch
CLUSTER_MODELS = (LOGREG, MVNORMAL, GAUSSIAN)
CLUSTER_ALGOS = (ALGO_ADAM, ALGO_DESCENT, ALGO_COCOB)


def panel_owner(p: int, cs: int) -> int:
    """Panel p's block in a cluster of ``cs`` (the kernel's panel_owner):
    folded, so that panels p and np - 1 - p share a block."""
    q = p % (2 * cs)
    return q if q < cs else 2 * cs - 1 - q


def cluster_panels(d: int, cs: int) -> Tuple[Tuple[int, ...], ...]:
    """The panels (32 rows of C each, the last short) each block owns."""
    out = [[] for _ in range(cs)]
    for p in range(-(-d // PANEL)):
        out[panel_owner(p, cs)].append(p)
    return tuple(tuple(x) for x in out)


def cluster_smem_bytes():
    """``fused_advi_fullrank_cluster_smem_bytes(code, n_data, db, n, d, k,
    cs)`` of csrc/fused_advi_fullrank.cu: the dynamic shared memory a block
    of the cluster kernel takes (its make_cluster_layout and place_cluster:
    the model's data, the draws and samples, gradients, whitened draws,
    pushed panels and location rows; then, each where it still fits, the
    block's rows of the scale matrices, its panels' operators and its strip
    of C)."""
    return _build.function("fused_advi_fullrank", "fused_advi_fullrank_cluster_smem_bytes",
                           [ctypes.c_int] * 7, restype=ctypes.c_size_t)


def cluster_served(model: str, branch: FusedBranch) -> bool:
    """Whether the cluster kernel takes the launch: the full-data models and
    the rules without a sum over every entry (not DoWG or DoG)."""
    return model in CLUSTER_MODELS and branch.algo in CLUSTER_ALGOS \
        and branch.grad_est == GE_REPGRAD


# The least width at which the rule puts a served launch on the cluster, by
# model, or by model and rule where one differs: phase (m)'s route sweep on
# an H100 (chip_smoke.py route_sweep; PERF.md) timed every served model at
# d = 33, 62, 100, 200, 512 (the logreg at 33, 62, 128) under Adam,
# descent with STL-zero and prox, COCOB and closed-form-zero, at one block
# and every cluster size.  The Gaussians ran slower on two blocks than on
# one at d = 33 (by 10-43%), mvnormal under COCOB by 2-3% at d = 62; every
# other swept launch ran fastest on a block a panel.
CLUSTER_MIN_D = {LOGREG: 33, MVNORMAL: 62, GAUSSIAN: 62, (MVNORMAL, ALGO_COCOB): 100}


def cluster_blocks(model: str, d: int, n: int, branch: FusedBranch,
                   block_bytes: Callable[[int], int]) -> int:
    """The rule: the blocks of the cluster a full-rank launch runs on.

    1 (the single-block kernel) for what the cluster kernel does not serve:
    DoWG and DoG (their eta needs a sum over every entry before any moves),
    the minibatch models (the slab transports) and K5's "ad" body (its
    scratch is placed for one block); also below ``CLUSTER_MIN_D``, the
    sweep's least width at which the cluster paid (one panel always runs
    on one block).  Otherwise a block a whitening panel: the largest power
    of two up to 16 and the panels, halved until ``block_bytes(cs)`` (the
    kernel's layout, ``cluster_smem_bytes``) fits a block's shared memory.
    Between the swept widths it keeps a block a panel, the size each swept
    neighbour ran fastest on."""
    if not cluster_served(model, branch):
        return 1
    if d < CLUSTER_MIN_D.get((model, branch.algo), CLUSTER_MIN_D[model]):
        return 1
    cs = min(CLUSTER_SIZES[-1], 1 << ((-(-d // PANEL)).bit_length() - 1))
    while cs > 1 and block_bytes(cs) > _build.SMEM_LIMIT:
        cs //= 2
    return cs


def check_cluster(model: str, d: int, n: int, branch: FusedBranch, cs: int,
                  block_bytes: Optional[Callable[[int], int]] = None) -> int:
    """``cs`` if the cluster kernel can run this launch on ``cs`` blocks
    (1: the single-block kernel, always), else ValueError.  The layout's
    size is checked where ``block_bytes`` (the kernel's count) is given:
    the plain version, on the CPU, keeps nothing in shared memory."""
    if cs not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got {cs!r}")
    if cs == 1:
        return cs
    if not cluster_served(model, branch):
        raise ValueError(
            f"the cluster kernel does not serve model {model!r} with {branch.algo} "
            f"({branch.grad_est}): DoWG/DoG, the minibatch models and 'ad' run on one block"
        )
    panels = -(-d // PANEL)
    if cs > panels:
        raise ValueError(f"cluster={cs} is more blocks than d = {d}'s {panels} panels")
    need = None if block_bytes is None else block_bytes(cs)
    if need is not None and need > _build.SMEM_LIMIT:
        raise ValueError(f"cluster={cs}: {need} bytes of shared memory a block, over the "
                         f"{_build.SMEM_LIMIT}-byte limit")
    return cs


_CLUSTER_ACTIVE: Dict[tuple, int] = {}


def fullrank_layout(body: Optional[str] = None, defines=()):
    """``(code, n_data, db, batch, n, d, k) -> (tier, shared bytes,
    workspace floats)`` of a single-block launch of the full-rank kernel
    (the library built with ``body``, if any): csrc/fused_advi_fullrank.cu's
    ``fused_advi_fullrank_layout``.  The tier is -1 where every per-step
    array fits in shared memory (place()), else ``tier_layout``'s."""
    fn = _build.function("fused_advi_fullrank", "fused_advi_fullrank_layout",
                         [ctypes.c_int] * 7 + [ctypes.c_void_p], restype=None, body=body,
                         defines=defines)

    def query(*args):
        out = (ctypes.c_longlong * 3)()
        fn(*args, ctypes.addressof(out))
        return tuple(int(v) for v in out)

    return query


def cluster_max_active(code: int, n_data: int, db: int, n: int, d: int, k: int, cs: int,
                       defines=()) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster kernel at this
    layout and cs (0: the card cannot schedule one), asked once a shape."""
    key = (code, n_data, db, n, d, k, cs, tuple(defines))
    if key not in _CLUSTER_ACTIVE:
        out = ctypes.c_int(0)
        fn = _build.function("fused_advi_fullrank", "fused_advi_fullrank_cluster_max_active",
                             [ctypes.c_int] * 7 + [ctypes.c_void_p], defines=defines)
        _build.check(fn(code, n_data, db, n, d, k, cs, ctypes.addressof(out)),
                     "cudaOccupancyMaxActiveClusters")
        _CLUSTER_ACTIVE[key] = out.value
    return _CLUSTER_ACTIVE[key]


def fused_fullrank_run_chunk_cuda(
    model: str, consts, scalars, vec, mat, seed, it0: int, steps: int,
    n_samples: int, hyp: FusedHyper, noise=None, log_every: int = 0,
    branch: FusedBranch = DEFAULT_BRANCH, ad: Optional[ADProgram] = None,
    instrumented: bool = False, cluster: Optional[int] = None,
):
    """Launch csrc/fused_advi_fullrank.cu on the current stream (same
    signature and results as ``fused_fullrank_run_chunk_reference``): on a
    cluster of ``cluster_blocks(...)`` blocks, or of ``cluster`` when given
    (``check_cluster``), the single-block kernel when that is 1.  A cluster
    the card cannot schedule raises.  Adds one to
    ``fused_fullrank_run_chunk_cuda.launches`` per single-block launch and
    to ``cluster_launches`` per cluster launch, and to each of the branch's
    LAUNCH_GROUPS in ``group_launches`` (GROUP_FR_DEVICE_LAYOUT for a
    single-block launch on the tiered layout).  ``instrumented`` launches the
    build with per-phase cycle counters instead (PHASE_CLOCKS; read them
    with ``phase_cycles`` or ``cluster_phase_cycles``)."""
    dev = vec.device
    if not vec.is_cuda:
        raise ValueError(f"fused_fullrank_run_chunk_cuda needs CUDA tensors, got {dev}")
    d = vec.shape[1]
    n = int(n_samples)
    codes = _check_branch_shape(branch, d)
    if branch.grad_est != GE_REPGRAD:
        raise ValueError("the full-rank fused engine has no VarGrad branch (mean-field only)")
    k = 4 + branch.ext_rows // 2
    check_f32("vec", vec, (k, d), dev)
    check_f32("mat", mat, (k, d, d), dev)
    c0, c1, n_data, db, batch, s0, s1 = _model_args(model, consts, scalars, d, dev, n, ad)
    if noise is not None:
        check_f32("noise", noise, (steps, n, d), dev)
    code = MODEL_CODES[model]

    def block_bytes(size: int) -> int:  # asked only of launches the cluster serves
        return cluster_smem_bytes()(code, n_data, db, n, d, k, size)

    cs = (cluster_blocks(model, d, n, branch, block_bytes) if cluster is None
          else check_cluster(model, d, n, branch, cluster, block_bytes))
    body = ad.source if model == AD else None  # "ad" runs on one block
    defines = PHASE_CLOCKS if instrumented else ()
    tier, ws = -1, None
    if cs == 1:
        entry, extra = "fused_advi_fullrank", ()
        panels = -(-d // PANEL)
        tier, smem, ws_floats = fullrank_layout(body, defines)(code, n_data, db, batch, n, d, k)
        if smem > _build.SMEM_LIMIT:
            raise ValueError(
                f"the full-rank fused kernel keeps the location rows, the row sums and "
                f"the block reduction in shared memory at its last tier: {smem} bytes "
                f"for d={d}, n={n}, {k} location rows is over the {_build.SMEM_LIMIT}-byte "
                "limit of one block"
            )
        ws = workspace(ws_floats, dev, "fused_advi_fullrank")
        extra = (ws.data_ptr() if ws is not None else None,)
    else:  # the layout's size was checked by the rule or check_cluster
        entry, extra = "fused_advi_fullrank_cluster", (cs,)
        panels = cs * max(len(ps) for ps in cluster_panels(d, cs))
        if cluster_max_active(code, n_data, db, n, d, k, cs, defines) < 1:
            raise RuntimeError(f"the card cannot schedule a cluster of {cs} blocks of "
                               f"{block_bytes(cs)} bytes of shared memory "
                               "(cudaOccupancyMaxActiveClusters = 0)")
    # the single-block entry takes the workspace, the cluster's its size
    fn = _build.function("fused_advi_fullrank", entry,
                         _FULLRANK_ARGTYPES[:-1]
                         + [ctypes.c_void_p if cs == 1 else ctypes.c_int, ctypes.c_void_p],
                         body=body, defines=defines)
    vec_out = torch.empty_like(vec)
    mat_out = torch.empty_like(mat)
    # the whitening's panel operators, where they do not fit in shared memory
    inv = torch.empty(panels * 1024, dtype=torch.float32, device=dev)
    elbo = torch.empty((), dtype=torch.float32, device=dev)
    trace = (
        torch.empty(steps // log_every, dtype=torch.float32, device=dev)
        if log_every else None
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            code, c0.data_ptr(), c1.data_ptr(), n_data, db, batch, s0, s1,
            vec.data_ptr(), mat.data_ptr(), vec_out.data_ptr(), mat_out.data_ptr(),
            elbo.data_ptr(), trace.data_ptr() if trace is not None else None,
            noise.data_ptr() if noise is not None else None, inv.data_ptr(),
            n, d, steps, log_every, seed[0], seed[1], it0,
            hyp.lr, hyp.b1, hyp.b2, hyp.eps, hyp.avg_eta, hyp.clip_eps,
            *codes, branch.cocob_alpha, *extra, stream,
        )
    _build.check(err, f"{entry} launch (cluster={cs}, tier {tier})")
    _count(fused_fullrank_run_chunk_cuda, model, branch,
           "launches" if cs == 1 else "cluster_launches")
    if tier >= 1:
        fused_fullrank_run_chunk_cuda.group_launches[GROUP_FR_DEVICE_LAYOUT] += 1
    return vec_out, mat_out, elbo, trace


fused_fullrank_run_chunk_cuda.launches = 0
fused_fullrank_run_chunk_cuda.cluster_launches = 0
fused_fullrank_run_chunk_cuda.group_launches = dict.fromkeys(LAUNCH_GROUPS, 0)


# the cluster kernel's counters: rank 0's phases, its cycles inside cluster
# barriers (a part of the phases), the whitening's parts (W = U and the
# strip of C; the solves and pushes of W_p; the updates) and the mvnormal
# product before its barrier
CLUSTER_PHASES = PHASES + ("cluster_wait", "w_stage", "w_solve", "model_product", "w_update")


def cluster_phase_cycles() -> Dict[str, int]:
    """SM cycles that thread 0 of rank 0 of the instrumented cluster kernel
    spent in each phase (CLUSTER_PHASES) over the launches since the last
    call, summed; the counters restart at zero.  Waits for the queued work."""
    fn = _build.function("fused_advi_fullrank", "fused_advi_fullrank_cluster_phase_cycles",
                         [ctypes.c_void_p], defines=PHASE_CLOCKS)
    out = (ctypes.c_ulonglong * len(CLUSTER_PHASES))()
    _build.check(fn(ctypes.addressof(out)), "fused_advi_fullrank_cluster_phase_cycles")
    return dict(zip(CLUSTER_PHASES, out))


def cluster_barrier_cycles(cs: int, reps: int, device="cuda") -> int:
    """Rank 0's SM cycles for ``reps`` cluster barriers of one cluster of
    ``cs`` 512-thread blocks that does nothing else (the instrumented
    build's probe): a barrier's own cost."""
    out = torch.zeros((), dtype=torch.int64, device=device)
    fn = _build.function("fused_advi_fullrank", "fused_advi_fullrank_cluster_barrier_probe",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
                         defines=PHASE_CLOCKS)
    with torch.cuda.device(out.device):
        _build.check(fn(cs, reps, out.data_ptr(), torch.cuda.current_stream().cuda_stream),
                     "fused_advi_fullrank_cluster_barrier_probe")
    return int(out)


def phase_cycles() -> Dict[str, int]:
    """SM cycles that thread 0 of the instrumented full-rank kernel spent in
    each phase (PHASES) over the launches since the last call, summed; the
    counters restart at zero.  Waits for the queued work."""
    fn = _build.function("fused_advi_fullrank", "fused_advi_fullrank_phase_cycles",
                         [ctypes.c_void_p], defines=PHASE_CLOCKS)
    out = (ctypes.c_ulonglong * len(PHASES))()
    _build.check(fn(ctypes.addressof(out)), "fused_advi_fullrank_phase_cycles")
    return dict(zip(PHASES, out))


def meanfield_phase_cycles(ad: Optional[ADProgram] = None) -> Dict[str, int]:
    """SM cycles that thread 0 of the instrumented mean-field kernel (with
    ``ad``'s body, when given) spent in each phase (MF_PHASES) over the
    launches since the last call, summed; the counters restart at zero.
    Waits for the queued work."""
    fn = _build.function("fused_advi_meanfield", "fused_advi_meanfield_phase_cycles",
                         [ctypes.c_void_p], body=None if ad is None else ad.source,
                         defines=PHASE_CLOCKS)
    out = (ctypes.c_ulonglong * len(MF_PHASES))()
    _build.check(fn(ctypes.addressof(out)), "fused_advi_meanfield_phase_cycles")
    return dict(zip(MF_PHASES, out))


def fused_fullrank_run_chunk(model, consts, scalars, vec, mat, seed, it0, steps,
                             n_samples, hyp, noise=None, log_every=0,
                             branch=DEFAULT_BRANCH, ad=None, cluster=None, interpret=False):
    """The full-rank kernel for CUDA tensors, its plain version for CPU
    tensors or when ``interpret`` asks for it.  ``cluster`` forces the
    kernel's cluster size (checked on either device by ``check_cluster``,
    the layout's size on the card only; the plain version computes the same
    function at any size)."""
    args = (model, consts, scalars, vec, mat, seed, it0, steps, n_samples, hyp,
            noise, log_every, branch, ad)
    if interpret or vec.device.type == "cpu":
        if cluster is not None:
            check_cluster(model, vec.shape[1], int(n_samples), branch, cluster)
        return fused_fullrank_run_chunk_reference(*args)
    if vec.is_cuda:
        return fused_fullrank_run_chunk_cuda(*args, cluster=cluster)
    raise ValueError(f"no fused engine for device {vec.device}")


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def ad_smem_bytes(family: str, n: int, d: int, scratch: int, rows: int, stage: int = 0) -> int:
    """Dynamic shared memory of a launch on model "ad" with every array in
    shared memory (the kernels' make_layout for kAD): the draws, samples and
    gradients, ``rows`` state rows (mean-field and each chain's block; the
    full-rank kernel's (rows, d) location rows, its scale matrices and the
    whitening's panel operators left out, as they go to device memory when
    they do not fit), the per-row sums, the block reduction, the generated
    body's scratch (at a 16-byte offset) and its ``stage`` floats of staged
    constants."""
    return 4 * (_round4(_round4(_ad_kept(family, n, d, rows) + _ad_arrays(family, n, d))
                        + scratch) + stage)


def _ad_arrays(family: str, n: int, d: int) -> int:
    """Floats of the per-step (n, d) arrays: u, z, g (and the full-rank w)."""
    return (3 if family == MEANFIELD else 4) * n * d


def _ad_kept(family: str, n: int, d: int, rows: int) -> int:
    """Floats that stay in shared memory at the last tier: the ``rows``
    state (location) rows, the step's gradient, the row sums and the block
    reduction (fused_meanfield_body.cuh wide_layout_at, fused_advi_fullrank.cu
    tier_layout_at)."""
    if family == MEANFIELD:
        return rows * d + 2 * d + 7 * n + 1 + 33
    return rows * d + d + 6 * n + 1 + 33


def _fullrank_extras(nbytes: int, rows: int, d: int) -> int:
    """Bytes the full-rank kernel's place() adds in shared memory beside a
    layout of ``nbytes``: the scale matrices where they fit, then the
    whitening's panel operators where they fit too."""
    mat, inv = 4 * rows * d * d, 4096 * -(-d // 32)
    extra = mat if nbytes + mat <= _build.SMEM_LIMIT else 0
    return extra + (inv if nbytes + extra + inv <= _build.SMEM_LIMIT else 0)


def ad_program(spec: FusedModelSpec, n_samples: int, family: str = MEANFIELD,
               rows: int = 8) -> ADProgram:
    """The K5 program of an "ad" spec at ``n_samples`` rows (traced and
    emitted once).  Its float constants are staged in shared memory where
    they fit beside the engine's arrays (for the full-rank family: without
    moving the scale matrices or the panel operators out of shared memory),
    else read from device memory.  Where the arrays do not fit one block
    even so, the kernels take the unstaged body on their tiered layout (the
    body's scratch, then u, z, g (and w) in a device workspace); ValueError
    only where even the last tier's shared arrays, the state (location)
    rows, the step's gradient and the row sums, do not fit, never a smaller
    body."""
    if spec.ad is None:
        raise ValueError("a spec of model 'ad' carries its traced target: build it with "
                         "ad_spec, fused_spec_for or FusedModelSpec.from_log_density")
    n, d = n_samples, spec.dim
    prog = spec.ad.program(n_samples)
    need = ad_smem_bytes(family, n, d, prog.scratch, rows)
    staged = spec.ad.program(n_samples, staged=True)
    with_stage = ad_smem_bytes(family, n, d, staged.scratch, rows, staged.stage)
    if family == FULLRANK:
        with_stage += _fullrank_extras(need, rows, d)
    if with_stage <= _build.SMEM_LIMIT:
        return staged
    last = 4 * _ad_kept(family, n, d, rows)
    if last > _build.SMEM_LIMIT:
        raise ValueError(
            f"K5's body of {spec.ad.name} at n_samples={n_samples}, d={spec.dim}: the "
            f"{family} engine's last tier keeps {rows} state rows, the step's gradient "
            f"and the row sums in shared memory, {last} bytes, over the "
            f"{_build.SMEM_LIMIT}-byte limit of one block (fewer samples)"
        )
    return prog


class FusedADVI:
    """Whole-loop fused engine on a ``FusedModelSpec`` target, one kernel
    launch per ``steps`` chunk; the engine runs where the model's tensors
    lie.  Both families take every model (logreg, its minibatch versions,
    mvnormal, Gaussian, and "ad" specs: K5, traced and emitted at
    ``n_samples`` when the engine is built), mean-field at d <= D_PAD_MAX,
    full-rank at d <= D_FULLRANK_MAX.

    By default it reproduces ADVI + STL + Adam + ClipScale + polynomial
    averaging.  The branch is the plain attributes ``algo``, ``entropy``,
    ``grad_est`` and ``operator`` (JAX's string values; ``FusedProxADVI``
    and ``FusedScoreGradVI`` set them), ``alpha`` (DoWG/DoG's r0 scale) and
    ``cocob_alpha``; set ``algo`` before ``init``, which lays out the
    rule's state.  ``interpret=True`` runs the kernel's plain PyTorch
    version on any device (the counterpart of Pallas ``interpret=True``);
    ``False`` launches the kernel on a card and runs the plain version only
    for CPU tensors."""

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
        interpret: bool = False,
    ):
        if family not in (MEANFIELD, FULLRANK):
            raise ValueError(
                f"family must be '{MEANFIELD}' or '{FULLRANK}', got {family!r}"
            )
        known = (LOGREG, MVNORMAL, GAUSSIAN) + MINIBATCH_MODELS + (AD,)
        if model.model not in known:
            raise ValueError(f"unknown fused model {model.model!r}; known: {known}")
        if model.dim > D_PAD_MAX:
            raise ValueError(f"fused engine supports dim <= {D_PAD_MAX}, got {model.dim}")
        if family == FULLRANK and model.dim > D_FULLRANK_MAX:
            raise ValueError(
                f"the full-rank fused engine supports dim <= {D_FULLRANK_MAX}, "
                f"got {model.dim}"
            )
        if n_samples < 1:
            raise ValueError(f"n_samples must be >= 1, got {n_samples}")
        self.ad = ad_program(model, n_samples, family, 8 if family == MEANFIELD else 4) \
            if model.model == AD else None
        self.model = model
        self.family = family
        self.dim = model.dim
        self.n_samples = n_samples
        self.hyp = FusedHyper(lr, b1, b2, eps, avg_eta, clip_eps)
        self.algo = ALGO_ADAM
        self.entropy = ENT_STL
        self.grad_est = GE_REPGRAD
        self.operator = OP_CLIP
        self.alpha = 1e-6  # DoWG/DoG: r0 = alpha (1 + ||x0||)
        self.cocob_alpha = 100.0  # COCOB's bet-fraction floor (optim/rules.py)
        self.interpret = bool(interpret)

    def branch(self) -> FusedBranch:
        """The kernel branch of the engine's attributes, checked."""
        b = FusedBranch(self.algo, self.entropy, self.grad_est, self.operator,
                        float(self.cocob_alpha))
        _check_branch_shape(b, self.dim)
        if b.grad_est == GE_SCOREGRAD:
            if self.family != MEANFIELD:
                raise ValueError("the VarGrad fused engine is mean-field only")
            if self.n_samples < 2:
                raise ValueError(
                    "the VarGrad estimator needs n_samples >= 2 (sample "
                    f"variance), got {self.n_samples}"
                )
        return b

    def init(self, location: torch.Tensor, scale: torch.Tensor) -> FusedADVIState:
        """``scale``: the (d,) diagonal (mean-field) or the (d, d) factor
        (full-rank; its lower triangle is taken).  The rule's state follows
        ``self.algo`` (the JAX engine's layout)."""
        d = self.dim
        dev = self.model.device
        scale_shape = (d,) if self.family == MEANFIELD else (d, d)
        if tuple(location.shape) != (d,) or tuple(scale.shape) != scale_shape:
            raise ValueError(
                f"expected a ({d},) location and a {scale_shape} scale, got "
                f"{tuple(location.shape)} and {tuple(scale.shape)}"
            )
        self.branch()
        mu = location.detach().to(device=dev, dtype=torch.float32).clone()
        sig = scale.detach().to(device=dev, dtype=torch.float32).clone()
        if self.family == FULLRANK:
            sig = torch.tril(sig)
        zeros, zeros_s = torch.zeros_like(mu), torch.zeros_like(sig)
        m_mu, v_mu, m_sig, ext = zeros, zeros.clone(), zeros_s, None
        if self.algo == ALGO_COCOB:
            # x1 = m_*, L = v_* (zeros), (G, reward, theta) in ext
            m_mu, m_sig = mu.clone(), sig.clone()
            ext = (zeros.clone(), zeros.clone(), zeros.clone(),
                   zeros_s.clone(), zeros_s.clone(), zeros_s.clone())
        elif self.algo in (ALGO_DOWG, ALGO_DOG):
            # x0 = m_*, v_mu = [v, r, 0, ...], r0 = alpha (1 + ||x0||)
            m_mu, m_sig = mu.clone(), sig.clone()
            norm0 = torch.sqrt(torch.sum(mu * mu) + torch.sum(sig * sig))
            v_mu = torch.cat([zeros[:1], (np.float32(self.alpha) * (1.0 + norm0)).reshape(1),
                              zeros[2:]])
        return FusedADVIState(
            mu=mu, sig=sig, m_mu=m_mu, v_mu=v_mu, m_sig=m_sig,
            v_sig=zeros_s.clone(), avg_mu=mu.clone(), avg_sig=sig.clone(),
            iteration=0, elbo=torch.zeros((), dtype=torch.float32, device=dev), ext=ext,
        )

    def run_chunk(self, state: FusedADVIState, key: SeedLike, steps: int,
                  noise: Optional[torch.Tensor] = None,
                  model: Optional[FusedModelSpec] = None) -> FusedADVIState:
        """Advance ``steps`` iterations in one kernel launch.

        ``key``: an int, two seed words or a ``PhiloxKey`` (a
        ``torch.Generator`` is read once per call, so a chunked run needs
        one of the others).  ``noise``: optional (steps, n_samples, d) base
        draws replacing the Philox stream.  ``model``: a spec of the same
        kind and shapes replacing ``self.model`` (new data, same engine;
        ``optimize`` passes the reshuffled minibatch specs this way)."""
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
        branch = self.branch()
        cocob = branch.algo == ALGO_COCOB
        if cocob and state.ext is None:
            raise ValueError(
                "COCOB needs a state created with algo='cocob' "
                "(its ext accumulators are missing)"
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
        rows = (8 + branch.ext_rows) if self.family == MEANFIELD else 4 + branch.ext_rows // 2
        ad = ad_program(model, self.n_samples, self.family, rows) if model.model == AD else None
        consts = model.consts if ad is None else ad.consts
        args = (seed_words(key), state.iteration, steps, self.n_samples, self.hyp, noise,
                log_every, branch, ad)
        # another rule's ext rows ride through untouched
        keep = None if cocob else state.ext
        if self.family == FULLRANK:
            vec, mat = state.stacked_fullrank(with_ext=cocob)
            vec, mat, elbo, trace = fused_fullrank_run_chunk(
                model.model, consts, model.scalars, vec, mat, *args, interpret=self.interpret)
            return FusedADVIState.from_fullrank(vec, mat, it_end, elbo, keep), trace
        rows, elbo, trace = fused_run_chunk(
            model.model, consts, model.scalars, state.stacked(with_ext=cocob), *args,
            interpret=self.interpret)
        return FusedADVIState.from_stacked(rows, it_end, elbo, keep), trace

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

        A minibatch model is reshuffled between chunks, functionally: the
        loop threads the reshuffled spec through a local, keyed by the seed
        words and the iterations done, so the engine's own spec never
        changes and a second ``optimize`` starts from the same data order.

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
        model = self.model
        start = done = state.iteration
        end = start + max_iter
        while done < end:
            n = min(chunk, end - done)
            every = min(log_every, n)
            state, trace = self.run_chunk_traced(
                state, words, steps=(n // every) * every, log_every=every, model=model,
            )
            for g, e in enumerate(trace.tolist()):  # the chunk's one sync
                record(e, done + (g + 1) * every - start)
            done = state.iteration
            rem = n - (n // log_every) * log_every if n >= log_every else 0
            if rem:
                state = self.run_chunk(state, words, steps=rem, model=model)
                done = state.iteration
                record(float(state.elbo), done - start)
            if model.reshuffle is not None and done < end:
                model = replace(model, consts=model.reshuffle(words, done))
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


class FusedProxADVI(FusedADVI):
    """Whole-loop proximal ADVI: mean-field or full-rank x {descent, DoWG,
    DoG} with a zero-gradient entropy and the closed-form entropy proximal
    step; reproduces ``KLMinRepGradProxDescent(entropy_zerograd=entropy,
    optimizer=descent(lr) | dowg(alpha) | dog(alpha))`` with polynomial
    averaging.  With the default closed-form zero-gradient entropy the
    full-rank kernel skips the whitening solve."""

    def __init__(
        self,
        model: FusedModelSpec,
        family: str = MEANFIELD,
        n_samples: int = 10,
        optimizer: str = ALGO_DOWG,
        lr: float = 1e-3,
        alpha: float = 1e-6,
        entropy: str = ENT_CF_ZERO,
        avg_eta: float = 8.0,
        interpret: bool = False,
    ):
        if optimizer not in ETA_ALGOS:
            raise ValueError(
                f"optimizer must be one of {ETA_ALGOS}, got {optimizer!r} "
                "(proximal steps need an extractable step size - "
                "optim/rules.py stepsize_from_opt_state)"
            )
        if entropy not in (ENT_CF_ZERO, ENT_STL_ZERO):
            raise ValueError(
                "proximal engines need a zero-gradient entropy estimator "
                f"('{ENT_CF_ZERO}' or '{ENT_STL_ZERO}'), got {entropy!r}"
            )
        super().__init__(model, family=family, n_samples=n_samples, lr=lr,
                         avg_eta=avg_eta, interpret=interpret)
        self.algo = optimizer
        self.entropy = entropy
        self.operator = OP_PROX
        self.alpha = alpha


class FusedScoreGradVI(FusedADVI):
    """Whole-loop BBVI: the VarGrad score-function gradient
    (``KLMinScoreGradDescent``, objectives/scoregradelbo.py) with {Adam,
    descent, DoWG, DoG, COCOB} x {no operator, ClipScale}, mean-field only.
    The kernel evaluates log pi only, never its gradient.  Defaults mirror
    ``KLMinScoreGradDescent()``: DoWG, no operator (with its warning),
    polynomial averaging; n_samples >= 2."""

    def __init__(
        self,
        model: FusedModelSpec,
        n_samples: int = 10,
        optimizer: str = ALGO_DOWG,
        lr: float = 1e-3,
        alpha: float = 1e-6,
        operator: str = OP_NONE,
        avg_eta: float = 8.0,
        clip_eps: float = 1e-5,
        interpret: bool = False,
    ):
        if optimizer not in ALGO_CODES:
            raise ValueError(
                f"optimizer must be one of {tuple(ALGO_CODES)}, got {optimizer!r}"
            )
        if operator not in (OP_NONE, OP_CLIP):
            raise ValueError(
                f"operator must be '{OP_NONE}' or '{OP_CLIP}', got "
                f"{operator!r} (the entropy proximal step is specific to "
                "the zero-gradient RepGrad objectives)"
            )
        if n_samples < 2:
            raise ValueError(
                "the VarGrad estimator needs n_samples >= 2 (sample "
                f"variance), got {n_samples}"
            )
        if operator == OP_NONE:
            warnings.warn(
                "IdentityOperator is used with a location-scale variational "
                "family. Optimization can fail due to singular scale "
                "matrices; consider using ClipScale."
            )
        super().__init__(model, family=MEANFIELD, n_samples=n_samples, lr=lr,
                         avg_eta=avg_eta, clip_eps=clip_eps, interpret=interpret)
        self.algo = optimizer
        self.grad_est = GE_SCOREGRAD
        self.operator = operator
        self.alpha = alpha


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
        interpret: bool = False,
    ):
        super().__init__(
            logreg_spec(X, y, prior_scale=prior_scale, likeadj=likeadj),
            family=MEANFIELD, n_samples=n_samples, lr=lr, b1=b1, b2=b2,
            eps=eps, avg_eta=avg_eta, clip_eps=clip_eps, interpret=interpret,
        )
