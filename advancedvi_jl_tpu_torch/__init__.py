"""advancedvi_jl_tpu_torch — the PyTorch/CUDA port of advancedvi_jl_tpu.

The JAX package ``advancedvi_jl_tpu`` is the reference; this package mirrors
its module tree and public names for the slices ported so far: mean-field
and full-rank Gaussian ADVI (``KLMinRepGradDescent`` with the closed-form,
Monte-Carlo or STL entropy), proximal ADVI (``KLMinRepGradProxDescent``
with a zero-gradient entropy and the entropy's proximal step) and BBVI
(``KLMinScoreGradDescent``, the VarGrad score gradient), with Adam,
descent, DoWG, DoG or COCOB, ClipScale and polynomial averaging, driven by
``optimize``, each with ``subsampling=`` for doubly-stochastic VI
(``ReshufflingBatchSubsampling``, ``SubsampledObjective``, ``subsample``,
``factorized_target``; the BNN of ``models/bnn.py``); and the whole-loop
fused engines (``FusedADVI``, ``FusedLogRegADVI``, ``FusedProxADVI``,
``FusedScoreGradVI``) on hierarchical logistic regression, its minibatch
version (``logreg_minibatch_spec``, ``logreg_minibatch_hbm_spec``), diagonal
Gaussian targets (``gaussian_spec``, ``normallognormal_spec``) and,
full-rank, dense Gaussian targets (``mvnormal_spec``), and any traceable
target (``ad_spec``, ``fused_spec_for``: a model body generated from its
autograd graph; ``fn_target``, ``CustomGradTarget``); the low-rank family
(``LowRankGaussian``); many chains at once, on the general path
(``parallel.chains.optimize_chains``) or in one fused launch
(``FusedChainsADVI``); the measure-space algorithms
(``KLMinNaturalGradDescent``, ``KLMinSqrtNaturalGradDescent``,
``KLMinWassFwdBwd``, ``FisherMinBatchMatch``) on the full-rank family,
algorithm-driven early stopping (``WithTermination``, ``elbo_at_least``),
Pathfinder (``pathfinder``, ``multipath_pathfinder``) with the PSIS
diagnostics (``pareto_khat``, ``importance_diagnostics``), host targets
(``ExternalTarget``); and ``estimate_objective``.  Constructors that
create tensors put them on the card unless the caller asks for the CPU.  Families and states are
dataclasses of tensors; random draws are step-indexed Philox normals keyed
by two uint32 seed words.  On CUDA tensors the draws, the triangular
solves and the fused loops run in hand-written Hopper kernels (csrc/), built
with nvcc at first use; on CPU tensors they run the kernels' plain PyTorch
versions.
"""

from .core.problem import (
    ORDER_AUTOGRAD,
    ORDER_GRAD,
    ORDER_HESS,
    ORDER_JAX,
    ORDER_VALUE_ONLY,
    CustomGradTarget,
    FnTarget,
    dim_of,
    fn_target,
    log_density,
    log_density_and_grad,
    log_density_grad_and_hess,
    maybe_wrap_custom_grad,
    order_of,
    subsample,
)
from .core.factorized import FactorizedTarget, factorized_target
from .core.pytree import tree_stop_gradient
from .core.transforms import Exp, Identity, Stacked, TransformedTarget, stacked
from .families.base import Normal
from .families.location_scale import (
    FullRankGaussian,
    FullRankLocationScale,
    MeanFieldGaussian,
    MeanFieldLocationScale,
)
from .families.low_rank import LowRankGaussian, LowRankLocationScale
from .objectives.entropy import (
    ALL_ENTROPY_ESTIMATORS,
    CLOSED_FORM,
    CLOSED_FORM_ZERO_GRAD,
    MONTE_CARLO,
    STL,
    STL_ZERO_GRAD,
    ZERO_GRAD_ESTIMATORS,
    estimate_entropy,
)
from .objectives.repgradelbo import RepGradELBO
from .objectives.scoregradelbo import ScoreGradELBO
from .objectives.subsampled import SubsampledObjective
from .subsampling import ReshufflingBatchSubsampling, ReshufflingState
from .models.bnn import BayesianMLP, make_bnn
from .models.subsampled_normals import subsampled_normals
from .optim.averaging import NoAveraging, PolynomialAveraging
from .optim.operators import ClipScale, IdentityOperator, ProximalLocationScaleEntropy
from .optim.rules import adam, cocob, descent, dog, dowg, stepsize_from_opt_state
from .algorithms.paramspace import (
    ADVI,
    BBVI,
    KLMinRepGradDescent,
    KLMinRepGradProxDescent,
    KLMinScoreGradDescent,
    ParamSpaceSGD,
)
from .algorithms.measure_space import (
    FisherMinBatchMatch,
    KLMinNaturalGradDescent,
    KLMinSqrtNaturalGradDescent,
    KLMinWassFwdBwd,
)
from .algorithms.termination import WithTermination, elbo_at_least
from .algorithms.pathfinder import PathfinderResult, multipath_pathfinder, pathfinder
from .core.external import ExternalTarget
from .utils.diagnostics import importance_diagnostics, pareto_khat
from .optimize import DivergenceError, optimize
from .estimate import estimate_objective
from .ops.cuda.fused_advi import (  # whole-loop fused engines (CUDA)
    FusedADVI,
    FusedLogRegADVI,
    FusedModelSpec,
    FusedProxADVI,
    FusedScoreGradVI,
    ad_spec,
    fused_spec_for,
    gaussian_spec,
    logreg_minibatch_hbm_spec,
    logreg_minibatch_spec,
    logreg_spec,
    mvnormal_spec,
    normallognormal_spec,
)
from .ops.cuda.fused_chains import FusedChainsADVI  # one launch for C chains (CUDA)

__version__ = "0.6.0"
