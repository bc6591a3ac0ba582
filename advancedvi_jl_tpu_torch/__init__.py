"""advancedvi_jl_tpu_torch — the PyTorch/CUDA port of advancedvi_jl_tpu.

The JAX package ``advancedvi_jl_tpu`` is the reference; this package mirrors
its module tree and public names for the slice ported so far: mean-field
Gaussian ADVI (``KLMinRepGradDescent`` with the closed-form, Monte-Carlo or
STL entropy, Adam or DoWG, ClipScale, polynomial averaging) driven by
``optimize``, and the whole-loop fused engine ``FusedLogRegADVI`` on
hierarchical logistic regression.  Families and states are dataclasses of
tensors; random draws are step-indexed Philox normals keyed by two uint32
seed words.  On CUDA tensors the draws and the fused loop run in hand-written
Hopper kernels (csrc/), built with nvcc at first use; on CPU tensors they run
the kernels' plain PyTorch versions.
"""

from .core.problem import (
    ORDER_AUTOGRAD,
    ORDER_GRAD,
    ORDER_HESS,
    ORDER_JAX,
    ORDER_VALUE_ONLY,
    dim_of,
    log_density,
    log_density_and_grad,
    order_of,
)
from .core.pytree import tree_stop_gradient
from .core.transforms import Exp, Identity, Stacked, TransformedTarget, stacked
from .families.base import Normal
from .families.location_scale import MeanFieldGaussian, MeanFieldLocationScale
from .objectives.entropy import CLOSED_FORM, MONTE_CARLO, STL, estimate_entropy
from .objectives.repgradelbo import RepGradELBO
from .optim.averaging import NoAveraging, PolynomialAveraging
from .optim.operators import ClipScale, IdentityOperator
from .optim.rules import adam, dowg
from .algorithms.paramspace import ADVI, KLMinRepGradDescent, ParamSpaceSGD
from .optimize import DivergenceError, optimize
from .ops.cuda.fused_advi import (  # whole-loop fused engine (CUDA)
    FusedADVI,
    FusedLogRegADVI,
    FusedModelSpec,
    logreg_spec,
)

__version__ = "0.5.0"
