"""Port parity: the logreg target, transforms and target protocol
(advancedvi_jl_tpu_torch.models.logreg / core) against the JAX package.

The data are JAX's ``make_logreg(key(11), 208, 60)``, carried across as numpy
with ``convert.py``; evaluation points come from ``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import bench
from advancedvi_jl_tpu.core.transforms import Exp as JExp
from advancedvi_jl_tpu.core.transforms import Identity as JIdentity
from advancedvi_jl_tpu.core.transforms import stacked as jstacked
from advancedvi_jl_tpu.models.logreg import make_logreg as jax_make_logreg
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.core import problem
from advancedvi_jl_tpu_torch.core.transforms import Exp, Identity, stacked
from advancedvi_jl_tpu_torch.models.logreg import make_logreg

torch.set_num_threads(1)

N_POINTS = 16


@pytest.fixture(scope="module")
def pair():
    jprob = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
    tprob = convert.logreg_from_numpy(
        jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale, device="cpu"
    )
    return jprob, tprob


def _points(d, seed=0):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((N_POINTS, d))).astype(np.float32)


def test_unconstrained_log_density_matches_jax(pair):
    jprob, tprob = pair
    th = _points(jprob.dim)
    want = jax.vmap(jprob.unconstrained().log_density)(jnp.asarray(th))
    got = tprob.unconstrained().log_density(torch.from_numpy(th))
    assert got.shape == (N_POINTS,)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_unconstrained_grad_matches_jax(pair):
    jprob, tprob = pair
    th = _points(jprob.dim, seed=1)
    want = jax.vmap(jax.grad(jprob.unconstrained().log_density))(jnp.asarray(th))
    value, grad = problem.log_density_and_grad(
        tprob.unconstrained(), torch.from_numpy(th)
    )
    assert_allclose(grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    assert not value.requires_grad


def test_constrained_log_density_matches_jax(pair):
    jprob, tprob = pair
    th = _points(jprob.dim, seed=2)
    th[:, -1] = np.exp(th[:, -1])  # sigma > 0
    want = jax.vmap(jprob.log_density)(jnp.asarray(th))
    got = tprob.log_density(torch.from_numpy(th))
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_make_logreg_shapes_pinned_to_bench_config():
    cfg = bench.BENCH_CONFIG
    prob = make_logreg(cfg["data_seed"], cfg["n_data"], cfg["n_features"], device="cpu")
    assert prob.X.shape == (cfg["n_data"], cfg["n_features"] + 1)
    assert prob.y.shape == (cfg["n_data"],)
    assert prob.dim == cfg["n_features"] + 2 == 62
    feats = prob.X[:, :-1]
    assert_allclose(feats.mean(0).numpy(), 0.0, atol=1e-5)
    assert_allclose(feats.std(0, correction=0).numpy(), 1.0, rtol=1e-5)
    assert torch.all(prob.X[:, -1] == 1.0)
    assert set(prob.y.unique().tolist()) <= {0.0, 1.0}
    again = make_logreg(cfg["data_seed"], cfg["n_data"], cfg["n_features"], device="cpu")
    assert torch.equal(prob.X, again.X) and torch.equal(prob.y, again.y)


def test_stacked_transform_matches_jax():
    th = _points(5, seed=3)
    jt = jstacked((JIdentity(), 3), (JExp(), 2))
    tt = stacked((Identity(), 3), (Exp(), 2))
    jy, jl = jax.vmap(jt.forward_and_ldj)(jnp.asarray(th))
    ty, tl = tt.forward_and_ldj(torch.from_numpy(th))
    assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6)
    assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    assert_allclose(tt.inverse(ty).numpy(), th, rtol=1e-5, atol=1e-6)


def test_target_protocol_helpers(pair):
    _, tprob = pair
    target = tprob.unconstrained()
    assert problem.dim_of(target) == 62
    assert problem.order_of(target) == problem.ORDER_AUTOGRAD
    assert problem.order_of(object()) == problem.ORDER_AUTOGRAD
    th = torch.from_numpy(_points(62, seed=4))
    assert torch.equal(problem.log_density(target, th), target.log_density(th))
