"""The port's host targets (advancedvi_jl_tpu_torch.core.external) against
the JAX package: order 0 through BBVI and refused by ADVI with the JAX
messages, an order-1 oracle's gradient through autograd, and NGD's Stein
path on an external quadratic (tests/test_integration.py:73-120)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.core.external import ExternalTarget as JaxExternalTarget
from advancedvi_jl_tpu_torch.core.problem import ORDER_GRAD, ORDER_VALUE_ONLY, order_of

torch.set_num_threads(1)


def value_only(theta):
    return (-0.5 * np.sum(np.square(theta - 1.0), axis=-1)).astype(theta.dtype)


A = np.array([[2.0, 0.3, 0.0], [0.3, 1.5, 0.2], [0.0, 0.2, 1.0]], np.float32)
B = np.array([1.0, -0.5, 0.25], np.float32)


def quad(theta):
    return (-0.5 * np.sum((theta @ A) * theta, axis=-1) + theta @ B).astype(theta.dtype)


def quad_grad(theta):
    return (-(theta @ A) + B).astype(theta.dtype)


def test_value_only_trains_by_scoregrad_in_one_host_call_a_step():
    calls = []

    def host_fn(theta):
        calls.append(theta.shape)
        return value_only(theta)

    target = avt.ExternalTarget(host_fn=host_fn, dim=3)
    assert order_of(target) == ORDER_VALUE_ONLY
    alg = avt.KLMinScoreGradDescent(n_samples=64, optimizer=avt.descent(5e-3),
                                    operator=avt.ClipScale())
    out, _, _ = avt.optimize(0, alg, 500, target,
                             avt.MeanFieldGaussian(torch.zeros(3), torch.ones(3)))
    assert_allclose(out.location.numpy(), np.ones(3), atol=0.15)
    assert calls and all(s == (64, 3) for s in calls)


def test_value_only_is_refused_with_the_jax_messages():
    jt = JaxExternalTarget(host_fn=value_only, dim=3)
    tt = avt.ExternalTarget(host_fn=value_only, dim=3)
    jq, tq = javt.MeanFieldGaussian(jnp.zeros(3)), avt.MeanFieldGaussian(torch.zeros(3))
    with pytest.raises(ValueError) as jerr:
        javt.KLMinRepGradDescent().init(jax.random.key(0), jq, jt)
    with pytest.raises(ValueError) as terr:
        avt.KLMinRepGradDescent().init(0, tq, tt)
    assert str(terr.value) == str(jerr.value)
    jfq, tfq = javt.FullRankGaussian(jnp.zeros(3)), avt.FullRankGaussian(torch.zeros(3))
    with pytest.raises(ValueError) as jerr:
        javt.KLMinNaturalGradDescent(stepsize=0.1).init(jax.random.key(0), jfq, jt)
    with pytest.raises(ValueError) as terr:
        avt.KLMinNaturalGradDescent(stepsize=0.1).init(0, tfq, tt)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="no gradient oracle"):
        tt.log_density_and_grad(torch.zeros(2, 3))


def test_oracle_gradient_through_autograd():
    """Differentiating log_density of an order-1 target gives ct times the
    host gradient, one host call for the values and gradients of a batch."""
    calls = []

    def host_grad(theta):
        calls.append(theta.shape)
        return quad_grad(theta)

    target = avt.ExternalTarget(host_fn=quad, dim=3, host_grad_fn=host_grad)
    assert order_of(target) == ORDER_GRAD
    x = torch.tensor(np.random.default_rng(0).standard_normal((5, 3)), dtype=torch.float32,
                     requires_grad=True)
    ct = torch.arange(1.0, 6.0)
    (g,) = torch.autograd.grad(target.log_density(x), x, ct)
    assert_allclose(g.numpy(), ct[:, None].numpy() * quad_grad(x.detach().numpy()), rtol=1e-6)
    assert calls == [(5, 3)]
    v, g1 = target.log_density_and_grad(x.detach())
    assert_allclose(v.numpy(), quad(x.detach().numpy()), rtol=1e-6)
    assert_allclose(g1.numpy(), quad_grad(x.detach().numpy()), rtol=1e-6)


def test_oracle_feeds_advi():
    """tests/test_integration.py:96: ADVI on an order-1 host oracle."""
    target = avt.ExternalTarget(
        host_fn=lambda t: (-0.5 * np.sum(np.square(t + 2.0), -1)).astype(t.dtype), dim=2,
        host_grad_fn=lambda t: (-(t + 2.0)).astype(t.dtype))
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=16, optimizer=avt.descent(1e-2),
                                  operator=avt.ClipScale())
    out, _, _ = avt.optimize(0, alg, 800, target,
                             avt.MeanFieldGaussian(torch.zeros(2), torch.ones(2)))
    assert_allclose(out.location.numpy(), -2.0 * np.ones(2), atol=0.1)
    assert_allclose(out.scale_diag.numpy(), np.ones(2), atol=0.1)


def test_ngd_stein_path_on_an_external_quadratic():
    """NGD takes the Stein path on an order-1 host target: one step equals
    the JAX package's with its draws injected, and 300 steps reach the
    Gaussian posterior N(A^-1 b, A^-1) (at 256 samples a step: at a fixed
    step size the iterate keeps the Stein estimate's noise, ~10% of the
    covariance at 64)."""
    jt = JaxExternalTarget(host_fn=quad, dim=3, host_grad_fn=quad_grad)
    tt = avt.ExternalTarget(host_fn=quad, dim=3, host_grad_fn=quad_grad)
    jalg = javt.KLMinNaturalGradDescent(stepsize=0.2, n_samples=64)
    talg = avt.KLMinNaturalGradDescent(stepsize=0.2, n_samples=64)
    js = jalg.init(jax.random.key(0), javt.FullRankGaussian(jnp.zeros(3)), jt)
    ts = talg.init(0, avt.FullRankGaussian(torch.zeros(3)), tt)
    u = js.q.base.sample(jax.random.fold_in(js.key, js.iteration), (64, 3), jnp.float32)
    js, jinfo = jalg.step(js)
    ts, tinfo = talg.step(ts, noise=torch.tensor(np.asarray(u)))
    assert_allclose(ts.q.location.numpy(), np.asarray(js.q.location), rtol=1e-5, atol=1e-6)
    assert_allclose(ts.q.scale.numpy(), np.asarray(js.q.scale), rtol=1e-5, atol=1e-6)
    assert_allclose(float(tinfo["elbo"]), float(jinfo["elbo"]), rtol=1e-4)
    out, _, _ = avt.optimize(0, avt.KLMinNaturalGradDescent(stepsize=0.2, n_samples=256), 300,
                             tt, avt.FullRankGaussian(torch.zeros(3)))
    A64 = A.astype(np.float64)
    assert_allclose(out.location.numpy(), np.linalg.solve(A64, B), atol=0.1)
    assert_allclose(out.cov().numpy(), np.linalg.inv(A64), atol=0.1)
