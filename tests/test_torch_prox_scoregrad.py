"""Port parity: proximal ADVI and score-gradient BBVI on the general path
(advancedvi_jl_tpu_torch.algorithms.paramspace ``KLMinRepGradProxDescent``,
``KLMinScoreGradDescent``; objectives/scoregradelbo.py; the zero-gradient
entropies; optim/rules.py descent, dog, cocob; optim/operators.py
``ProximalLocationScaleEntropy``; models/normallognormal.py) against the JAX
package.

The JAX algorithm runs T steps while its base draws are captured (the
tests/test_fused_advi.py pattern); the port's ``step`` takes the same draws
through ``noise=`` and must land on the same state within the tolerances of
tests/test_fused_advi.py: 1e-5 on the parameters, 1e-4 on the DoWG/DoG
accumulators and the ELBO, 1e-4 (theta 1e-3 absolute) on COCOB's.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.models.logreg import make_logreg as jax_make_logreg
from advancedvi_jl_tpu.models.normallognormal import make_normallognormal as jax_make_nln
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.models.normallognormal import make_normallognormal
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import PhiloxKey, seed_words
from advancedvi_jl_tpu_torch.optim.rules import apply_updates, stepsize_from_opt_state

torch.set_num_threads(1)

T = 5
N = 10
TOL = dict(rtol=1e-5, atol=1e-6)
# DoWG and DoG tests use r0 = ALPHA (1 + |x0|) with ALPHA 1e-2, not the
# default 1e-6: with 1e-6 the first steps move a scale of 0.1 by ~1e-7, a
# dozen float32 ulps, so |x - x0| (and so r, v and every later step) is set
# by the rounding of the update; the port and the JAX package, which sum
# the gradient in other orders, then differ by 0.2-2% after 5 steps.  With
# 1e-2 they agree to ~1e-7.
ALPHA = 1e-2


@pytest.fixture(scope="module")
def flagship():
    jprob = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device="cpu")
    return jprob, tprob


@pytest.fixture(scope="module")
def nln():
    """make_normallognormal(n_dims=10), d = 11, and the JAX prox test's
    full-rank start (tests/test_fused_advi.py:644-650)."""
    jt, mu, sd = jax_make_nln(jax.random.key(7), n_dims=10)
    tt = convert.normallognormal_from_numpy(jt.mu_y, jt.sigma_y, jt.mu_x, jt.sigma_x, device="cpu")
    d = jt.dim
    C0 = 0.2 * jnp.eye(d) + 0.05 * jnp.tril(jax.random.normal(jax.random.key(3), (d, d)), -1)
    return jt, tt, 0.3 * np.ones(d, np.float32), np.asarray(C0, np.float32)


def _jax_run(jalg, jtarget, jq0, steps=T):
    state = jalg.init(jax.random.key(0), jq0, jtarget)
    step = jax.jit(jalg.step)
    draws, infos = [], []
    for _ in range(steps):
        step_key = jax.random.fold_in(state.key, state.iteration)
        _, u = state.q.sample_with_base(step_key, N)
        draws.append(np.asarray(u))
        state, info = step(state)
        infos.append(info)
    return state, draws, infos


def _port_run(talg, ttarget, tq0, draws):
    state = talg.init(0, tq0, ttarget)
    infos = []
    for u in draws:
        state, info = talg.step(state, noise=convert.to_tensor(u, device="cpu"))
        infos.append(info)
    return state, infos


def _mf_q0(d):
    return (javt.MeanFieldGaussian(jnp.zeros(d), 0.1 * jnp.ones(d)),
            avt.MeanFieldGaussian(torch.zeros(d), 0.1 * torch.ones(d)))


def _assert_meanfield(tq, jq, tol=TOL):
    assert_allclose(tq.location.numpy(), jq.location, **tol)
    assert_allclose(tq.scale_diag.numpy(), jq.scale_diag, **tol)


def _assert_elbos(tinfos, jinfos):
    for ti, ji in zip(tinfos, jinfos):
        assert_allclose(float(ti["elbo"]), float(ji["elbo"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rule", ["dowg", "dog"])
def test_prox_distance_rule_meanfield_matches_jax(flagship, rule):
    """KLMinRepGradProxDescent(closed_form_zero_grad, dowg | dog) on the
    flagship (tests/test_fused_advi.py:583, :1085): parameters, averages,
    [v, r] and ELBOs."""
    jprob, tprob = flagship
    jq0, tq0 = _mf_q0(jprob.dim)
    jalg = javt.KLMinRepGradProxDescent(entropy_zerograd=javt.CLOSED_FORM_ZERO_GRAD,
                                        n_samples=N, optimizer=getattr(javt, rule)(ALPHA))
    talg = avt.KLMinRepGradProxDescent(entropy_zerograd=avt.CLOSED_FORM_ZERO_GRAD,
                                       n_samples=N, optimizer=getattr(avt, rule)(ALPHA))
    js, draws, jinfos = _jax_run(jalg, jprob.unconstrained(), jq0)
    ts, tinfos = _port_run(talg, tprob.unconstrained(), tq0, draws)
    _assert_meanfield(ts.q, js.q)
    _assert_meanfield(talg.output(ts), jalg.output(js))
    assert_allclose(float(ts.opt_state.v), float(js.opt_state.v), rtol=1e-4)
    assert_allclose(float(ts.opt_state.r), float(js.opt_state.r), rtol=1e-4)
    assert_allclose(float(stepsize_from_opt_state(ts.opt_state)),
                    float(javt.stepsize_from_opt_state(js.opt_state)), rtol=1e-4)
    _assert_elbos(tinfos, jinfos)


def test_prox_descent_fullrank_stl_zero_matches_jax(nln):
    """KLMinRepGradProxDescent(stl_zero_grad, descent(1e-3)) on the
    full-rank family and normal-lognormal (tests/test_fused_advi.py:637):
    the +1/diag correction and the diagonal-only prox."""
    jt, tt, loc0, C0 = nln
    jq0 = javt.FullRankGaussian(jnp.asarray(loc0), jnp.asarray(C0))
    tq0 = convert.fullrank_from_numpy(loc0, C0, solve_mode="pallas", device="cpu")
    jalg = javt.KLMinRepGradProxDescent(entropy_zerograd=javt.STL_ZERO_GRAD, n_samples=N,
                                        optimizer=javt.descent(1e-3))
    talg = avt.KLMinRepGradProxDescent(entropy_zerograd=avt.STL_ZERO_GRAD, n_samples=N,
                                       optimizer=avt.descent(1e-3))
    js, draws, jinfos = _jax_run(jalg, jt.unconstrained(), jq0)
    ts, tinfos = _port_run(talg, tt.unconstrained(), tq0, draws)
    assert_allclose(ts.q.location.numpy(), js.q.location, **TOL)
    assert_allclose(ts.q.scale.numpy(), np.tril(np.asarray(js.q.scale)), **TOL)
    jout, tout = jalg.output(js), talg.output(ts)
    assert_allclose(tout.location.numpy(), jout.location, **TOL)
    assert_allclose(tout.scale.numpy(), np.tril(np.asarray(jout.scale)), **TOL)
    assert torch.equal(torch.triu(ts.q.scale, 1), torch.zeros(11, 11))
    _assert_elbos(tinfos, jinfos)


def test_scoregrad_dowg_matches_jax(flagship):
    """KLMinScoreGradDescent with its default rule and operator (VarGrad,
    DoWG, IdentityOperator) on the flagship (tests/test_fused_advi.py:697): the info ELBO is the
    plain ELBO estimate."""
    jprob, tprob = flagship
    jq0, tq0 = _mf_q0(jprob.dim)
    jalg = javt.KLMinScoreGradDescent(n_samples=N, optimizer=javt.dowg(ALPHA))
    talg = avt.KLMinScoreGradDescent(n_samples=N, optimizer=avt.dowg(ALPHA))
    with pytest.warns(UserWarning, match="IdentityOperator"):
        js, draws, jinfos = _jax_run(jalg, jprob.unconstrained(), jq0)
    with pytest.warns(UserWarning, match="IdentityOperator"):
        ts, tinfos = _port_run(talg, tprob.unconstrained(), tq0, draws)
    _assert_meanfield(ts.q, js.q)
    _assert_meanfield(talg.output(ts), jalg.output(js))
    assert_allclose(float(ts.opt_state.v), float(js.opt_state.v), rtol=1e-4)
    assert_allclose(float(ts.opt_state.r), float(js.opt_state.r), rtol=1e-4)
    _assert_elbos(tinfos, jinfos)


def test_scoregrad_cocob_matches_jax(flagship):
    """VarGrad + COCOB + ClipScale (tests/test_fused_advi.py:1127): all five
    COCOB accumulators."""
    jprob, tprob = flagship
    jq0, tq0 = _mf_q0(jprob.dim)
    jalg = javt.KLMinScoreGradDescent(n_samples=N, optimizer=javt.cocob(),
                                      operator=javt.ClipScale())
    talg = avt.KLMinScoreGradDescent(n_samples=N, optimizer=avt.cocob(),
                                     operator=avt.ClipScale())
    js, draws, jinfos = _jax_run(jalg, jprob.unconstrained(), jq0)
    ts, tinfos = _port_run(talg, tprob.unconstrained(), tq0, draws)
    _assert_meanfield(ts.q, js.q)
    for f in ("L", "G", "R", "theta", "x1"):
        atol = 1e-3 if f == "theta" else 1e-4
        _assert_meanfield(getattr(ts.opt_state, f), getattr(js.opt_state, f),
                          dict(rtol=1e-4, atol=atol))
    _assert_elbos(tinfos, jinfos)


def test_scoregrad_fullrank_matches_jax(nln):
    """Full-rank BBVI (VarGrad through the family's log_prob and its K8
    solve), Adam and ClipScale on normal-lognormal."""
    jt, tt, loc0, C0 = nln
    jq0 = javt.FullRankGaussian(jnp.asarray(loc0), jnp.asarray(C0))
    tq0 = convert.fullrank_from_numpy(loc0, C0, solve_mode="pallas", device="cpu")
    jalg = javt.KLMinScoreGradDescent(n_samples=N, optimizer=optax.adam(1e-2),
                                      operator=javt.ClipScale())
    talg = avt.KLMinScoreGradDescent(n_samples=N, optimizer=avt.adam(1e-2),
                                     operator=avt.ClipScale())
    js, draws, jinfos = _jax_run(jalg, jt.unconstrained(), jq0)
    ts, tinfos = _port_run(talg, tt.unconstrained(), tq0, draws)
    assert_allclose(ts.q.location.numpy(), js.q.location, **TOL)
    assert_allclose(ts.q.scale.numpy(), np.tril(np.asarray(js.q.scale)), **TOL)
    assert_allclose(talg.output(ts).location.numpy(), jalg.output(js).location, **TOL)
    _assert_elbos(tinfos, jinfos)


class _ValueOnly:
    """A target that offers only log-density values (capability order 0)."""

    def __init__(self, inner):
        self.inner = inner
        self.dim = inner.dim

    def order(self):
        return avt.ORDER_VALUE_ONLY

    def log_density(self, theta):
        with torch.no_grad():
            return self.inner.log_density(theta)


def test_value_only_target_goes_to_bbvi_not_advi(flagship):
    """The repaired check: order 0 is refused only for the reparameterization
    objective (JAX ``_validate_target``); BBVI runs on it."""
    _, tprob = flagship
    target = _ValueOnly(tprob.unconstrained())
    _, tq0 = _mf_q0(tprob.dim)
    with pytest.raises(ValueError, match="KLMinScoreGradDescent"):
        avt.KLMinRepGradDescent(operator=avt.ClipScale()).init(0, tq0, target)
    with pytest.raises(ValueError, match="order 0"):
        avt.KLMinRepGradProxDescent().init(0, tq0, target)
    alg = avt.KLMinScoreGradDescent(n_samples=N, operator=avt.ClipScale())
    q, infos, state = avt.optimize(0, alg, 3, target, tq0)
    assert state.iteration == 3 and all(np.isfinite(r["elbo"]) for r in infos)
    assert not torch.equal(q.location, tq0.location)


@pytest.mark.parametrize("rule", ["descent", "dog", "dowg", "cocob"])
def test_rules_match_jax_update_for_update(rule):
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((2, 4)).astype(np.float32)
    params = avt.MeanFieldGaussian(convert.to_tensor(x0[0], device="cpu"),
                                    convert.to_tensor(x0[1], device="cpu"))
    jparams = javt.MeanFieldGaussian(jnp.asarray(x0[0]), jnp.asarray(x0[1]))
    # given gradients, nothing is summed in another order: the default alpha
    args = (1e-2,) if rule == "descent" else ()
    tx, jtx = getattr(avt, rule)(*args), getattr(javt, rule)(*args)
    ts, js = tx.init(params), jtx.init(jparams)
    for _ in range(4):
        g = rng.standard_normal((2, 4)).astype(np.float32)
        tg = avt.MeanFieldGaussian(convert.to_tensor(g[0], device="cpu"),
                                    convert.to_tensor(g[1], device="cpu"))
        jg = javt.MeanFieldGaussian(jnp.asarray(g[0]), jnp.asarray(g[1]))
        tu, ts = tx.update(tg, ts, params)
        ju, js = jtx.update(jg, js, jparams)
        params, jparams = apply_updates(params, tu), optax.apply_updates(jparams, ju)
    _assert_meanfield(params, jparams, dict(rtol=1e-5, atol=1e-7))
    step = stepsize_from_opt_state(ts)
    jstep = javt.stepsize_from_opt_state(js)
    assert (step is None) == (jstep is None) == (rule == "cocob")
    if step is not None:
        assert_allclose(float(step), float(jstep), rtol=1e-5)


def test_prox_operator_matches_jax_on_both_families():
    rng = np.random.default_rng(4)
    loc = rng.standard_normal(5).astype(np.float32)
    diag = (0.5 + rng.random(5)).astype(np.float32)
    C = np.tril(0.1 * rng.standard_normal((5, 5)), -1).astype(np.float32) + np.diag(diag)
    op, jop = avt.ProximalLocationScaleEntropy(), javt.ProximalLocationScaleEntropy()
    ts, js = avt.descent(0.05).init(avt.MeanFieldGaussian(torch.zeros(5), torch.ones(5))), \
        javt.descent(0.05).init(javt.MeanFieldGaussian(jnp.zeros(5), jnp.ones(5)))
    tq = op.apply(convert.meanfield_from_numpy(loc, diag, device="cpu"), ts)
    jq = jop.apply(javt.MeanFieldGaussian(jnp.asarray(loc), jnp.asarray(diag)), js)
    _assert_meanfield(tq, jq, dict(rtol=1e-6, atol=0))
    tq = op.apply(convert.fullrank_from_numpy(loc, C, device="cpu"), ts)
    jq = jop.apply(javt.FullRankGaussian(jnp.asarray(loc), jnp.asarray(C)), js)
    assert_allclose(tq.scale.numpy(), np.asarray(jq.scale), rtol=1e-6, atol=0)
    assert_allclose(np.tril(tq.scale.numpy(), -1), np.tril(C, -1), rtol=0, atol=0)
    with pytest.raises(ValueError, match="step size"):
        op.apply(tq, avt.adam(1e-3).init(tq))


@pytest.mark.parametrize("estimator", ["closed_form_zero_grad", "stl_zero_grad"])
def test_zero_grad_entropies_match_jax(flagship, estimator):
    """One RepGradELBO gradient with each zero-gradient entropy, JAX's draws
    injected: same value and gradient (the STL zero-gradient one adds
    1/sigma to the scale's gradient; the closed-form one drops the entropy
    gradient)."""
    jprob, tprob = flagship
    jq0, tq0 = _mf_q0(jprob.dim)
    jobj = javt.RepGradELBO(n_samples=N, entropy=estimator)
    tobj = avt.RepGradELBO(n_samples=N, entropy=estimator)
    key = jax.random.key(5)
    _, u = jq0.sample_with_base(key, N)
    jg, _, jinfo = jobj.value_and_grad(jq0, jprob.unconstrained(), key)
    tg, _, tinfo = tobj.value_and_grad(tq0, tprob.unconstrained(), None,
                                       noise=convert.to_tensor(u, device="cpu"))
    _assert_meanfield(tg, jg, dict(rtol=1e-5, atol=1e-5))
    assert_allclose(float(tinfo["elbo"]), float(jinfo["elbo"]), rtol=1e-5)
    assert estimator in avt.ZERO_GRAD_ESTIMATORS and estimator in avt.ALL_ENTROPY_ESTIMATORS
    with pytest.raises(ValueError, match="zero-gradient"):
        avt.KLMinRepGradProxDescent(entropy_zerograd=avt.STL)


def test_scoregrad_objective_checks_and_estimate(flagship):
    _, tprob = flagship
    _, tq0 = _mf_q0(tprob.dim)
    with pytest.raises(ValueError, match="n_samples >= 2"):
        avt.ScoreGradELBO(n_samples=1)
    with pytest.raises(ValueError, match="noise"):
        avt.ScoreGradELBO(n_samples=N).value_and_grad(tq0, tprob.unconstrained(), None,
                                                      noise=torch.zeros(N, 3))

    class Weighted:
        weight = 2.0

    with pytest.raises(ValueError, match="weighted"):
        avt.ScoreGradELBO().loss_and_elbo(Weighted(), None, None)
    key = PhiloxKey(seed_words(2), 0)
    target = tprob.unconstrained()
    got = avt.ScoreGradELBO(n_samples=N).estimate_objective(key, tq0, target, n_samples=64)
    z = tq0.sample(key, 64)
    want = -(target.log_density(z) - tq0.log_prob(z)).mean()
    assert_allclose(float(got), float(want), rtol=1e-6)


def test_normallognormal_matches_jax():
    jt, jmu, jsd = jax_make_nln(jax.random.key(2), n_dims=6)
    tt = convert.normallognormal_from_numpy(jt.mu_y, jt.sigma_y, jt.mu_x, jt.sigma_x, device="cpu")
    assert tt.dim == jt.dim == 7
    rng = np.random.default_rng(0)
    th = rng.standard_normal((5, 7)).astype(np.float32)
    th[:, 0] = np.exp(th[:, 0])  # y > 0 in constrained space
    want = np.asarray(jax.vmap(jt.log_density)(jnp.asarray(th)))
    assert_allclose(tt.log_density(torch.from_numpy(th)).numpy(), want, rtol=1e-5)
    th_u = rng.standard_normal((5, 7)).astype(np.float32)
    want_u = np.asarray(jax.vmap(jt.unconstrained().log_density)(jnp.asarray(th_u)))
    assert_allclose(tt.unconstrained().log_density(torch.from_numpy(th_u)).numpy(), want_u,
                    rtol=1e-5)
    target, mu, sd = make_normallognormal(3, 4, device="cpu")
    again, mu2, _ = make_normallognormal(torch.Generator().manual_seed(3), 4, device="cpu")
    assert target.dim == 5 and torch.equal(mu, mu2) and torch.equal(again.mu_x, target.mu_x)
    assert torch.equal(mu, torch.cat([target.mu_y[None], target.mu_x]))
    assert torch.equal(sd, torch.cat([target.sigma_y[None], target.sigma_x]))


def test_prox_general_path_on_philox_draws_resumes():
    """Without noise the draws are K7a's plain version keyed by (seed, it):
    a resumed proximal run repeats an uninterrupted one bitwise."""
    target, _, _ = make_normallognormal(1, 10, device="cpu")
    q0 = avt.MeanFieldGaussian(torch.zeros(11), torch.ones(11))
    alg = avt.KLMinRepGradProxDescent(n_samples=N)
    q, infos, st = avt.optimize(4, alg, 12, target.unconstrained(), q0, log_every=4)
    _, _, s1 = avt.optimize(4, alg, 5, target.unconstrained(), q0)
    q2, _, s2 = avt.optimize(None, alg, 7, None, None, state=s1)
    assert torch.equal(q.location, q2.location) and torch.equal(st.q.scale_diag, s2.q.scale_diag)
    assert torch.equal(st.opt_state.r, s2.opt_state.r)
    assert [r["iteration"] for r in infos] == [4, 8, 12]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the proximal operator is no IdentityOperator
        alg.init(0, q0, target.unconstrained())
