"""Port parity: the fused proximal-ADVI and BBVI engines
(``FusedProxADVI``, ``FusedScoreGradVI``) and the diagonal-Gaussian model,
run here through the kernels' plain PyTorch versions, against the JAX fused
engine in Pallas interpret mode fed the JAX general path's draws (the
tests/test_fused_advi.py pattern), and against the port's own general path.
The kernels themselves are held to the plain versions on a card
(tests/test_torch_kernels.py).

Tolerances are tests/test_fused_advi.py's: 1e-5 on the parameters and
their averages, 1e-4 on the DoWG/DoG accumulators and the ELBO, 1e-4
(theta 1e-3 absolute) on COCOB's.  DoWG and DoG run with r0 scale ALPHA =
1e-2 for the reason given in tests/test_torch_prox_scoregrad.py.
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
from advancedvi_jl_tpu.ops.pallas import fused_advi as jfused
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
    FusedADVI,
    FusedBranch,
    FusedProxADVI,
    FusedScoreGradVI,
    fused_run_chunk_reference,
    gaussian_spec,
    logreg_spec,
    normallognormal_spec,
)

torch.set_num_threads(1)

T = 5
N = 10
ALPHA = 1e-2
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def flagship():
    jprob = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device="cpu")
    return jprob, tprob


def _specs(jprob, tprob):
    return (jfused.logreg_spec(jprob.X, jprob.y, prior_scale=jprob.prior_scale,
                               likeadj=float(jprob.likeadj)),
            logreg_spec(tprob.X, tprob.y, prior_scale=tprob.prior_scale,
                        likeadj=float(tprob.likeadj)))


def _jax_general(jalg, jtarget, jq0, steps=T):
    """The JAX general path's final state, the base draws it consumed and
    its infos."""
    state = jalg.init(jax.random.key(0), jq0, jtarget)
    step = jax.jit(jalg.step)
    draws, infos = [], []
    for _ in range(steps):
        step_key = jax.random.fold_in(state.key, state.iteration)
        _, u = state.q.sample_with_base(step_key, N)
        draws.append(np.asarray(u))
        state, info = step(state)
        infos.append(info)
    return state, np.stack(draws), infos


def _run_both(jeng, teng, loc, scale, draws):
    """The JAX engine (interpret mode) and the port's on the same draws;
    the JAX state comes back in the port's layout."""
    js = jeng.init(jnp.asarray(loc), jnp.asarray(scale))
    js = jeng.run_chunk(js, jax.random.key(1), steps=len(draws),
                        noise=jnp.asarray(convert.pack_noise(draws)))
    ts = teng.init(convert.to_tensor(loc, device="cpu"), convert.to_tensor(scale, device="cpu"))
    ts = teng.run_chunk(ts, 1, len(draws), noise=torch.from_numpy(draws))
    return convert.fused_state_from_numpy(js, len(loc), device="cpu"), ts


def _close(a, b, fields=("mu", "sig", "avg_mu", "avg_sig"), tol=TOL):
    for f in fields:
        assert_allclose(getattr(a, f).numpy(), getattr(b, f).numpy(), err_msg=f, **tol)


def _mf0(d):
    return np.zeros(d, np.float32), np.full(d, 0.1, np.float32)


@pytest.mark.parametrize("rule", ["dowg", "dog"])
def test_fused_prox_distance_rule_matches_jax(flagship, rule):
    """FusedProxADVI(dowg | dog) x mean-field logreg
    (tests/test_fused_advi.py:583, :1085): x0 in m_*, [v, r] in v_mu's
    lanes 0 and 1, the closed-form prox."""
    jprob, tprob = flagship
    jspec, tspec = _specs(jprob, tprob)
    loc, scale = _mf0(jprob.dim)
    jalg = javt.KLMinRepGradProxDescent(n_samples=N, optimizer=getattr(javt, rule)(ALPHA))
    jg, draws, jinfos = _jax_general(
        jalg, jprob.unconstrained(), javt.MeanFieldGaussian(jnp.asarray(loc), jnp.asarray(scale)))
    jeng = jfused.FusedProxADVI(jspec, n_samples=N, optimizer=rule, alpha=ALPHA, interpret=True)
    teng = FusedProxADVI(tspec, n_samples=N, optimizer=rule, alpha=ALPHA)
    assert torch.equal(teng.init(torch.zeros(62), torch.ones(62)).m_sig, torch.ones(62))
    js, ts = _run_both(jeng, teng, loc, scale, draws)
    _close(ts, js, fields=("mu", "sig", "avg_mu", "avg_sig", "m_mu", "m_sig"))
    assert_allclose(ts.v_mu[:2].numpy(), js.v_mu[:2].numpy(), rtol=1e-4)
    assert torch.equal(ts.v_mu[2:], torch.zeros(60))
    assert_allclose(float(ts.v_mu[0]), float(jg.opt_state.v), rtol=1e-4)
    assert_allclose(float(ts.v_mu[1]), float(jg.opt_state.r), rtol=1e-4)
    assert_allclose(ts.mu.numpy(), jg.q.location, **TOL)
    assert_allclose(teng.q(ts).scale_diag.numpy(), jalg.output(jg).scale_diag, **TOL)
    assert_allclose(float(ts.elbo), float(jinfos[-1]["elbo"]), rtol=1e-4, atol=1e-4)


def test_fused_prox_descent_fullrank_stl_zero_matches_jax():
    """FusedProxADVI(descent, stl_zero_grad) x full-rank normal-lognormal
    (tests/test_fused_advi.py:637): the +1/diag correction and the prox on
    the diagonal compose with the whitening as in the general path."""
    jt, _, _ = jax_make_nln(jax.random.key(7), n_dims=10)
    tt = convert.normallognormal_from_numpy(jt.mu_y, jt.sigma_y, jt.mu_x, jt.sigma_x, device="cpu")
    d = jt.dim
    C0 = np.asarray(0.2 * jnp.eye(d) + 0.05 * jnp.tril(
        jax.random.normal(jax.random.key(3), (d, d)), -1), np.float32)
    loc = np.full(d, 0.3, np.float32)
    jalg = javt.KLMinRepGradProxDescent(entropy_zerograd=javt.STL_ZERO_GRAD, n_samples=N,
                                        optimizer=javt.descent(1e-3))
    jg, draws, jinfos = _jax_general(
        jalg, jt.unconstrained(), javt.FullRankGaussian(jnp.asarray(loc), jnp.asarray(C0)))
    jeng = jfused.FusedProxADVI(jfused.normallognormal_spec(jt), family="fullrank",
                                n_samples=N, optimizer="descent", lr=1e-3,
                                entropy=javt.STL_ZERO_GRAD, interpret=True)
    teng = FusedProxADVI(normallognormal_spec(tt), family="fullrank", n_samples=N,
                         optimizer="descent", lr=1e-3, entropy=avt.STL_ZERO_GRAD)
    js, ts = _run_both(jeng, teng, loc, C0, draws)
    _close(ts, js)
    assert_allclose(ts.sig.numpy(), np.tril(np.asarray(jg.q.scale)), **TOL)
    assert_allclose(teng.q(ts).scale.numpy(), np.tril(np.asarray(jalg.output(jg).scale)), **TOL)
    assert_allclose(float(ts.elbo), float(jinfos[-1]["elbo"]), rtol=1e-4, atol=1e-4)
    assert torch.equal(torch.triu(ts.sig, 1), torch.zeros(d, d))


def test_fused_scoregrad_dowg_matches_jax(flagship):
    """FusedScoreGradVI(dowg) x mean-field logreg (tests/test_fused_advi.py
    :697): the in-kernel VarGrad closed form, the plain ELBO estimate."""
    jprob, tprob = flagship
    jspec, tspec = _specs(jprob, tprob)
    loc, scale = _mf0(jprob.dim)
    jalg = javt.KLMinScoreGradDescent(n_samples=N, optimizer=javt.dowg(ALPHA))
    with pytest.warns(UserWarning, match="IdentityOperator"):
        jg, draws, jinfos = _jax_general(
            jalg, jprob.unconstrained(),
            javt.MeanFieldGaussian(jnp.asarray(loc), jnp.asarray(scale)))
    with pytest.warns(UserWarning, match="IdentityOperator"):
        jeng = jfused.FusedScoreGradVI(jspec, n_samples=N, alpha=ALPHA, interpret=True)
    with pytest.warns(UserWarning, match="IdentityOperator"):
        teng = FusedScoreGradVI(tspec, n_samples=N, alpha=ALPHA)
    js, ts = _run_both(jeng, teng, loc, scale, draws)
    _close(ts, js)
    assert_allclose(ts.v_mu[:2].numpy(), js.v_mu[:2].numpy(), rtol=1e-4)
    assert_allclose(ts.mu.numpy(), jg.q.location, **TOL)
    assert_allclose(float(ts.v_mu[0]), float(jg.opt_state.v), rtol=1e-4)
    assert_allclose(float(ts.elbo), float(jinfos[-1]["elbo"]), rtol=1e-4, atol=1e-4)


def test_fused_cocob_matches_jax(flagship):
    """FusedScoreGradVI(cocob, clip) (tests/test_fused_advi.py:1127): x1 in
    m_*, L in v_*, (G, reward, theta) in ext, all against the JAX engine and
    the general COCOBState; a warm start through ext (2 + 3 steps) repeats
    one 5-step chunk."""
    jprob, tprob = flagship
    jspec, tspec = _specs(jprob, tprob)
    loc, scale = _mf0(jprob.dim)
    jalg = javt.KLMinScoreGradDescent(n_samples=N, optimizer=javt.cocob(),
                                      operator=javt.ClipScale())
    jg, draws, jinfos = _jax_general(
        jalg, jprob.unconstrained(), javt.MeanFieldGaussian(jnp.asarray(loc), jnp.asarray(scale)))
    jeng = jfused.FusedScoreGradVI(jspec, n_samples=N, optimizer="cocob", operator="clip",
                                   interpret=True)
    teng = FusedScoreGradVI(tspec, n_samples=N, optimizer="cocob", operator="clip")
    js, ts = _run_both(jeng, teng, loc, scale, draws)
    assert ts.ext is not None and len(ts.ext) == 6
    _close(ts, js, fields=("mu", "sig", "avg_mu", "avg_sig", "m_mu", "m_sig"))
    acc = dict(rtol=1e-4, atol=1e-4)
    _close(ts, js, fields=("v_mu", "v_sig"), tol=acc)
    for k, (a, b) in enumerate(zip(ts.ext, js.ext)):
        assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-3 if k in (2, 5) else 1e-4)
    cs = jg.opt_state
    assert_allclose(ts.v_mu.numpy(), cs.L.location, **acc)
    assert_allclose(ts.ext[0].numpy(), cs.G.location, **acc)
    assert_allclose(ts.ext[1].numpy(), cs.R.location, **acc)
    assert_allclose(ts.ext[2].numpy(), cs.theta.location, rtol=1e-4, atol=1e-3)
    assert_allclose(ts.ext[5].numpy(), cs.theta.scale_diag, rtol=1e-4, atol=1e-3)
    assert_allclose(float(ts.elbo), float(jinfos[-1]["elbo"]), rtol=1e-4, atol=1e-4)
    nz = torch.from_numpy(draws)
    two = teng.run_chunk(teng.init(torch.from_numpy(loc), torch.from_numpy(scale)), 1, 2,
                         noise=nz[:2])
    two = teng.run_chunk(two, 1, T - 2, noise=nz[2:])
    assert torch.equal(two.mu, ts.mu) and all(torch.equal(a, b) for a, b in zip(two.ext, ts.ext))


def test_fused_gaussian_meanfield_matches_jax():
    """FusedADVI (STL, Adam, ClipScale) on normallognormal_spec, mean-field
    (tests/test_fused_advi.py:252): the diagonal-Gaussian body."""
    jt, _, _ = jax_make_nln(jax.random.key(5), n_dims=9)
    tt = convert.normallognormal_from_numpy(jt.mu_y, jt.sigma_y, jt.mu_x, jt.sigma_x, device="cpu")
    d = jt.dim
    loc, scale = np.zeros(d, np.float32), np.full(d, 0.2, np.float32)
    jalg = javt.KLMinRepGradDescent(entropy=javt.STL, n_samples=N, optimizer=optax.adam(1e-3),
                                    operator=javt.ClipScale())
    jg, draws, jinfos = _jax_general(
        jalg, jt.unconstrained(), javt.MeanFieldGaussian(jnp.asarray(loc), jnp.asarray(scale)))
    jeng = jfused.FusedADVI(jfused.normallognormal_spec(jt), n_samples=N, interpret=True)
    teng = FusedADVI(normallognormal_spec(tt), n_samples=N)
    js, ts = _run_both(jeng, teng, loc, scale, draws)
    _close(ts, js)
    assert_allclose(ts.mu.numpy(), jg.q.location, **TOL)
    assert_allclose(ts.sig.numpy(), jg.q.scale_diag, **TOL)
    assert_allclose(float(ts.elbo), float(jinfos[-1]["elbo"]), rtol=1e-4, atol=1e-4)
    spec, jspec = normallognormal_spec(tt), jfused.normallognormal_spec(jt)
    assert_allclose(spec.consts[0].numpy(), np.asarray(jspec.consts[0])[0, :d], rtol=0)
    assert_allclose(spec.consts[1].numpy(), np.asarray(jspec.consts[1])[0, :d], rtol=1e-7)
    assert_allclose(spec.scalars[0], float(jspec.scalars[0]), rtol=1e-6)


@pytest.mark.parametrize("kind", ["prox", "bbvi"])
def test_fused_matches_port_general_path_on_philox_draws(flagship, kind):
    """With one seed the fused engines and the general path draw the same
    Philox normals: the same states after T steps without injected noise."""
    _, tprob = flagship
    _, tspec = _specs(*flagship)
    q0 = avt.MeanFieldGaussian(torch.zeros(62), 0.1 * torch.ones(62))
    if kind == "prox":
        alg = avt.KLMinRepGradProxDescent(n_samples=N, optimizer=avt.dowg(ALPHA))
        eng = FusedProxADVI(tspec, n_samples=N, alpha=ALPHA)
    else:
        alg = avt.KLMinScoreGradDescent(n_samples=N, optimizer=avt.dowg(ALPHA),
                                        operator=avt.ClipScale())
        eng = FusedScoreGradVI(tspec, n_samples=N, alpha=ALPHA, operator="clip")
    gq, ginfos, gs = avt.optimize(3, alg, T, tprob.unconstrained(), q0)
    fq, finfos, fs = eng.optimize(3, T, q0, log_every=1)
    assert_allclose(fs.mu.numpy(), gs.q.location.numpy(), **TOL)
    assert_allclose(fs.sig.numpy(), gs.q.scale_diag.numpy(), **TOL)
    assert_allclose(fq.location.numpy(), gq.location.numpy(), **TOL)
    assert_allclose(float(fs.v_mu[1]), float(gs.opt_state.r), rtol=1e-4)
    assert_allclose([r["elbo"] for r in finfos], [r["elbo"] for r in ginfos], rtol=1e-4)


@pytest.mark.parametrize("branch", [
    FusedBranch("dog", "stl_zero_grad", "repgrad", "prox"),
    FusedBranch("cocob", "stl", "scoregrad", "clip"),
    FusedBranch("descent", "closed_form_zero_grad", "repgrad", "none")], ids=str)
def test_new_branches_chunk_bitwise(flagship, branch):
    _, tspec = _specs(*flagship)
    eng = FusedADVI(tspec, n_samples=N)
    eng.algo, eng.entropy, eng.grad_est, eng.operator = (
        branch.algo, branch.entropy, branch.grad_est, branch.operator)
    s0 = eng.init(torch.zeros(62), 0.1 * torch.ones(62))
    whole = eng.run_chunk(s0, 5, 6)
    split = eng.run_chunk(eng.run_chunk(s0, 5, 2), 5, 4)
    traced, rows = eng.run_chunk_traced(s0, 5, 6, log_every=3)
    for a, b, c in zip(whole.stacked(), split.stacked(), traced.stacked()):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(rows[-1], whole.elbo)
    # the plain version refuses the proximal operator without a step size
    with pytest.raises(ValueError, match="step size"):
        fused_run_chunk_reference(tspec.model, tspec.consts, tspec.scalars, s0.stacked(),
                                  (0, 0), 0, 1, N, eng.hyp,
                                  branch=FusedBranch("adam", "stl", "repgrad", "prox"))


def test_fused_validation_and_warnings(flagship):
    """tests/test_fused_advi.py:687, :746, :977, :993, and the port's own
    DoWG/DoG width refusal."""
    _, tspec = _specs(*flagship)
    spec = gaussian_spec(torch.zeros(4), torch.ones(4))
    with pytest.raises(ValueError, match="optimizer"):
        FusedProxADVI(spec, optimizer="adam")
    with pytest.raises(ValueError, match="zero-gradient"):
        FusedProxADVI(spec, entropy=avt.STL)
    with pytest.raises(ValueError, match="n_samples >= 2"):
        FusedScoreGradVI(tspec, n_samples=1)
    with pytest.raises(ValueError, match="optimizer"):
        FusedScoreGradVI(tspec, optimizer="sgdm")
    with pytest.raises(ValueError, match="operator"):
        FusedScoreGradVI(tspec, operator="prox")
    with pytest.warns(UserWarning, match="IdentityOperator"):
        FusedScoreGradVI(tspec, operator="none")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        FusedScoreGradVI(tspec, operator="clip")
    eng = FusedADVI(tspec, n_samples=4)
    eng.algo = "dowg"
    st = eng.init(torch.zeros(62), 0.1 * torch.ones(62))
    assert float(st.v_mu[1]) > 0.0  # r0 = alpha (1 + ||x0||)
    eng.algo = "cocob"
    with pytest.raises(ValueError, match="ext"):
        eng.run_chunk(st, 0, 1)
    eng.algo = "typo"
    with pytest.raises(ValueError, match="algo"):
        eng.run_chunk(st, 0, 1)
    one = FusedProxADVI(gaussian_spec(torch.zeros(1), torch.ones(1)))
    with pytest.raises(ValueError, match="d >= 2"):
        one.init(torch.zeros(1), torch.ones(1))
    scoregrad_fr = FusedADVI(tspec, family="fullrank", n_samples=4)
    scoregrad_fr.grad_est = "scoregrad"
    with pytest.raises(ValueError, match="mean-field"):
        scoregrad_fr.init(torch.zeros(62), torch.eye(62))
