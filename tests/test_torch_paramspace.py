"""Port parity: the general ADVI path (advancedvi_jl_tpu_torch.algorithms
.paramspace, objectives, optim, optimize) against the JAX package.

The JAX ``KLMinRepGradDescent`` runs T steps while its base draws are
captured (the tests/test_fused_advi.py pattern); the port's ``step`` takes
the same draws through ``noise=`` and must land on the same state within
the tolerances of tests/test_fused_advi.py.
"""

import math

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
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import PhiloxKey, seed_words
from advancedvi_jl_tpu_torch.optim.rules import apply_updates

torch.set_num_threads(1)

T = 5
N_SAMPLES = 10


@pytest.fixture(scope="module")
def flagship():
    jprob = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale)
    return jprob, tprob


def _jax_run(jtarget, jq0, steps, entropy, optimizer):
    alg = javt.KLMinRepGradDescent(entropy=entropy, n_samples=N_SAMPLES,
                                   optimizer=optimizer, operator=javt.ClipScale())
    state = alg.init(jax.random.key(0), jq0, jtarget)
    step = jax.jit(alg.step)
    draws, infos = [], []
    for _ in range(steps):
        step_key = jax.random.fold_in(state.key, state.iteration)
        _, u = state.q.sample_with_base(step_key, N_SAMPLES)
        draws.append(np.asarray(u))
        state, info = step(state)
        infos.append(info)
    return alg, state, draws, infos


def _port_run(ttarget, tq0, draws, entropy, optimizer):
    alg = avt.KLMinRepGradDescent(entropy=entropy, n_samples=N_SAMPLES,
                                  optimizer=optimizer, operator=avt.ClipScale())
    state = alg.init(0, tq0, ttarget)
    infos = []
    for u in draws:
        state, info = alg.step(state, noise=convert.to_tensor(u))
        infos.append(info)
    return alg, state, infos


def _q0(d):
    return (javt.MeanFieldGaussian(jnp.zeros(d), 0.1 * jnp.ones(d)),
            avt.MeanFieldGaussian(torch.zeros(d), 0.1 * torch.ones(d)))


@pytest.mark.parametrize("entropy", ["stl", "closed_form", "monte_carlo"])
def test_general_step_matches_jax_adam(flagship, entropy):
    jprob, tprob = flagship
    jq0, tq0 = _q0(jprob.dim)
    jalg, js, draws, jinfos = _jax_run(jprob.unconstrained(), jq0, T, entropy,
                                       optax.adam(1e-3))
    talg, ts, tinfos = _port_run(tprob.unconstrained(), tq0, draws, entropy, avt.adam(1e-3))

    assert_allclose(ts.q.location.numpy(), js.q.location, rtol=1e-5, atol=1e-6)
    assert_allclose(ts.q.scale_diag.numpy(), js.q.scale_diag, rtol=1e-5, atol=1e-6)
    jout, tout = jalg.output(js), talg.output(ts)
    assert_allclose(tout.location.numpy(), jout.location, rtol=1e-5, atol=1e-6)
    assert_allclose(tout.scale_diag.numpy(), jout.scale_diag, rtol=1e-5, atol=1e-6)
    jadam = js.opt_state[0]
    assert ts.opt_state.count == int(jadam.count) == T
    assert_allclose(ts.opt_state.mu.location.numpy(), jadam.mu.location, rtol=1e-5, atol=1e-7)
    assert_allclose(ts.opt_state.mu.scale_diag.numpy(), jadam.mu.scale_diag,
                    rtol=1e-5, atol=1e-7)
    assert_allclose(ts.opt_state.nu.location.numpy(), jadam.nu.location, rtol=5e-5, atol=1e-9)
    for ti, ji in zip(tinfos, jinfos):
        assert_allclose(float(ti["elbo"]), float(ji["elbo"]), rtol=1e-4, atol=1e-4)
        assert not bool(ti["diverged"])
    assert ts.iteration == T


def test_general_step_matches_jax_dowg_default(flagship):
    """The constructor's default rule (DoWG) and averaging."""
    jprob, tprob = flagship
    jq0, tq0 = _q0(jprob.dim)
    jalg, js, draws, _ = _jax_run(jprob.unconstrained(), jq0, T, "stl", javt.dowg())
    talg, ts, _ = _port_run(tprob.unconstrained(), tq0, draws, "stl", avt.dowg())
    assert_allclose(ts.q.location.numpy(), js.q.location, rtol=1e-5, atol=1e-6)
    assert_allclose(ts.q.scale_diag.numpy(), js.q.scale_diag, rtol=1e-5, atol=1e-6)
    assert_allclose(float(ts.opt_state.r), float(js.opt_state.r), rtol=1e-5)
    assert_allclose(float(ts.opt_state.v), float(js.opt_state.v), rtol=1e-4)
    assert_allclose(talg.output(ts).location.numpy(), jalg.output(js).location,
                    rtol=1e-5, atol=1e-6)


def test_adam_matches_optax_update_for_update():
    rng = np.random.default_rng(3)
    params = avt.MeanFieldGaussian(torch.zeros(4), torch.ones(4))
    jparams = javt.MeanFieldGaussian(jnp.zeros(4), jnp.ones(4))
    tx, jtx = avt.adam(1e-2), optax.adam(1e-2)
    ts, js = tx.init(params), jtx.init(jparams)
    for _ in range(4):
        g = rng.standard_normal((2, 4)).astype(np.float32)
        tg = avt.MeanFieldGaussian(convert.to_tensor(g[0]), convert.to_tensor(g[1]))
        jg = javt.MeanFieldGaussian(jnp.asarray(g[0]), jnp.asarray(g[1]))
        tu, ts = tx.update(tg, ts, params)
        ju, js = jtx.update(jg, js, jparams)
        params, jparams = apply_updates(params, tu), optax.apply_updates(jparams, ju)
    assert_allclose(params.location.numpy(), jparams.location, rtol=1e-6)
    assert_allclose(params.scale_diag.numpy(), jparams.scale_diag, rtol=1e-6)
    assert_allclose(ts.nu.location.numpy(), js[0].nu.location, rtol=1e-6)


def _alg():
    return avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N_SAMPLES,
                                   optimizer=avt.adam(1e-3), operator=avt.ClipScale())


def test_optimize_info_rows_follow_log_every(flagship):
    _, tprob = flagship
    target = tprob.unconstrained()
    _, tq0 = _q0(tprob.dim)
    alg = _alg()
    _, infos, state = avt.optimize(0, alg, 25, target, tq0, log_every=10, chunk_size=10)
    assert [r["iteration"] for r in infos] == [10, 20, 25]
    assert state.iteration == 25
    # each row is the ELBO of the step it names
    s = alg.init(0, tq0, target)
    elbos = []
    for _ in range(25):
        s, info = alg.step(s)
        elbos.append(float(info["elbo"]))
    assert [r["elbo"] for r in infos] == [elbos[9], elbos[19], elbos[24]]
    assert all(r["diverged"] is False for r in infos)
    _, every, _ = avt.optimize(0, alg, 7, target, tq0)
    assert [r["iteration"] for r in every] == list(range(1, 8))
    with pytest.raises(ValueError):
        avt.optimize(0, alg, 5, target, tq0, log_every=0)


def test_optimize_warm_start_equals_one_run(flagship):
    _, tprob = flagship
    target = tprob.unconstrained()
    _, tq0 = _q0(tprob.dim)
    alg = _alg()
    q_one, _, s_one = avt.optimize(5, alg, 12, target, tq0)
    _, _, s_a = avt.optimize(5, alg, 5, target, tq0)
    q_two, infos, s_two = avt.optimize(None, alg, 7, None, None, state=s_a)
    assert s_two.iteration == 12 and infos[-1]["iteration"] == 7
    assert torch.equal(q_one.location, q_two.location)
    assert torch.equal(s_one.q.scale_diag, s_two.q.scale_diag)
    assert torch.equal(s_one.opt_state.nu.location, s_two.opt_state.nu.location)


class _NaNAtCall:
    """Wraps a target; its ``k``-th log_density call returns NaN."""

    def __init__(self, prob, k):
        self.prob, self.k, self.calls = prob, k, 0
        self.dim = prob.dim

    def log_density(self, theta):
        self.calls += 1
        out = self.prob.log_density(theta)
        return out + math.nan if self.calls == self.k else out


@pytest.mark.parametrize("chunk_size", [None, 3])
def test_optimize_names_the_exact_divergent_step(flagship, chunk_size):
    _, tprob = flagship
    _, tq0 = _q0(tprob.dim)
    target = _NaNAtCall(tprob.unconstrained(), 7)
    with pytest.raises(avt.DivergenceError, match="iteration 7"):
        avt.optimize(0, _alg(), 10, target, tq0, chunk_size=chunk_size)
    target = _NaNAtCall(tprob.unconstrained(), 7)
    _, infos, _ = avt.optimize(0, _alg(), 10, target, tq0, check_divergence=False)
    assert infos[6]["diverged"] is True and infos[7]["diverged"] is False


def test_optimize_callback_mode(flagship):
    _, tprob = flagship
    target = tprob.unconstrained()
    _, tq0 = _q0(tprob.dim)
    seen = []

    def cb(iteration, info, gradient, averaged_params):
        seen.append((iteration, type(gradient).__name__, averaged_params.dim))
        return {"terminate": True, "mark": 1} if iteration == 4 else None

    _, infos, state = avt.optimize(0, _alg(), 10, target, tq0, callback=cb, log_every=2)
    assert [r["iteration"] for r in infos] == [2, 4]
    assert infos[-1]["mark"] == 1 and state.iteration == 4
    assert seen[0] == (1, "MeanFieldLocationScale", 62)
    with pytest.raises(avt.DivergenceError, match="iteration 3"):
        avt.optimize(0, _alg(), 5, _NaNAtCall(target, 3), tq0, callback=lambda **kw: None)


def test_estimate_objective_and_checks(flagship):
    _, tprob = flagship
    target = tprob.unconstrained()
    _, tq0 = _q0(tprob.dim)
    alg = _alg()
    key = PhiloxKey(seed_words(2), 0)
    got = alg.estimate_objective(key, tq0, target, n_samples=64)
    z = tq0.sample(key, 64)
    want = -(target.log_density(z).mean() - tq0.log_prob(z).mean())
    assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.warns(UserWarning, match="IdentityOperator"):
        avt.KLMinRepGradDescent().init(0, tq0, target)
    with pytest.raises(ValueError, match="entropy"):
        avt.KLMinRepGradDescent(entropy="stl_zero_grad")

    class ValueOnly:
        dim = 62

        def order(self):
            return avt.ORDER_VALUE_ONLY

    with pytest.raises(ValueError, match="order 0"):
        alg.init(0, tq0, ValueOnly())


def test_clip_scale_and_averaging():
    q = avt.MeanFieldGaussian(torch.zeros(3), torch.tensor([1e-7, 0.5, -2.0]))
    assert avt.ClipScale().apply(q, None).scale_diag.tolist() == [
        pytest.approx(1e-5), 0.5, pytest.approx(1e-5)]
    avg = avt.PolynomialAveraging(eta=8.0)
    st = avg.init(q)
    st = avg.apply(st, avt.MeanFieldGaussian(torch.ones(3), torch.ones(3)))
    assert st[1] == 2 and torch.equal(avg.value(st).location, torch.ones(3))
    assert avt.NoAveraging().value(avt.NoAveraging().apply(None, q)) is q
