"""The port's Pathfinder and PSIS diagnostics (advancedvi_jl_tpu_torch
.algorithms.pathfinder, utils/diagnostics.py) against the JAX package.

The port's L-BFGS is its own, not optax's, so its trajectory is not JAX's: the stage after the trajectory is held to JAX's on JAX's own
trajectory with JAX's per-iterate draws (``convert.pathfinder_from_numpy``),
and the port's whole Pathfinder passes the property checks of
tests/test_pathfinder.py:19-104."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.algorithms import pathfinder as jpf
from advancedvi_jl_tpu.core.problem import log_density_and_grad as jax_ldg
from advancedvi_jl_tpu.models.logreg import make_logreg as jax_make_logreg
from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank
from advancedvi_jl_tpu.utils import diagnostics as jdiag
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.algorithms import pathfinder as tpf
from advancedvi_jl_tpu_torch.utils import diagnostics as tdiag

torch.set_num_threads(1)
CPU = "cpu"


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def logreg():
    """tests/test_pathfinder.py's logistic regression (64 x 7, d = 9)."""
    jp = jax_make_logreg(jax.random.key(11), n_data=64, n_features=7)
    tp = convert.logreg_from_numpy(jp.X, jp.y, jp.likeadj, jp.prior_scale, device=CPU)
    return jp.unconstrained(), tp.unconstrained()


@pytest.fixture(scope="module")
def gaussian():
    jt, mu, L = jax_normal_fullrank(jax.random.key(3), 5)
    return jt, convert.normal_target_from_numpy(jt.mu, jt.scale_tril, device=CPU), mu, L


def _jax_stage(jprob, thetas, grads, noise, history):
    """JAX's stage after the trajectory (algorithms/pathfinder.py
    ``_pathfinder_jit`` after ``_lbfgs_trajectory``, with its
    ``_inverse_hessian``) on given iterates, gradients and draws.  The
    gradients must be the ones the port gets: near the mode y = g_t - g_t+1
    cancels, so the last iterates' H moves with the gradients' rounding."""
    T, d = thetas.shape[0] - 1, thetas.shape[1]
    s_all, y_all = thetas[1:] - thetas[:-1], grads[:-1] - grads[1:]
    starts = jnp.arange(T)[:, None] - history + jnp.arange(history)
    idx = jnp.clip(starts, 0, T - 1)
    H = jax.vmap(jpf._inverse_hessian)(s_all[idx], y_all[idx], starts >= 0)
    C = jnp.linalg.cholesky(H + 1e-8 * jnp.eye(d))

    def elbo_at(t, u):
        bad = jnp.any(jnp.isnan(C[t]))
        C_safe = jnp.where(bad, jnp.eye(d), C[t])
        z = u @ C_safe.T + thetas[t + 1]
        logq = (-0.5 * jnp.sum(jnp.square(u), axis=-1) - 0.5 * d * jnp.log(2.0 * jnp.pi)
                - jnp.sum(jnp.log(jnp.abs(jnp.diag(C_safe)))))
        elbo = jnp.mean(jax.vmap(jprob.log_density)(z) - logq)
        return jnp.where(bad, -jnp.inf, elbo)

    elbos = jax.vmap(elbo_at)(jnp.arange(T), noise)
    elbos = jnp.where(jnp.isfinite(elbos), elbos, -jnp.inf)
    return H, C, elbos, jnp.argmax(elbos)


@pytest.mark.parametrize("target", ["gaussian", "logreg"])
def test_stage_after_the_trajectory_matches_jax(request, target):
    """On JAX's L-BFGS trajectory with JAX's draws: each iterate's inverse
    Hessian and Cholesky factor within rtol 1e-5, the ELBOs within 1e-4,
    the same best iterate and q."""
    jprob, tprob = request.getfixturevalue(target)[:2]
    T, history, K = 30, 6, 32
    d = jprob.dim
    theta0 = 2.0 * jax.random.uniform(jax.random.key(1), (d,), minval=-1.0, maxval=1.0)
    thetas = jpf._pathfinder_jit(jprob, theta0, jax.random.key(2), T, history, K).trajectory
    _, grads = jax.vmap(lambda th: jax_ldg(jprob, th))(thetas)
    noise = jnp.stack([jax.random.normal(k, (K, d)) for k in jax.random.split(jax.random.key(2), T)])
    jH, jC, jelbos, jbest = jax.jit(_jax_stage, static_argnums=4)(jprob, thetas, grads,
                                                                   noise, history)
    tres = convert.pathfinder_from_numpy(0, tprob, thetas, grads, history, K, noise, device=CPU)

    tidx = torch.tensor(np.asarray(jnp.clip(jnp.arange(T)[:, None] - history
                                            + jnp.arange(history), 0, T - 1)))
    starts = torch.arange(T)[:, None] - history + torch.arange(history)
    s_all = convert.to_tensor(thetas[1:] - thetas[:-1], CPU)
    y_all = convert.to_tensor(grads[:-1] - grads[1:], CPU)
    tH = tpf._inverse_hessian(s_all[tidx], y_all[tidx], starts >= 0)
    tC = tpf.cholesky(tH + 1e-8 * torch.eye(d))
    for k in range(T):
        assert rel(tH[k], jH[k]) <= 1e-5, k
        assert rel(tC[k], jC[k]) <= 1e-5, k
    assert np.array_equal(tres.trajectory.numpy(), np.asarray(thetas))
    assert_allclose(tres.elbos.numpy(), np.asarray(jelbos), rtol=1e-4, atol=1e-4)
    assert int(tres.best_iter) == int(jbest) + 1
    assert rel(tres.q.location, thetas[int(jbest) + 1]) == 0.0
    assert rel(tres.q.scale, jC[int(jbest)]) <= 1e-5


@pytest.mark.parametrize("dist", ["gaussian_ratio", "heavy_tail", "constant"])
def test_pareto_khat_and_diagnostics_equal_jax(dist):
    rng = np.random.default_rng(0)
    if dist == "gaussian_ratio":  # p = N(0, 1), q = N(0, 0.5^2)
        z = 0.5 * rng.standard_normal(4000)
        lw = -0.5 * z**2 - (-0.5 * (z / 0.5) ** 2 - np.log(0.5))
    elif dist == "heavy_tail":
        lw = rng.standard_t(2.0, 4000) * 2.0
    else:
        lw = np.zeros(64)
    assert_allclose(tdiag.pareto_khat(lw), jdiag.pareto_khat(lw), rtol=1e-12)
    t, j = (tdiag.importance_diagnostics(None, None, None, log_weights=lw),
            jdiag.importance_diagnostics(None, None, None, log_weights=lw))
    assert t.keys() == j.keys()
    for k in t:
        assert_allclose(t[k], j[k], rtol=1e-12)
    with pytest.raises(ValueError, match="need >= 16 weights"):
        tdiag.pareto_khat(np.zeros(8))


def test_pathfinder_exact_on_gaussian(gaussian):
    """tests/test_pathfinder.py:19, with the port's L-BFGS, over seeds 0-9.
    The trajectory reaches the mode and the q's location is near it on
    every seed.  The ELBO and covariance bars (> -0.05, within 0.3) hold on
    6 of JAX keys 0-9 for the JAX package (its test takes key 0; measured
    on this target): the port must meet them as often, and its best q's
    k-hat must be reliable."""
    _, target, mu, L = gaussian
    met, best = 0, None
    for seed in range(10):
        res = avt.pathfinder(seed, target, n_steps=40, n_elbo_samples=256, device=CPU)
        assert_allclose(res.trajectory[-1].numpy(), np.asarray(mu), atol=1e-4)
        assert_allclose(res.q.location.numpy(), np.asarray(mu), atol=0.2)
        assert 1 <= int(res.best_iter) <= 40 and res.elbos.shape == (40,)
        cov_err = float(np.abs(res.q.cov().numpy() - np.asarray(L @ L.T)).max())
        met += float(res.elbo) > -0.05 and cov_err <= 0.3
        if best is None or float(res.elbo) > float(best.elbo):
            best = res
    assert met >= 6, met
    diag = avt.importance_diagnostics(5, best.q, target, 4096)
    assert diag["khat"] < 0.5, diag


def _advi():
    return avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=16, optimizer=avt.adam(2e-2),
                                   operator=avt.ClipScale())


def _elbo(q, target):
    ev = avt.RepGradELBO(n_samples=20_000, entropy=avt.MONTE_CARLO)
    return -float(ev.estimate_objective(5, q, target))


def test_pathfinder_few_gradients_vs_advi(logreg):
    """tests/test_pathfinder.py:44: 30 L-BFGS steps land within 2 nats of
    ADVI's 2,000-step ELBO."""
    _, target = logreg
    res = avt.pathfinder(0, target, n_steps=30, n_elbo_samples=64, device=CPU)
    q_advi, _, _ = avt.optimize(1, _advi(), 2000, target,
                                avt.FullRankGaussian(torch.zeros(9), 0.1 * torch.eye(9)))
    e_pf, e_advi = _elbo(res.q, target), _elbo(q_advi, target)
    assert e_pf > e_advi - 2.0, (e_pf, e_advi)


def test_pathfinder_warm_starts_advi_and_ngd(logreg):
    """tests/test_pathfinder.py:64: from Pathfinder's q, 100 ADVI steps beat
    100 from a cold start; so do 20 NGD steps (chip_smoke.py (z)'s bar)."""
    _, target = logreg
    res = avt.pathfinder(0, target, n_steps=30, device=CPU)
    cold0 = avt.FullRankGaussian(torch.zeros(9), 0.1 * torch.eye(9))
    for alg, steps in ((_advi(), 100),
                       (avt.KLMinNaturalGradDescent(stepsize=0.05, n_samples=32), 20)):
        warm, _, _ = avt.optimize(1, alg, steps, target, res.q)
        cold, _, _ = avt.optimize(1, alg, steps, target, cold0)
        assert _elbo(warm, target) > _elbo(cold, target) + 0.5


def test_multipath_pathfinder(gaussian):
    """tests/test_pathfinder.py:84: pooled resampled draws match the
    posterior; the mixture proposal's k-hat is reliable."""
    jt, _, _ = jax_normal_fullrank(jax.random.key(3), 4)
    target = convert.normal_target_from_numpy(jt.mu, jt.scale_tril, device=CPU)
    draws, diag, results = avt.multipath_pathfinder(0, target, n_paths=4, n_draws=2000,
                                                    n_steps=30, device=CPU)
    assert draws.shape == (2000, 4)
    assert diag["khat"] < 0.7 and 0.0 < diag["ess"] <= 1.0, diag
    assert_allclose(draws.mean(0).numpy(), np.asarray(jt.mu), atol=0.1)
    assert all(float(r.elbo) > -0.5 for r in results)
    again, _, _ = avt.multipath_pathfinder(0, target, n_paths=4, n_draws=2000, n_steps=30,
                                           device=CPU)
    assert torch.equal(draws, again)


class _Walled:
    """-||theta - 5||^2 / 2 where theta[0] <= 0, NaN past that wall: the
    gradient points through the wall, so every line search from a start on
    it fails.  Counts the gradient evaluations."""

    dim = 3

    def __init__(self):
        self.calls = 0

    def log_density_and_grad(self, theta):
        self.calls += 1
        logp = -0.5 * torch.sum((theta - 5.0) ** 2, dim=-1)
        logp = torch.where(theta[..., 0] <= 0.0, logp, torch.nan)
        return logp, 5.0 - theta


@pytest.mark.parametrize("case", ["failed_search", "zero_gradient"])
def test_lbfgs_stops_when_no_step_is_found(case):
    """A search that finds no point would fail the same way at every later
    step (theta, the pairs and the direction are unchanged), so the
    trajectory ends there: one failed search of 20 evaluations, not one a
    step, and the remaining iterates repeat the start.  At the mode the
    gradient is zero and there is no descent direction at all."""
    target = _Walled()
    theta0 = torch.zeros(3) if case == "failed_search" else torch.full((3,), 5.0)
    thetas, grads, logps = tpf._lbfgs_trajectory(target, theta0, 30)
    assert thetas.shape == (31, 3) and torch.equal(thetas, theta0.expand(31, 3))
    # the start, the one failed search (none at the mode), the final batch
    assert target.calls == (1 + 20 + 1 if case == "failed_search" else 2)
    assert grads.shape == (31, 3) and logps.shape == (31,)
