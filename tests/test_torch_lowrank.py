"""Port parity: the low-rank family (``LowRankGaussian``), its sampler K7c's
plain version and VJP, and low-rank ADVI on the general path, against the
JAX package on the same numpy parameters and injected draws; and the three
cases of tests/test_lowrank_advi.py on the port's own Philox draws.

Tolerances: rtol 1e-5 on the family's densities, entropies and moments
(both take a float32 Cholesky of D^2 + U U^T, the Woodbury path above
d = 512 its r x r capacitance), rtol 1e-5 and atol 1e-6 on the parameters
after injected-noise ADVI steps (the sums of the gradient run in another
order), 1e-6 on the VJP against autograd.  The kernel is held to the plain
version on a card (tests/test_torch_kernels.py).
"""

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
from advancedvi_jl_tpu_torch.families.location_scale import is_location_scale
from advancedvi_jl_tpu_torch.models.normal import NormalTarget, normal_fullrank
from advancedvi_jl_tpu_torch.objectives.repgradelbo import _use_fast
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    lowrank_sample,
    lowrank_sample_raw,
    lowrank_sample_reference,
    meanfield_sample_reference,
)

torch.set_num_threads(1)


def _params(d, r, seed=0):
    rng = np.random.default_rng(seed)
    loc = rng.normal(0, 1, d).astype(np.float32)
    D = (0.5 + rng.uniform(0, 1, d)).astype(np.float32)
    U = (0.4 * rng.normal(0, 1, (d, r))).astype(np.float32)
    return loc, D, U


@pytest.mark.parametrize("d,r", [(12, 2), (62, 8), (520, 3)], ids=["d12", "d62", "woodbury"])
def test_family_matches_jax(d, r):
    loc, D, U = _params(d, r)
    jq = javt.LowRankGaussian(jnp.asarray(loc), jnp.asarray(D), jnp.asarray(U))
    tq = convert.lowrank_from_numpy(loc, D, U, device="cpu")
    z = np.random.default_rng(1).normal(0, 1, (7, d)).astype(np.float32) * 2.0 + loc
    assert_allclose(tq.log_prob(torch.from_numpy(z)).numpy(), np.asarray(jq.log_prob(z)),
                    rtol=1e-5)
    assert_allclose(float(tq.log_prob(torch.from_numpy(z[0]))), float(jq.log_prob(z[0])),
                    rtol=1e-5)
    assert_allclose(float(tq.entropy()), float(jq.entropy()), rtol=1e-5)
    assert_allclose(tq.cov().numpy(), np.asarray(jq.cov()), rtol=1e-5, atol=1e-6)
    assert_allclose(tq.var().numpy(), np.asarray(jq.var()), rtol=1e-5)
    assert_allclose(tq.mean().numpy(), np.asarray(jq.mean()), rtol=0)
    assert (tq.dim, tq.rank, tq.base_dim) == (d, r, d + r)


def test_sampler_plain_version_draws_the_meanfield_u1():
    """u1 is K7a's u for the same key, bit for bit; U = 0 gives the
    mean-field z; u2 is independent of u1 (streams 2 and 3)."""
    loc, D, U = (torch.from_numpy(a) for a in _params(62, 8))
    z, u1, u2 = lowrank_sample_reference((5, 6), 9, loc, D, U, 10)
    zm, um = meanfield_sample_reference((5, 6), 9, loc, D, 10)
    assert torch.equal(u1, um) and u2.shape == (10, 8)
    z0, _, u20 = lowrank_sample_reference((5, 6), 9, loc, D, torch.zeros_like(U), 10)
    assert torch.equal(z0, zm) and torch.equal(u20, u2)
    assert not torch.equal(u2, u1[:, :8])
    assert torch.equal(z, u1 * D + u2 @ U.T + loc)
    # the dispatcher takes the plain version on the CPU and refuses other devices
    assert all(torch.equal(a, b) for a, b in zip(lowrank_sample_raw((5, 6), 9, loc, D, U, 10),
                                                 (z, u1, u2)))
    with pytest.raises(ValueError, match="no sampler"):
        lowrank_sample_raw((5, 6), 9, loc.to("meta"), D, U, 10)


def test_sampler_vjp_matches_autograd_of_the_plain_formula():
    loc, D, U = (torch.from_numpy(a).requires_grad_(True) for a in _params(20, 3))
    z, u1, u2 = lowrank_sample((1, 2), 3, loc, D, U, 16)
    ct = torch.randn(16, 20, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad((z * ct).sum(), (loc, D, U))
    want = torch.autograd.grad(((u1 * D + u2 @ U.T + loc) * ct).sum(), (loc, D, U))
    for a, b in zip(got, want):
        assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    assert not u1.requires_grad and not u2.requires_grad


def test_advi_steps_match_jax_with_injected_draws():
    """Three low-rank ADVI steps (STL, Adam, ClipScale, averaging) on the
    flagship logreg, port against JAX on the same (u1, u2): the JAX side is
    the manual-loss harness of tests/test_fused_chains.py:66-86, STL through
    q_stop.log_prob, as both packages take it for this family."""
    jprob = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device="cpu")
    d, r, n, T = jprob.dim, 4, 10, 3
    loc = np.zeros(d, np.float32)
    D = np.full(d, 0.1, np.float32)
    U = (0.01 * np.random.default_rng(2).normal(0, 1, (d, r))).astype(np.float32)
    draws = np.random.default_rng(3).standard_normal((T, n, d + r)).astype(np.float32)
    jtarget = jprob.unconstrained()
    jalg = javt.KLMinRepGradDescent(entropy=javt.STL, n_samples=n, optimizer=optax.adam(1e-3),
                                    operator=javt.ClipScale())
    q = javt.LowRankGaussian(jnp.asarray(loc), jnp.asarray(D), jnp.asarray(U))
    opt_state, avg_state = jalg.optimizer.init(q), jalg.averager.init(q)
    jelbos = []
    for t in range(T):
        u1, u2 = jnp.asarray(draws[t, :, :d]), jnp.asarray(draws[t, :, d:])

        def loss(params, u1=u1, u2=u2):
            m, Dp, Up = params
            live = q.replace(location=m, scale_diag=Dp, scale_factors=Up)
            z = u1 * Dp + u2 @ Up.T + m
            energy = jnp.mean(jax.vmap(jtarget.log_density)(z))
            ent = -jnp.mean(jax.lax.stop_gradient(live).log_prob(z))
            return -(energy + ent)

        val, g = jax.value_and_grad(loss)((q.location, q.scale_diag, q.scale_factors))
        jelbos.append(-float(val))
        grad_q = q.replace(location=g[0], scale_diag=g[1], scale_factors=g[2])
        upd, opt_state = jalg.optimizer.update(grad_q, opt_state, q)
        q = javt.ClipScale().apply(optax.apply_updates(q, upd), opt_state)
        avg_state = jalg.averager.apply(avg_state, q)
    jout = jalg.averager.value(avg_state)

    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=n, optimizer=avt.adam(1e-3),
                                  operator=avt.ClipScale())
    q0 = convert.lowrank_from_numpy(loc, D, U, device="cpu")
    assert not _use_fast(q0) and _use_fast(avt.MeanFieldGaussian(torch.zeros(3)))
    st = alg.init(0, q0, tprob.unconstrained())
    for t in range(T):
        st, info = alg.step(st, noise=torch.from_numpy(draws[t]))
        assert_allclose(float(info["elbo"]), jelbos[t], rtol=1e-5)
    tol = dict(rtol=1e-5, atol=1e-6)
    assert_allclose(st.q.location.numpy(), np.asarray(q.location), **tol)
    assert_allclose(st.q.scale_diag.numpy(), np.asarray(q.scale_diag), **tol)
    assert_allclose(st.q.scale_factors.numpy(), np.asarray(q.scale_factors), **tol)
    out = alg.output(st)
    assert_allclose(out.scale_factors.numpy(), np.asarray(jout.scale_factors), **tol)
    with pytest.raises(ValueError, match=r"noise must have shape \(10, 66\)"):
        alg.step(st, noise=torch.zeros(n, d))


def _correlated_target():
    """tests/test_lowrank_advi.py:14-20's target: covariance exactly diag +
    rank 2 (d = 12), from numpy draws."""
    d, r = 12, 2
    rng = np.random.default_rng(21)
    Dv = 0.6 + 0.4 * rng.uniform(0, 1, d)
    Uv = 0.5 * rng.normal(0, 1, (d, r))
    cov = np.diag(Dv ** 2) + Uv @ Uv.T
    mu = rng.normal(0, 1, d)
    target = NormalTarget(mu=torch.tensor(mu, dtype=torch.float32),
                          scale_tril=torch.tensor(np.linalg.cholesky(cov), dtype=torch.float32))
    return target, mu, cov


def test_lowrank_advi_convergence():
    """tests/test_lowrank_advi.py:13: mean within 0.1, covariance within
    0.15, |ELBO| < 0.1 by estimate_objective with 20,000 samples."""
    target, mu, cov = _correlated_target()
    d, r = 12, 2
    q0 = avt.LowRankGaussian(torch.zeros(d), torch.ones(d), 0.1 * torch.ones(d, r))
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=32, optimizer=avt.adam(2e-2),
                                  operator=avt.ClipScale())
    out, infos, _ = avt.optimize(0, alg, 3000, target, q0, log_every=100)
    assert_allclose(out.mean().numpy(), mu, atol=0.1)
    assert_allclose(out.cov().numpy(), cov, atol=0.15)
    nelbo = avt.estimate_objective(5, alg, out, target, n_samples=20_000)
    assert abs(float(nelbo)) < 0.1


def test_lowrank_logprob_stable_at_clip_floor():
    """tests/test_lowrank_advi.py:44: D at the ClipScale floor while U covers
    that direction: the dense-Cholesky path stays finite and accurate."""
    d = 8
    D = torch.ones(d)
    D[0] = 1e-5
    U = torch.zeros(d, 2)
    U[0, 0], U[1, 1] = 1.0, 0.5
    q = avt.LowRankGaussian(torch.zeros(d), D, U)
    z = q.sample(0, 256)
    lp = q.log_prob(z).numpy()
    assert np.isfinite(lp).all()
    cov = np.diag(D.double().numpy() ** 2) + U.double().numpy() @ U.double().numpy().T
    diff = z.double().numpy()
    _, logdet = np.linalg.slogdet(cov)
    quad = np.einsum("nd,dk,nk->n", diff, np.linalg.inv(cov), diff)
    lp_true = -0.5 * (quad + logdet + d * np.log(2 * np.pi))
    assert_allclose(lp, lp_true, rtol=1e-3, atol=1e-2)
    assert np.isfinite(float(q.entropy()))


def test_lowrank_advi_no_divergence_when_diag_collapses():
    """tests/test_lowrank_advi.py:71: full-rank target, rank-2 family; an
    entry of D goes to the floor and the run stays finite."""
    target, mu, _ = normal_fullrank(3, 8, device="cpu")
    q0 = avt.LowRankGaussian(torch.zeros(8), torch.ones(8), 0.1 * torch.ones(8, 2))
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=16, optimizer=avt.adam(1e-2),
                                  operator=avt.ClipScale())
    out, infos, _ = avt.optimize(4, alg, 1500, target, q0, log_every=100)
    assert np.isfinite(float(infos[-1]["elbo"]))
    assert float(torch.linalg.norm(out.location - mu)) < 0.5


def test_operators_on_the_lowrank_family():
    """ClipScale clamps scale_diag (JAX optim/operators.py:64); the entropy
    prox refuses the family (:101-111); it counts as location-scale for the
    IdentityOperator warning."""
    q = avt.LowRankGaussian(torch.zeros(3), torch.tensor([1e-9, 0.5, 2.0]), torch.ones(3, 2))
    clipped = avt.ClipScale(1e-5).apply(q, None)
    assert torch.equal(clipped.scale_diag, torch.tensor([1e-5, 0.5, 2.0]))
    assert torch.equal(clipped.scale_factors, q.scale_factors)
    assert is_location_scale(q)
    with pytest.raises(TypeError, match="location-scale"):
        avt.ProximalLocationScaleEntropy().apply(q, avt.descent(1e-3).init(q))
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=2,
                                  operator=avt.IdentityOperator())
    target, _, _ = normal_fullrank(3, 3, device="cpu")
    with pytest.warns(UserWarning, match="IdentityOperator"):
        alg.init(0, q, target)
