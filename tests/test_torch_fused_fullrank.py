"""Port parity: the full-rank branch of the whole-loop fused engine
(``FusedADVI(family="fullrank")``, advancedvi_jl_tpu_torch.ops.cuda
.fused_advi), run here through the kernel's plain PyTorch version, against
the JAX engine in Pallas interpret mode and against the port's own general
full-rank path.  The kernel itself is held to the plain version on a card
(tests/test_torch_kernels.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.models.logreg import make_logreg as jax_make_logreg
from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank
from advancedvi_jl_tpu.ops.pallas import fused_advi as jfused
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.models.logreg import make_logreg
from advancedvi_jl_tpu_torch.models.normal import normal_fullrank_wellcond
from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
    D_FULLRANK_MAX,
    STATE_FIELDS,
    FusedADVI,
    fused_fullrank_run_chunk,
    fused_fullrank_run_chunk_cuda,
    logreg_spec,
    mvnormal_spec,
)

torch.set_num_threads(1)

N = 10
MAT = ("sig", "m_sig", "v_sig", "avg_sig")


def _assert_states_equal(a, b):
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.iteration == b.iteration and torch.equal(a.elbo, b.elbo)


@pytest.fixture(scope="module")
def logreg_pair():
    jprob = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device="cpu")
    return jprob, tprob


def _noise(steps, d, seed=0):
    return np.random.default_rng(seed).standard_normal((steps, N, d)).astype(np.float32)


def test_fused_fullrank_logreg_matches_jax_engine(logreg_pair):
    """d = 62: JAX's row-unrolled back-substitution branch; 3 steps with the
    same injected noise, at tests/test_fused_advi.py:243-249's tolerances."""
    jprob, tprob = logreg_pair
    d, steps = jprob.dim, 3
    noise = _noise(steps, d)
    jeng = jfused.FusedADVI(
        jfused.logreg_spec(jprob.X, jprob.y, prior_scale=jprob.prior_scale,
                           likeadj=float(jprob.likeadj)),
        family=jfused.FULLRANK, n_samples=N, lr=1e-3, interpret=True)
    C0 = 0.1 * np.eye(d, dtype=np.float32)
    js = jeng.init(jnp.zeros(d), jnp.asarray(C0))
    js = jeng.run_chunk(js, jax.random.key(1), steps=steps,
                        noise=jnp.asarray(convert.pack_noise(noise)))
    want = convert.fused_state_from_numpy(js, d, device="cpu")

    eng = FusedADVI(logreg_spec(tprob.X, tprob.y, prior_scale=tprob.prior_scale,
                                likeadj=float(tprob.likeadj)),
                    family="fullrank", n_samples=N, lr=1e-3)
    ts = eng.run_chunk(eng.init(torch.zeros(d), torch.from_numpy(C0)), 1, steps,
                       noise=torch.from_numpy(noise))
    assert_allclose(ts.mu.numpy(), want.mu.numpy(), rtol=1e-5, atol=1e-6)
    assert_allclose(ts.sig.numpy(), want.sig.numpy(), rtol=1e-5, atol=1e-6)
    assert_allclose(ts.avg_sig.numpy(), want.avg_sig.numpy(), rtol=1e-5, atol=1e-6)
    assert_allclose(ts.m_sig.numpy(), want.m_sig.numpy(), rtol=1e-5, atol=1e-6)
    assert_allclose(float(ts.elbo), float(js.elbo), rtol=1e-4, atol=1e-4)
    q, jq = eng.q(ts), jeng.q(js)
    assert isinstance(q, avt.FullRankLocationScale)
    assert_allclose(q.scale.numpy(), np.asarray(jq.scale), rtol=1e-5, atol=1e-6)
    assert np.all(np.asarray(js.sig)[d:, d:].diagonal() == 1.0)  # JAX padding, dropped


def test_fused_fullrank_mvnormal_matches_jax_engine():
    """d = 200: JAX's blocked back-substitution branch (d_pad 256); 3 steps
    with the same injected noise, at tests/test_fused_advi.py:1060-1068's
    tolerances."""
    d, steps = 200, 3
    jtarget, jmu, jL = jax_normal_fullrank(jax.random.key(3), d)
    jspec = jfused.mvnormal_spec(jtarget.mu, jtarget.scale_tril)
    jeng = jfused.FusedADVI(jspec, family=jfused.FULLRANK, n_samples=N, lr=1e-3,
                            interpret=True)
    noise = _noise(steps, d, seed=1)
    C0 = 0.1 * np.eye(d, dtype=np.float32)
    js = jeng.init(jnp.zeros(d), jnp.asarray(C0))
    js = jeng.run_chunk(js, jax.random.key(1), steps=steps, noise=jnp.asarray(
        convert.pack_noise(noise, d_pad=convert.d_pad_for(d))))
    want = convert.fused_state_from_numpy(js, d, device="cpu")

    spec = mvnormal_spec(convert.to_tensor(jmu, device="cpu"), convert.to_tensor(jL, device="cpu"))
    # the precision and log-normaliser the JAX spec precomputes
    assert_allclose(spec.consts[1].numpy(), np.asarray(jspec.consts[1])[:d, :d],
                    rtol=1e-4, atol=1e-4)
    assert_allclose(spec.scalars[0], float(jspec.scalars[0]), rtol=1e-6)
    eng = FusedADVI(spec, family="fullrank", n_samples=N, lr=1e-3)
    ts = eng.run_chunk(eng.init(torch.zeros(d), torch.from_numpy(C0)), 1, steps,
                       noise=torch.from_numpy(noise))
    assert_allclose(ts.mu.numpy(), want.mu.numpy(), rtol=1e-4, atol=1e-5)
    assert_allclose(np.tril(ts.sig.numpy()), np.tril(want.sig.numpy()), rtol=1e-4, atol=1e-5)
    assert_allclose(float(ts.elbo), float(js.elbo), rtol=1e-4, atol=1e-3)


def _general_fullrank(target, q0, steps, seed):
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N,
                                  optimizer=avt.adam(1e-3), operator=avt.ClipScale())
    state = alg.init(seed, q0, target)
    for _ in range(steps):
        state, info = alg.step(state)
    return alg, state, info


@pytest.mark.parametrize("model", ["logreg", "mvnormal"])
def test_fused_fullrank_matches_port_general_path(model):
    """With one Philox key the fused engine and KLMinRepGradDescent on
    FullRankGaussian draw the same normals: after 20 steps they agree to
    the rounding of sums taken in another order (rtol 1e-5)."""
    if model == "logreg":
        prob = make_logreg(11, device="cpu")
        target, spec = prob.unconstrained(), logreg_spec(prob.X, prob.y)
        q0 = avt.FullRankGaussian(torch.zeros(prob.dim), 0.1 * torch.eye(prob.dim),
                                  solve_mode="pallas")
    else:
        target, mu, L = normal_fullrank_wellcond(3, 40, device="cpu")
        spec = mvnormal_spec(mu, L)
        q0 = avt.FullRankGaussian(torch.zeros(40), solve_mode="pallas")
    steps = 20
    alg, gs, ginfo = _general_fullrank(target, q0, steps, seed=5)
    eng = FusedADVI(spec, family="fullrank", n_samples=N)
    fs = eng.run_chunk(eng.init(q0.location, q0.scale), 5, steps)
    avg = alg.output(gs)
    want = dict(mu=gs.q.location, sig=gs.q.scale, m_mu=gs.opt_state.mu.location,
                m_sig=gs.opt_state.mu.scale, avg_mu=avg.location, avg_sig=avg.scale)
    for f, w in want.items():
        got = getattr(fs, f)
        assert float((got - w).abs().max()) <= 1e-5 * float(w.abs().max()), f
    assert_allclose(float(fs.elbo), float(ginfo["elbo"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("injected", [True, False], ids=["noise", "philox"])
def test_fused_fullrank_chunking_and_tracing_are_bitwise(injected):
    target, mu, L = normal_fullrank_wellcond(2, 24, device="cpu")
    eng = FusedADVI(mvnormal_spec(mu, L), family="fullrank", n_samples=N)
    s0 = eng.init(torch.zeros(24), torch.eye(24))
    nz = torch.from_numpy(_noise(6, 24, seed=2)) if injected else None
    whole = eng.run_chunk(s0, 3, 6, noise=nz)
    part = eng.run_chunk(s0, 3, 2, noise=nz[:2] if injected else None)
    part = eng.run_chunk(part, 3, 4, noise=nz[2:] if injected else None)
    _assert_states_equal(whole, part)
    traced, rows = eng.run_chunk_traced(s0, 3, 6, log_every=2, noise=nz)
    _assert_states_equal(whole, traced)
    s, elbos = s0, []
    for t in range(6):
        s = eng.run_chunk(s, 3, 1, noise=nz[t:t + 1] if injected else None)
        elbos.append(s.elbo)
    assert torch.equal(rows, torch.stack(elbos[1::2]))


def test_fused_fullrank_optimize_and_checks():
    target, mu, L = normal_fullrank_wellcond(2, 16, device="cpu")
    spec = mvnormal_spec(mu, L)
    eng = FusedADVI(spec, family="fullrank", n_samples=N, lr=1e-2)
    q0 = avt.FullRankGaussian(torch.zeros(16))
    q, infos, s = eng.optimize(1, 25, q0, log_every=10, chunk_size=20)
    assert [r["iteration"] for r in infos] == [10, 20, 25]
    assert isinstance(q, avt.FullRankLocationScale) and torch.equal(q.scale, s.avg_sig)
    assert torch.equal(torch.triu(s.m_sig, 1), torch.zeros(16, 16))
    _, _, s1 = eng.optimize(1, 12, q0, log_every=4)
    _, _, s2 = eng.optimize(1, 13, state=s1, log_every=4)
    _assert_states_equal(s, s2)
    # the JAX engine's width bound, with its error
    big_t, big_mu, big_L = normal_fullrank_wellcond(0, D_FULLRANK_MAX + 1, device="cpu")
    with pytest.raises(ValueError, match="dim <= 512"):
        FusedADVI(mvnormal_spec(big_mu, big_L), family="fullrank")
    with pytest.raises(ValueError, match="scale"):
        eng.init(torch.zeros(16), torch.ones(16))
    with pytest.raises(ValueError, match="CUDA"):
        vec, mat = s.stacked_fullrank()
        fused_fullrank_run_chunk_cuda(spec.model, spec.consts, spec.scalars, vec, mat,
                                      (0, 0), 0, 1, N, eng.hyp)
    with pytest.raises(ValueError, match="device"):
        fused_fullrank_run_chunk(spec.model, spec.consts, spec.scalars, vec.to("meta"),
                                 mat.to("meta"), (0, 0), 0, 1, N, eng.hyp)


def test_fused_state_conversion_strips_fullrank_padding():
    jeng = jfused.FusedADVI(jfused.mvnormal_spec(jnp.zeros(5), jnp.eye(5)),
                            family=jfused.FULLRANK, n_samples=N, interpret=True)
    C = np.tril(np.arange(25, dtype=np.float32).reshape(5, 5)) + 1.0
    js = jeng.init(jnp.arange(5.0), jnp.asarray(C))
    ts = convert.fused_state_from_numpy(js, 5, device="cpu")
    assert torch.equal(ts.sig, torch.from_numpy(np.tril(C)))
    assert ts.sig.shape == ts.avg_sig.shape == ts.m_sig.shape == (5, 5)
    assert ts.mu.shape == (5,) and torch.equal(ts.mu, torch.arange(5.0))
    assert set(MAT) < set(STATE_FIELDS)
