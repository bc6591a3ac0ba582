"""Port parity: the whole-loop fused engine (advancedvi_jl_tpu_torch.ops.cuda
.fused_advi), run here through the kernel's plain PyTorch version, against
the JAX engine in Pallas interpret mode and against the port's own general
path.  The kernel itself is held to the plain version on a card
(tests/test_torch_kernels.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.models.logreg import make_logreg as jax_make_logreg
from advancedvi_jl_tpu.ops.pallas import fused_advi as jfused
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
    STATE_FIELDS,
    FusedADVI,
    FusedLogRegADVI,
    fused_run_chunk,
    fused_run_chunk_cuda,
    logreg_spec,
)

torch.set_num_threads(1)

T = 5
N_SAMPLES = 10
# (rtol, atol) per state field: tests/test_fused_advi.py's, except the Adam
# first moments' atol.  An m entry that cancels to ~1e-2 from per-step
# gradients of size ~3 carries their float32 rounding (ulp(3) = 2.4e-7),
# summed in another order here than in XLA; the JAX test's 1e-7 holds only
# for draws without such a cancellation.
TOL = {"mu": (1e-5, 1e-6), "sig": (1e-5, 1e-6), "avg_mu": (1e-5, 1e-6),
       "avg_sig": (1e-5, 1e-6), "m_mu": (1e-5, 1e-6), "m_sig": (1e-5, 1e-6),
       "v_mu": (5e-5, 1e-9), "v_sig": (5e-5, 1e-9)}


@pytest.fixture(scope="module")
def flagship():
    jprob = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device="cpu")
    return jprob, tprob


@pytest.fixture(scope="module")
def noise():
    rng = np.random.default_rng(0)
    return rng.standard_normal((T, N_SAMPLES, 62)).astype(np.float32)


def _engine(tprob, **kw):
    return FusedLogRegADVI(tprob.X, tprob.y, prior_scale=tprob.prior_scale,
                           likeadj=float(tprob.likeadj), n_samples=N_SAMPLES, **kw)


def _init(eng):
    d = eng.dim
    return eng.init(torch.zeros(d), 0.1 * torch.ones(d))


def _assert_states_close(a, b, fields=STATE_FIELDS):
    for f in fields:
        rtol, atol = TOL[f]
        assert_allclose(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                        rtol=rtol, atol=atol, err_msg=f)


def _assert_states_equal(a, b):
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.iteration == b.iteration and torch.equal(a.elbo, b.elbo)


def test_padding_rules_match_the_jax_engine():
    for d in (1, 62, 128, 129, 700):
        assert convert.d_pad_for(d) == jfused.d_pad_for(d)
    for n in (1, 10, 16, 17, 100):
        assert convert.n_pad_for(n) == jfused.n_pad_for(n)


def test_fused_matches_jax_fused_engine(flagship, noise):
    jprob, tprob = flagship
    d = jprob.dim
    jeng = jfused.FusedLogRegADVI(jprob.X, jprob.y, prior_scale=jprob.prior_scale,
                                  likeadj=float(jprob.likeadj), n_samples=N_SAMPLES,
                                  lr=1e-3, interpret=True)
    js = jeng.init(jnp.zeros(d), 0.1 * jnp.ones(d))
    js = jeng.run_chunk(js, jax.random.key(1), steps=T,
                        noise=jnp.asarray(convert.pack_noise(noise)))
    js_port = convert.fused_state_from_numpy(js, d, device="cpu")

    eng = _engine(tprob, lr=1e-3)
    ts = eng.run_chunk(_init(eng), 1, T, noise=torch.from_numpy(noise))
    _assert_states_close(ts, js_port)
    assert_allclose(float(ts.elbo), float(js.elbo), rtol=1e-4, atol=1e-4)
    assert ts.iteration == js_port.iteration == T
    q = eng.q(ts)
    jq = jeng.q(js)
    assert_allclose(q.location.numpy(), jq.location, rtol=1e-5, atol=1e-6)
    assert_allclose(q.scale_diag.numpy(), jq.scale_diag, rtol=1e-5, atol=1e-6)


def test_fused_traced_rows_match_jax(flagship, noise):
    jprob, tprob = flagship
    d = jprob.dim
    jeng = jfused.FusedLogRegADVI(jprob.X, jprob.y, n_samples=N_SAMPLES, interpret=True)
    js, jtrace = jeng.run_chunk_traced(
        jeng.init(jnp.zeros(d), 0.1 * jnp.ones(d)), jax.random.key(1), steps=4,
        log_every=2, noise=jnp.asarray(convert.pack_noise(noise[:4])),
    )
    eng = _engine(tprob)
    ts, trace = eng.run_chunk_traced(_init(eng), 1, 4, 2, noise=torch.from_numpy(noise[:4]))
    assert trace.shape == (2,)
    assert_allclose(trace.numpy(), np.asarray(jtrace), rtol=1e-4, atol=1e-4)


def _alg():
    return avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N_SAMPLES,
                                   optimizer=avt.adam(1e-3), operator=avt.ClipScale())


def _general(tprob, draws=None, steps=T, seed=1):
    alg = _alg()
    d = tprob.dim
    state = alg.init(seed, avt.MeanFieldGaussian(torch.zeros(d), 0.1 * torch.ones(d)),
                     tprob.unconstrained())
    infos = []
    for t in range(steps):
        state, info = alg.step(state, noise=None if draws is None else draws[t])
        infos.append(info)
    return alg, state, infos


def _as_fused(alg, state):
    avg = alg.output(state)
    return dict(mu=state.q.location, sig=state.q.scale_diag,
                m_mu=state.opt_state.mu.location, m_sig=state.opt_state.mu.scale_diag,
                v_mu=state.opt_state.nu.location, v_sig=state.opt_state.nu.scale_diag,
                avg_mu=avg.location, avg_sig=avg.scale_diag)


@pytest.mark.parametrize("injected", [True, False], ids=["noise", "philox"])
def test_fused_matches_port_general_path(flagship, noise, injected):
    """With one seed the fused engine and KLMinRepGradDescent draw the same
    Philox normals, so the two agree with or without injected noise."""
    _, tprob = flagship
    draws = torch.from_numpy(noise) if injected else None
    alg, gs, ginfos = _general(tprob, draws)
    eng = _engine(tprob)
    fs = eng.run_chunk(_init(eng), 1, T, noise=draws)
    ref = _as_fused(alg, gs)
    for f in STATE_FIELDS:
        rtol, atol = TOL[f]
        assert_allclose(getattr(fs, f).numpy(), ref[f].numpy(), rtol=rtol, atol=atol,
                        err_msg=f)
    assert_allclose(float(fs.elbo), float(ginfos[-1]["elbo"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("injected", [True, False], ids=["noise", "philox"])
def test_chunking_is_associative(flagship, noise, injected):
    _, tprob = flagship
    eng = _engine(tprob)
    nz = torch.from_numpy(noise)
    whole = eng.run_chunk(_init(eng), 3, T, noise=nz if injected else None)
    part = eng.run_chunk(_init(eng), 3, 2, noise=nz[:2] if injected else None)
    part = eng.run_chunk(part, 3, T - 2, noise=nz[2:] if injected else None)
    _assert_states_equal(whole, part)


def test_traced_rows_are_the_untraced_elbos(flagship):
    _, tprob = flagship
    eng = _engine(tprob)
    traced, rows = eng.run_chunk_traced(_init(eng), 4, 6, log_every=2)
    s, elbos = _init(eng), []
    for _ in range(6):
        s = eng.run_chunk(s, 4, 1)
        elbos.append(s.elbo)
    _assert_states_equal(traced, s)
    assert torch.equal(rows, torch.stack(elbos[1::2]))


def test_fused_optimize_rows_warm_start_and_divergence(flagship):
    _, tprob = flagship
    eng = _engine(tprob)
    d = tprob.dim
    q0 = avt.MeanFieldGaussian(torch.zeros(d), 0.1 * torch.ones(d))
    q, infos, s = eng.optimize(2, 25, q0, log_every=10, chunk_size=20)
    assert [r["iteration"] for r in infos] == [10, 20, 25]
    assert s.iteration == 25 and torch.equal(q.location, s.avg_mu)
    # the general path on the same seed logs the same ELBOs
    _, ginfos, _ = avt.optimize(2, _alg(), 25,
                                tprob.unconstrained(), q0, log_every=10)
    assert_allclose([r["elbo"] for r in infos], [r["elbo"] for r in ginfos], rtol=1e-4)
    # warm start through state= equals one run
    _, _, s1 = eng.optimize(2, 12, q0, log_every=4)
    _, rows, s2 = eng.optimize(2, 13, state=s1, log_every=4)
    assert [r["iteration"] for r in rows] == [4, 8, 12, 13]
    _assert_states_equal(s, s2)
    bad = FusedLogRegADVI(tprob.X, tprob.y, likeadj=float("nan"))
    with pytest.raises(avt.DivergenceError, match="iteration 10"):
        bad.optimize(0, 30, q0, log_every=10)


def test_engine_checks(flagship):
    _, tprob = flagship
    spec = logreg_spec(tprob.X, tprob.y)
    assert FusedADVI(spec, family="fullrank").family == "fullrank"
    with pytest.raises(ValueError, match="family"):
        FusedADVI(spec, family="lowrank")
    # minibatch models run on both engines (K4's minibatch body)
    mb = avt.logreg_minibatch_spec(tprob.X, tprob.y, batch_size=16)
    for family in ("meanfield", "fullrank"):
        eng = FusedADVI(mb, family=family, n_samples=N_SAMPLES)
        assert eng.run_chunk(eng.init(torch.zeros(62), 0.1 * (
            torch.ones(62) if family == "meanfield" else torch.eye(62))), 0, 2).iteration == 2
    # the dense Gaussian runs on the mean-field engine too (K4's mvnormal
    # body), as in JAX; both families refuse d > 2,048, as JAX does
    mv = FusedADVI(avt.mvnormal_spec(torch.zeros(3), torch.eye(3)), n_samples=N_SAMPLES)
    assert mv.run_chunk(mv.init(torch.zeros(3), torch.ones(3)), 0, 2).iteration == 2
    with pytest.raises(ValueError, match="dim <= 2048"):
        FusedADVI(avt.gaussian_spec(torch.zeros(2049), torch.ones(2049)))
    with pytest.raises(ValueError, match="ad_spec"):  # K5 needs the traced target
        FusedADVI(spec.__class__(dim=2, consts=(), scalars=(), model="ad"))
    eng = FusedADVI(spec, n_samples=N_SAMPLES)
    s = _init(eng)
    with pytest.raises(ValueError, match="noise"):
        eng.run_chunk(s, 0, 2, noise=torch.zeros(2, N_SAMPLES, 5))
    with pytest.raises(ValueError, match="log_every"):
        eng.run_chunk_traced(s, 0, 5, log_every=2)
    with pytest.raises(ValueError, match="model="):
        eng.run_chunk(s, 0, 1, model=logreg_spec(tprob.X[:, :10], tprob.y))
    other = logreg_spec(tprob.X.flip(0), tprob.y.flip(0))
    assert eng.run_chunk(s, 0, 1, model=other).iteration == 1
    assert eng.run_chunk(s, 0, 0) is s
    with pytest.raises(ValueError, match="location"):
        eng.init(torch.zeros(3), torch.ones(3))


def test_kernel_wrapper_refuses_cpu_tensors(flagship):
    _, tprob = flagship
    eng = _engine(tprob)
    rows = _init(eng).stacked()
    args = ("logreg", (tprob.X, tprob.y), (1.0, 3.0), rows, (0, 0), 0, 2, N_SAMPLES, eng.hyp)
    with pytest.raises(ValueError, match="CUDA"):
        fused_run_chunk_cuda(*args)
    with pytest.raises(ValueError, match="device"):
        fused_run_chunk(*args[:3], rows.to("meta"), *args[4:])
