"""Port parity: the fused engines on the minibatch logreg
(``logreg_minibatch_spec``, ``logreg_minibatch_hbm_spec`` with and without
prefetch), run here through the kernels' plain PyTorch versions, against the
JAX engine in Pallas interpret mode, against a manual loop over the port's
own ``LogReg.subsample``, and against each other.

Mirrors tests/test_fused_advi.py:759-975 and :1210-1325.  The kernels
themselves are held to the plain versions on a card
(tests/test_torch_kernels.py).
"""

import dataclasses
import math

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
    LOGREG_MB,
    LOGREG_MB_PREFETCH,
    LOGREG_MB_STAGED,
    MINIBATCH_MODELS,
    STATE_FIELDS,
    FusedADVI,
    FusedProxADVI,
    logreg_minibatch_hbm_spec,
    logreg_minibatch_spec,
    logreg_minibatch_logpi_grad,
    logreg_logpi_grad,
)

torch.set_num_threads(1)

CPU = "cpu"
N_DATA, FEATS, B = 64, 4, 16
NB = N_DATA // B
N_S = 6


@pytest.fixture(scope="module")
def data():
    """JAX's make_logreg(key 2, 64 x 4) (d = 6) and its port."""
    jprob = jax_make_logreg(jax.random.key(2), n_data=N_DATA, n_features=FEATS)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device=CPU)
    return jprob, tprob


def _draws(steps, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((steps, N_S, d)).astype(np.float32)


def _init(eng):
    d = eng.dim
    return eng.init(torch.zeros(d), 0.1 * torch.ones(d))


def _manual_adam_loop(tprob, draws, lr=1e-3):
    """The port's general pieces on LogReg.subsample of batch k = it mod nb:
    STL, Adam, ClipScale, polynomial averaging (test_fused_advi.py:759)."""
    d = tprob.dim
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N_S, optimizer=avt.adam(lr),
                                  operator=avt.ClipScale())
    st = alg.init(0, avt.MeanFieldGaussian(torch.zeros(d), 0.1 * torch.ones(d)),
                  tprob.unconstrained())
    info = None
    for it, u in enumerate(draws):
        k = it % NB
        window = tprob.subsample(torch.arange(k * B, (k + 1) * B)).unconstrained()
        st, info = alg.step(dataclasses.replace(st, prob=window), noise=torch.from_numpy(u))
    return alg, st, info


def test_minibatch_matches_manual_loop(data):
    """2 nb + 1 steps wrap the cyclic schedule; the fused engine (plain
    version) equals a manual loop of the port's general step on the same
    windows (rtol 1e-5, the JAX test's)."""
    _, tprob = data
    d = tprob.dim
    T = 2 * NB + 1
    draws = _draws(T, d)
    alg, st, info = _manual_adam_loop(tprob, draws)
    eng = FusedADVI(logreg_minibatch_spec(tprob.X, tprob.y, batch_size=B), n_samples=N_S)
    fs = eng.run_chunk(_init(eng), 1, T, noise=torch.from_numpy(draws))
    avg = alg.output(st)
    assert_allclose(fs.mu.numpy(), st.q.location.numpy(), rtol=1e-5, atol=1e-6)
    assert_allclose(fs.sig.numpy(), st.q.scale_diag.numpy(), rtol=1e-5, atol=1e-6)
    assert_allclose(fs.avg_mu.numpy(), avg.location.numpy(), rtol=1e-5, atol=1e-6)
    assert_allclose(float(fs.elbo), float(info["elbo"]), rtol=1e-4, atol=1e-4)


def _jax_engine_state(jspec, draws, steps, prox=False, family="meanfield"):
    d = jspec.dim
    if prox:
        jeng = jfused.FusedProxADVI(jspec, family=family, n_samples=N_S, optimizer="descent",
                                    lr=5e-3, interpret=True)
    else:
        jeng = jfused.FusedADVI(jspec, family=family, n_samples=N_S, lr=1e-3, interpret=True)
    scale = 0.1 * (jnp.ones(d) if family == "meanfield" else jnp.eye(d))
    js = jeng.init(jnp.zeros(d), scale)
    return jeng.run_chunk(js, jax.random.key(1), steps=steps,
                          noise=jnp.asarray(convert.pack_noise(draws)))


@pytest.mark.parametrize("transport", MINIBATCH_MODELS)
def test_minibatch_matches_jax_fused_engine(data, transport):
    """The JAX engine in interpret mode on its own permuted spec, the port on
    the same packed consts (convert.minibatch_spec_from_numpy), same draws:
    every transport of the port lands on the JAX state (rtol 1e-5)."""
    jprob, _ = data
    d = jprob.dim
    T = 2 * NB + 1
    draws = _draws(T, d, seed=3)
    jspec = jfused.logreg_minibatch_spec(jprob.X, jprob.y, batch_size=B, key=jax.random.key(2))
    js = _jax_engine_state(jspec, draws, T)
    want = convert.fused_state_from_numpy(js, d, device=CPU)
    spec = convert.minibatch_spec_from_numpy(*jspec.consts, N_DATA, B, jprob.prior_scale,
                                             transport, device=CPU, db=d - 1)
    assert spec.model == transport and spec.scalars[0] == float(jspec.scalars[0]) == 4.0
    eng = FusedADVI(spec, n_samples=N_S)
    ts = eng.run_chunk(_init(eng), 1, T, noise=torch.from_numpy(draws))
    for f in ("mu", "sig", "avg_mu", "avg_sig", "m_mu", "m_sig"):
        assert_allclose(getattr(ts, f).numpy(), getattr(want, f).numpy(), rtol=1e-5, atol=1e-6,
                        err_msg=f)
    assert_allclose(float(ts.elbo), float(js.elbo), rtol=1e-4, atol=1e-4)


def test_fullrank_minibatch_matches_jax_fused_engine(data):
    """The full-rank engine on the minibatch body (the JAX engine's FULLRANK
    branch in interpret mode), 2 nb + 1 steps."""
    jprob, _ = data
    d = jprob.dim
    T = 2 * NB + 1
    draws = _draws(T, d, seed=4)
    jspec = jfused.logreg_minibatch_spec(jprob.X, jprob.y, batch_size=B, key=jax.random.key(2))
    js = _jax_engine_state(jspec, draws, T, family="fullrank")
    want = convert.fused_state_from_numpy(js, d, device=CPU)
    spec = convert.minibatch_spec_from_numpy(*jspec.consts, N_DATA, B, jprob.prior_scale,
                                             LOGREG_MB_STAGED, device=CPU, db=d - 1)
    eng = FusedADVI(spec, family="fullrank", n_samples=N_S)
    ts = eng.run_chunk(eng.init(torch.zeros(d), 0.1 * torch.eye(d)), 1, T,
                       noise=torch.from_numpy(draws))
    for f in ("mu", "sig", "avg_mu", "avg_sig"):
        assert_allclose(getattr(ts, f).numpy(), getattr(want, f).numpy(), rtol=1e-5, atol=1e-6,
                        err_msg=f)


def test_minibatch_composes_with_prox_engine(data):
    """FusedProxADVI (descent, closed-form zero-gradient entropy, prox) on
    the minibatch spec equals the JAX engine and a manual prox-descent loop
    on the same windows (test_fused_advi.py:828)."""
    jprob, tprob = data
    d = jprob.dim
    Tm = NB + 2
    lr = 5e-3
    draws = _draws(Tm, d, seed=1)
    jspec = jfused.logreg_minibatch_spec(jprob.X, jprob.y, batch_size=B)
    want = convert.fused_state_from_numpy(_jax_engine_state(jspec, draws, Tm, prox=True), d,
                                          device=CPU)
    eng = FusedProxADVI(logreg_minibatch_spec(tprob.X, tprob.y, batch_size=B), n_samples=N_S,
                        optimizer="descent", lr=lr)
    ts = eng.run_chunk(_init(eng), 1, Tm, noise=torch.from_numpy(draws))
    for f in ("mu", "sig", "avg_mu"):
        assert_allclose(getattr(ts, f).numpy(), getattr(want, f).numpy(), rtol=1e-5, atol=1e-6,
                        err_msg=f)
    mu, sig = torch.zeros(d), 0.1 * torch.ones(d)
    avg = (mu, sig)
    for it in range(Tm):
        k = it % NB
        tgt = tprob.subsample(torch.arange(k * B, (k + 1) * B)).unconstrained()
        u = torch.from_numpy(draws[it])
        m, s = mu.clone().requires_grad_(True), sig.clone().requires_grad_(True)
        energy = torch.mean(tgt.log_density(m + s * u))
        ent = torch.sum(torch.log(s.detach())) + 0.5 * d * (1 + math.log(2 * math.pi))
        gm, gs = torch.autograd.grad(-(energy + ent), (m, s))
        mu, sig = mu - lr * gm, sig - lr * gs
        sig = sig / 2.0 + torch.sqrt(sig * sig + 4.0 * lr) / 2.0
        w = 9.0 / (it + 1 + 8.0)
        avg = ((1 - w) * avg[0] + w * mu, (1 - w) * avg[1] + w * sig)
    assert_allclose(ts.mu.numpy(), mu.numpy(), rtol=1e-5, atol=1e-6)
    assert_allclose(ts.sig.numpy(), sig.numpy(), rtol=1e-5, atol=1e-6)
    assert_allclose(ts.avg_mu.numpy(), avg[0].numpy(), rtol=1e-5, atol=1e-6)


def test_minibatch_validation_and_trailing_drop():
    X = torch.ones(70, 4)
    y = torch.zeros(70)
    with pytest.raises(ValueError, match="multiple of 8"):
        logreg_minibatch_spec(X, y, batch_size=10)
    with pytest.raises(ValueError, match="exceeds"):
        logreg_minibatch_spec(X, y, batch_size=80)
    spec = logreg_minibatch_spec(X, y, batch_size=16)
    # 70 rows -> 4 batches of 16, 6 trailing rows dropped; likeadj = 70/16
    assert spec.consts[0].shape == (64, 4) and spec.consts[1].shape == (4, 4)
    assert spec.scalars[0] == pytest.approx(70 / 16) and spec.dim == 5
    # the reshuffle keeps the shapes (one kernel layout for the whole run)
    c2 = spec.reshuffle((0, 1), 100)
    assert all(a.shape == b.shape for a, b in zip(spec.consts, c2))
    # the same data as the JAX builder packs
    jspec = jfused.logreg_minibatch_spec(jnp.ones((70, 4)), jnp.zeros(70), batch_size=16)
    assert jspec.static_cfg == (4, 16, 4)
    assert logreg_minibatch_hbm_spec(X, y, 16).model == LOGREG_MB_PREFETCH
    assert logreg_minibatch_hbm_spec(X, y, 16, prefetch=False).model == LOGREG_MB_STAGED
    assert spec.model == LOGREG_MB
    with pytest.raises(ValueError, match="transport"):
        convert.minibatch_spec_from_numpy(np.ones((64, 4)), np.ones((4, 4)), 70, 16,
                                          transport="logreg", device=CPU)


def test_minibatch_consts_are_the_jax_packing(data):
    """A spec over a given permutation packs what the JAX builder packs
    (X_perm, per-batch sum y_j X_j), and its body is the full logreg's
    restricted to the window with likeadj = n / B."""
    jprob, tprob = data
    perm = np.array(jax.random.permutation(jax.random.key(7), N_DATA))
    spec = logreg_minibatch_spec(tprob.X, tprob.y, B, perm=torch.from_numpy(perm))
    jX, jyX = jfused._pack_minibatch_consts(jprob.X[perm], jprob.y[perm], B, FEATS + 1)
    assert_allclose(spec.consts[0].numpy(), np.asarray(jX)[:, :FEATS + 1], rtol=0)
    assert_allclose(spec.consts[1].numpy(), np.asarray(jyX)[:NB, :FEATS + 1], rtol=1e-6,
                    atol=1e-6)
    z = torch.from_numpy(np.random.default_rng(2).standard_normal((3, jprob.dim))
                         .astype(np.float32) * 0.3)
    for it in (0, 5):
        k = it % NB
        lp, g = logreg_minibatch_logpi_grad(z, *spec.consts, it, *spec.scalars)
        idx = torch.from_numpy(perm[k * B:(k + 1) * B])
        want_lp, want_g = logreg_logpi_grad(z, tprob.X[idx], tprob.y[idx], N_DATA / B,
                                            tprob.prior_scale)
        # ylogit - sum softplus against sum y l - softplus(l): rtol 1e-5
        assert_allclose(lp.numpy(), want_lp.numpy(), rtol=1e-5)
        assert_allclose(g.numpy(), want_g.numpy(), rtol=1e-5, atol=1e-5)


def _spy_engine(data, consts_change):
    _, tprob = data
    spec = logreg_minibatch_spec(tprob.X, tprob.y, batch_size=16)
    calls = []

    def spy_reshuffle(words, done):
        calls.append(done)
        return tuple(c + 1.0 for c in spec.consts) if consts_change else spec.consts

    spec = dataclasses.replace(spec, reshuffle=spy_reshuffle)
    eng = FusedADVI(spec, n_samples=4)
    seen = []

    def fake_traced(state, key, steps, log_every, noise=None, model=None):
        seen.append(model)
        return dataclasses.replace(state, iteration=state.iteration + steps,
                                   elbo=torch.tensor(-1.0)), torch.full((steps // log_every,),
                                                                        -1.0)

    eng.run_chunk_traced = fake_traced
    return eng, spec, calls, seen


def test_fused_optimize_calls_reshuffle(data):
    """Reshuffled between chunks (after chunks 1 and 2, not after the last),
    keyed by the iterations done."""
    eng, _, calls, _ = _spy_engine(data, False)
    q0 = avt.MeanFieldGaussian(torch.zeros(eng.dim), 0.1 * torch.ones(eng.dim))
    eng.optimize(0, 3_000, q0, chunk_size=1_000, log_every=100)
    assert calls == [1_000, 2_000]


def test_fused_optimize_is_functional(data):
    """optimize never mutates the engine: reshuffled specs thread through a
    local, so a second optimize on the same engine sees the constructor's
    data order, like a fresh engine."""
    eng, spec, calls, seen = _spy_engine(data, True)
    consts0 = spec.consts
    q0 = avt.MeanFieldGaussian(torch.zeros(eng.dim), 0.1 * torch.ones(eng.dim))
    eng.optimize(0, 3_000, q0, chunk_size=1_000, log_every=100)
    assert eng.model.consts is consts0
    assert_allclose((seen[1].consts[1] - consts0[1]).numpy(), 1.0, rtol=1e-5)
    first = (list(calls), [m.consts[1] for m in seen])
    calls.clear()
    seen.clear()
    eng.optimize(0, 3_000, q0, chunk_size=1_000, log_every=100)
    assert calls == first[0]
    assert all(torch.equal(a, m.consts[1]) for a, m in zip(first[1], seen))


def test_reshuffled_optimize_runs_and_resumes(data):
    """The real reshuffle: optimize over 3 chunks equals a warm-started run
    of the same chunks (the permutation is keyed by the seed and the
    iterations done), and the reshuffled data are a permutation of the
    original rows."""
    _, tprob = data
    spec = logreg_minibatch_spec(tprob.X, tprob.y, batch_size=B, generator=1)
    new = spec.reshuffle((3, 0), 40)
    assert torch.equal(torch.sort(new[0], dim=0).values, torch.sort(tprob.X, dim=0).values)
    assert not torch.equal(new[0], spec.consts[0])
    eng = FusedADVI(spec, n_samples=N_S, lr=1e-2)
    q0 = avt.MeanFieldGaussian(torch.zeros(eng.dim), 0.1 * torch.ones(eng.dim))
    _, rows, whole = eng.optimize(3, 60, q0, chunk_size=20, log_every=10)
    assert [r["iteration"] for r in rows] == [10, 20, 30, 40, 50, 60]
    assert all(math.isfinite(r["elbo"]) for r in rows)
    _, _, again = eng.optimize(3, 60, q0, chunk_size=20, log_every=10)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(whole, f), getattr(again, f)), f


@pytest.mark.parametrize("family", ["meanfield", "fullrank"])
def test_streamed_matches_in_place(data, family):
    """Staged and prefetching specs compute what the in-place spec does on
    the same permutation and draws (test_fused_advi.py:1210, rtol 1e-6; the
    plain versions are one function), traced included."""
    _, tprob = data
    d = tprob.dim
    kw = dict(batch_size=B, generator=2)
    specs = [logreg_minibatch_spec(tprob.X, tprob.y, **kw),
             logreg_minibatch_hbm_spec(tprob.X, tprob.y, prefetch=False, **kw),
             logreg_minibatch_hbm_spec(tprob.X, tprob.y, **kw)]
    noise = torch.from_numpy(_draws(7, d, seed=1))
    scale = 0.1 * (torch.ones(d) if family == "meanfield" else torch.eye(d))
    states = []
    for spec in specs:
        eng = FusedADVI(spec, family=family, n_samples=N_S)
        states.append(eng.run_chunk(eng.init(torch.zeros(d), scale), 1, 7, noise=noise))
    for st in states[1:]:
        for f in STATE_FIELDS:
            assert_allclose(getattr(st, f).numpy(), getattr(states[0], f).numpy(), rtol=1e-6,
                            atol=1e-7, err_msg=f)
    _, trace = eng.run_chunk_traced(eng.init(torch.zeros(d), scale), 1, 6, log_every=3,
                                    noise=noise[:6])
    assert trace.shape == (2,) and bool(torch.isfinite(trace).all())


def test_streamed_large_n_builds_and_runs():
    """60,000 x 12, far beyond a block's shared memory: the staged spec
    keeps one 256-row slab, builds and runs (the plain version here)."""
    rng = np.random.default_rng(0)
    n, p = 60_000, 12
    X = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    y = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32))
    spec = logreg_minibatch_hbm_spec(X, y, batch_size=256)
    assert spec.consts[0].shape == (59_904, 12) and spec.consts[1].shape == (234, 12)
    eng = FusedADVI(spec, n_samples=4)
    d = p + 1
    st = eng.init(torch.zeros(d), 0.1 * torch.ones(d))
    st = eng.run_chunk(st, 1, 3, noise=torch.from_numpy(
        rng.standard_normal((3, 4, d)).astype(np.float32)))
    assert math.isfinite(float(st.elbo)) and st.iteration == 3


def test_prefetch_matches_sync_across_chunk_splits(data):
    """Prefetch vs synchronous staging, and a 3 + 4 split of a 7-step run
    (a cut between step 3's prefetch of slab 4 and its use) equal to one
    launch (test_fused_advi.py:1279); traced runs too."""
    _, tprob = data
    d = tprob.dim
    kw = dict(batch_size=B, generator=2)
    spec_db = logreg_minibatch_hbm_spec(tprob.X, tprob.y, **kw)
    spec_sync = logreg_minibatch_hbm_spec(tprob.X, tprob.y, prefetch=False, **kw)
    noise = torch.from_numpy(_draws(7, d, seed=1))
    states = []
    for spec in (spec_sync, spec_db):
        eng = FusedADVI(spec, n_samples=N_S)
        states.append(eng.run_chunk(_init(eng), 1, 7, noise=noise))
    for f in STATE_FIELDS:
        assert torch.equal(getattr(states[0], f), getattr(states[1], f)), f
    eng = FusedADVI(spec_db, n_samples=N_S)
    st = eng.run_chunk(_init(eng), 1, 3, noise=noise[:3])
    st = eng.run_chunk(st, 1, 4, noise=noise[3:])
    for f in STATE_FIELDS:
        assert torch.equal(getattr(st, f), getattr(states[1], f)), f
    st2, trace = eng.run_chunk_traced(_init(eng), 1, 6, log_every=3, noise=noise[:6])
    assert bool(torch.isfinite(trace).all())
    # Philox draws: one launch equals two, the split inside an epoch
    whole = eng.run_chunk(_init(eng), 4, 9)
    part = eng.run_chunk(eng.run_chunk(_init(eng), 4, 3), 4, 6)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(whole, f), getattr(part, f)), f


def test_minibatch_window_follows_the_global_iteration(data):
    """The window is k = it mod nb of the GLOBAL iteration: iteration 5
    reads batch 1, as iteration 1 does, and not batch 2."""
    _, tprob = data
    spec = logreg_minibatch_spec(tprob.X, tprob.y, batch_size=B)
    z = torch.from_numpy(_draws(1, spec.dim, seed=5)[0]) * 0.3
    at = {it: logreg_minibatch_logpi_grad(z, *spec.consts, it, *spec.scalars)
          for it in (1, 2, 5)}
    assert all(torch.equal(a, b) for a, b in zip(at[5], at[1]))
    assert not torch.equal(at[5][0], at[2][0])
