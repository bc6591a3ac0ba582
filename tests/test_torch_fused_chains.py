"""Port parity: the fused multi-chain engine (``FusedChainsADVI``), run here
through its kernel's plain PyTorch version, against the JAX engine in
Pallas interpret mode on the same injected draws (the
tests/test_fused_chains.py harness: the flagship logreg, C = 3 chains, JAX
c_pad 8, 6 samples, 4 steps; the draws mapped by ``pack_chains_noise``),
and against the port's own single-chain engine and general path on
``chain_seed_words(seed, c)``.  The kernel itself is held to the plain
version on a card (tests/test_torch_kernels.py).

Tolerances are tests/test_fused_chains.py's: rtol 1e-5 and atol 1e-6 on
mu, sig and their averages (the moments as ROADMAP Queue 3 says: v rtol
5e-5, m atol 1e-6), 1e-4 on the ELBO.  DoWG and DoG run with r0 scale
ALPHA = 1e-2 for the reason given in tests/test_torch_prox_scoregrad.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.models.logreg import make_logreg as jax_make_logreg
from advancedvi_jl_tpu.ops.pallas import fused_advi as jfused
from advancedvi_jl_tpu.ops.pallas import fused_chains as jchains
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import FusedADVI, logreg_spec
from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import (
    MAX_CHAINS_PER_BLOCK,
    RULE_CODES,
    FusedChainsADVI,
    FusedChainsState,
    chains_per_block,
    first_chain_divergence,
    fused_chains_run_chunk,
    rule_set,
)
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    chain_seed_table,
    chain_seed_words,
)

torch.set_num_threads(1)

T = 4
N = 6
C = 3
ALPHA = 1e-2
TOL = dict(rtol=1e-5, atol=1e-6)
MIXED = ["adam", "descent", "dowg", "dog", "cocob", "adam", "dowg", "cocob"]


@pytest.fixture(scope="module")
def flagship():
    jprob = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device="cpu")
    jspec = jfused.logreg_spec(jprob.X, jprob.y, prior_scale=jprob.prior_scale,
                               likeadj=float(jprob.likeadj))
    tspec = logreg_spec(tprob.X, tprob.y, prior_scale=tprob.prior_scale,
                        likeadj=float(tprob.likeadj))
    return jprob, tprob, jspec, tspec


def _inputs(n_chains, d, seed=3, steps=T, n=N):
    rng = np.random.default_rng(seed)
    locs = rng.normal(0, 0.3, (n_chains, d)).astype(np.float32)
    sds = rng.uniform(0.05, 0.2, (n_chains, d)).astype(np.float32)
    draws = rng.standard_normal((steps, n_chains, n, d)).astype(np.float32)
    return locs, sds, draws


def _run_both(jspec, tspec, n_chains, kw, locs, sds, draws, n=N, log_every=0):
    """The JAX engine (interpret mode) and the port's on the same draws; the
    JAX state comes back in the port's layout."""
    jkw = dict(kw)
    if "lr" in jkw and not np.isscalar(jkw["lr"]):
        jkw["lr"] = jnp.asarray(jkw["lr"])
    jeng = jchains.FusedChainsADVI(jspec, n_chains=n_chains, n_samples=n, interpret=True, **jkw)
    teng = FusedChainsADVI(tspec, n_chains=n_chains, n_samples=n, **kw)
    js = jeng.init(jnp.asarray(locs), jnp.asarray(sds))
    ts = teng.init(torch.from_numpy(locs), torch.from_numpy(sds))
    jnoise = jnp.asarray(convert.pack_chains_noise(draws))
    if log_every:
        js, jtr = jeng.run_chunk_traced(js, jax.random.key(1), len(draws), log_every,
                                        noise=jnoise)
        ts, ttr = teng.run_chunk_traced(ts, 1, len(draws), log_every,
                                        noise=torch.from_numpy(draws))
    else:
        js, jtr = jeng.run_chunk(js, jax.random.key(1), len(draws), noise=jnoise), None
        ts, ttr = teng.run_chunk(ts, 1, len(draws), noise=torch.from_numpy(draws)), None
    d = locs.shape[1]
    return convert.chains_state_from_numpy(js, n_chains, d, device="cpu"), ts, jtr, ttr


def _close(a, b, fields=("mu", "sig", "avg_mu", "avg_sig"), tol=TOL):
    for f in fields:
        assert_allclose(getattr(a, f).numpy(), getattr(b, f).numpy(), err_msg=f, **tol)


CASES = {
    "stl-adam-clip": dict(),
    "lr-sweep": dict(lr=np.array([1e-3, 3e-3, 1e-2], np.float32)),
    "descent-lr-sweep": dict(lr=np.array([1e-4, 3e-4, 1e-3], np.float32),
                             optimizer="descent"),
    "prox-dowg": dict(optimizer="dowg", entropy="closed_form_zero_grad", operator="prox",
                      alpha=ALPHA),
    "prox-dog-stl-zero": dict(optimizer="dog", entropy="stl_zero_grad", operator="prox",
                              alpha=ALPHA),
    "vargrad-dowg-clip": dict(optimizer="dowg", grad_est="scoregrad", operator="clip",
                              alpha=ALPHA),
    "dog": dict(optimizer="dog", alpha=ALPHA),
    "cocob": dict(optimizer="cocob"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_chains_match_jax(flagship, case):
    """Every chain of the port's engine equals the JAX engine's chain on the
    same draws, branch by branch (tests/test_fused_chains.py:37-120, :202,
    :256, :501)."""
    _, _, jspec, tspec = flagship
    locs, sds, draws = _inputs(C, tspec.dim)
    js, ts, _, _ = _run_both(jspec, tspec, C, CASES[case], locs, sds, draws)
    _close(ts, js)
    _close(ts, js, fields=("m_mu", "m_sig"), tol=dict(rtol=1e-5, atol=1e-6))
    _close(ts, js, fields=("v_mu", "v_sig"), tol=dict(rtol=5e-5, atol=1e-9))
    assert_allclose(ts.elbo.numpy(), js.elbo.numpy(), rtol=1e-4, atol=1e-4)
    if case == "cocob":
        for a, b in zip(ts.ext, js.ext):
            assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
    assert ts.iteration == T and ts.mu.shape == (C, tspec.dim)
    assert FusedChainsADVI(tspec, n_chains=C).q(ts).location.shape == (C, tspec.dim)


def test_fused_chains_mixed_sweep_matches_jax(flagship):
    """A {adam, descent, dowg, dog, cocob} sweep in one launch
    (tests/test_fused_chains.py:631): per-row slots, COCOB's ext carried by
    every chain; the port selects each chain's rule where JAX blends."""
    _, _, jspec, tspec = flagship
    locs, sds, draws = _inputs(len(MIXED), tspec.dim, seed=11)
    js, ts, _, _ = _run_both(jspec, tspec, len(MIXED), dict(optimizer=MIXED, alpha=ALPHA),
                             locs, sds, draws)
    _close(ts, js, fields=("mu", "sig", "avg_mu", "avg_sig", "m_mu", "m_sig"))
    _close(ts, js, fields=("v_mu", "v_sig"), tol=dict(rtol=5e-5, atol=1e-9))
    for a, b in zip(ts.ext, js.ext):
        assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
    assert_allclose(ts.elbo.numpy(), js.elbo.numpy(), rtol=1e-4, atol=1e-4)
    assert {RULE_CODES[r] for r in MIXED} == {int(v) for v in jchains.RULE_CODES.values()}
    assert all(RULE_CODES[k] == int(v) for k, v in jchains.RULE_CODES.items())


def test_fused_chains_traced_matches_untraced_and_jax(flagship):
    """run_chunk_traced == run_chunk bit for bit, and the (G, C) trace rows
    carry every chain's ELBO on the log_every grid, as the JAX engine's
    (tests/test_fused_chains.py:389)."""
    _, _, jspec, tspec = flagship
    locs, sds, draws = _inputs(C, tspec.dim, seed=4, steps=6)
    js, ts, jtr, ttr = _run_both(jspec, tspec, C, {}, locs, sds, draws, log_every=2)
    assert ttr.shape == (3, C)
    assert_allclose(ttr.numpy(), np.asarray(jtr), rtol=1e-4, atol=1e-4)
    eng = FusedChainsADVI(tspec, n_chains=C, n_samples=N)
    plain = eng.run_chunk(eng.init(torch.from_numpy(locs), torch.from_numpy(sds)), 1, 6,
                          noise=torch.from_numpy(draws))
    assert torch.equal(plain.stacked(), ts.stacked())
    assert torch.equal(ttr[-1], ts.elbo)


def test_fused_chains_divergence_channel(flagship):
    """A chain given lr 1e7 is named, at log_every granularity, while the
    others stay finite (tests/test_fused_chains.py:421)."""
    _, _, _, tspec = flagship
    lrs = np.full(8, 1e-3, np.float32)
    lrs[5] = 1e7
    eng = FusedChainsADVI(tspec, n_chains=8, n_samples=4, lr=lrs, optimizer="descent")
    locs, sds, draws = _inputs(8, tspec.dim, seed=5, steps=6, n=4)
    st = eng.init(torch.from_numpy(locs), 0.1 * torch.ones(8, tspec.dim))
    _, trace = eng.run_chunk_traced(st, 1, 6, log_every=2, noise=torch.from_numpy(draws))
    assert first_chain_divergence(trace, log_every=2) == (5, 2)
    keep = np.ones(8, bool)
    keep[5] = False
    assert np.all(np.isfinite(trace.numpy()[:, keep]))
    assert first_chain_divergence(np.zeros((3, 4), np.float32), 2) is None
    assert first_chain_divergence(trace.numpy(), 2) == jchains.first_chain_divergence(
        trace.numpy(), 2)


def test_fused_chains_minibatch_spec_matches_jax(flagship):
    """The staged minibatch spec drives the chains engine
    (tests/test_fused_chains.py:562): the JAX spec's permuted consts carried
    across by ``minibatch_spec_from_numpy``, the same draws, the same
    states."""
    jprob, _, _, _ = flagship
    jspec = jfused.logreg_minibatch_hbm_spec(jprob.X, jprob.y, batch_size=16,
                                             key=jax.random.key(2))
    d = jprob.dim
    tspec = convert.minibatch_spec_from_numpy(
        jspec.consts[0], jspec.consts[1], jprob.X.shape[0], 16,
        transport="logreg_minibatch_prefetch", device="cpu", db=d - 1)
    locs, sds, draws = _inputs(8, d, seed=2, steps=3, n=4)
    js, ts, jtr, ttr = _run_both(jspec, tspec, 8, {}, locs, sds, draws, n=4, log_every=1)
    _close(ts, js)
    assert ttr.shape == (3, 8) and np.all(np.isfinite(ttr.numpy()))
    assert_allclose(ttr.numpy(), np.asarray(jtr), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["adam", "mixed"])
def test_chain_is_the_single_chain_engine_and_general_path(flagship, kind):
    """Chain c of the engine on Philox draws (no injected noise) is the
    port's single-chain FusedADVI keyed by chain_seed_words(seed, c), and,
    for Adam, its general path on those words."""
    _, tprob, _, tspec = flagship
    d = tspec.dim
    rules = MIXED if kind == "mixed" else ["adam"] * C
    eng = FusedChainsADVI(tspec, n_chains=len(rules), n_samples=N, lr=1e-3,
                          optimizer=rules if kind == "mixed" else "adam", alpha=ALPHA)
    locs, sds, _ = _inputs(len(rules), d, seed=7)
    st = eng.run_chunk(eng.init(torch.from_numpy(locs), torch.from_numpy(sds)), 5, T)
    for c, rule in enumerate(rules):
        single = FusedADVI(tspec, n_samples=N, lr=1e-3)
        single.algo, single.alpha = rule, ALPHA
        s = single.run_chunk(single.init(torch.from_numpy(locs[c]), torch.from_numpy(sds[c])),
                             chain_seed_words(5, c), T)
        for f in ("mu", "sig", "m_mu", "m_sig", "avg_mu", "avg_sig"):
            assert_allclose(getattr(st, f)[c].numpy(), getattr(s, f).numpy(), err_msg=f, **TOL)
        assert_allclose(float(st.elbo[c]), float(s.elbo), rtol=1e-5, atol=1e-5)
    if kind == "adam":
        alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N, optimizer=avt.adam(1e-3),
                                      operator=avt.ClipScale())
        for c in range(C):
            q0 = avt.MeanFieldGaussian(torch.from_numpy(locs[c]), torch.from_numpy(sds[c]))
            _, _, gs = avt.optimize(chain_seed_words(5, c), alg, T, tprob.unconstrained(), q0)
            assert_allclose(st.mu[c].numpy(), gs.q.location.numpy(), **TOL)
            assert_allclose(st.sig[c].numpy(), gs.q.scale_diag.numpy(), **TOL)


def test_chain_seeds_are_distinct_and_stable():
    words = [chain_seed_words(9, c) for c in range(64)]
    assert len(set(words)) == 64 and words[0] != (9, 0)
    assert chain_seed_words(9, 3) == chain_seed_words((9, 0), 3)
    assert chain_seed_words(9, 3) != chain_seed_words(10, 3)
    table = chain_seed_table(9, 64)
    assert [tuple(map(int, r)) for r in table] == words
    # Philox4x32-10 at counter (3, 0, 0, "chns") under the words (0, 0)
    assert chain_seed_words(0, 3) == (1664625921, 1599556626)


def test_rule_set_is_kept_per_tensor():
    """A mixed sweep's rule codes are read from the tensor once, and again
    after an in-place change (a card tensor's read would wait for the card
    on every launch)."""
    rules = torch.tensor([RULE_CODES[o] for o in ("adam", "dowg", "adam")], dtype=torch.int32)
    assert rule_set(rules) == {RULE_CODES["adam"], RULE_CODES["dowg"]}
    assert rule_set(rules) is rule_set(rules)
    rules[1] = RULE_CODES["cocob"]
    assert rule_set(rules) == {RULE_CODES["adam"], RULE_CODES["cocob"]}
    assert rule_set(rules.clone()) == rule_set(rules)


def test_convert_roundtrips_chains_state_and_noise(flagship):
    _, _, jspec, tspec = flagship
    d = tspec.dim
    locs, sds, draws = _inputs(8, d)
    eng = FusedChainsADVI(tspec, n_chains=8, n_samples=N, optimizer=MIXED, alpha=ALPHA)
    st = eng.run_chunk(eng.init(torch.from_numpy(locs), torch.from_numpy(sds)), 1, T,
                       noise=torch.from_numpy(draws))
    padded = convert.chains_state_to_numpy(st, optimizer=MIXED)
    assert padded["mu"].shape == (8, 128)
    back = convert.chains_state_from_numpy(jchains.FusedChainsState(**padded), 8, d,
                                           device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.stacked(), st.stacked()))
    # the padding the JAX engine's init writes
    jeng = jchains.FusedChainsADVI(jspec, n_chains=8, optimizer=MIXED, alpha=ALPHA,
                                   interpret=True)
    j0 = jeng.init(jnp.asarray(locs), jnp.asarray(sds))
    t0 = convert.chains_state_to_numpy(eng.init(torch.from_numpy(locs), torch.from_numpy(sds)),
                                       optimizer=MIXED)
    for f in ("mu", "sig", "m_mu", "v_mu", "m_sig", "v_sig", "avg_mu", "avg_sig"):
        assert_allclose(t0[f], np.asarray(getattr(j0, f)), rtol=1e-7, err_msg=f)
    # noise rows t * R + s * c_pad + c (the JAX test's explicit loop)
    packed = convert.pack_chains_noise(draws)
    R = N * 8
    for t in range(T):
        for s in range(N):
            for c in range(8):
                assert np.array_equal(packed[t * R + s * 8 + c, :d], draws[t, c, s])
    assert packed.shape == (T * R, 128) and not packed[:, d:].any()
    assert convert.c_pad_for(3) == 8 and convert.c_pad_for(9) == 16


def test_fused_chains_validation(flagship):
    """The JAX engine's errors (tests/test_fused_chains.py:336-387, :691-713)
    with the TPU caps replaced by the per-block shared-memory check."""
    _, _, _, spec = flagship
    d = spec.dim
    with pytest.raises(ValueError, match="per-chain lr"):
        FusedChainsADVI(spec, n_chains=3, lr=np.ones(5, np.float32))
    with pytest.raises(ValueError, match="prox"):
        FusedChainsADVI(spec, n_chains=2, optimizer="adam", operator="prox")
    with pytest.raises(ValueError, match="zero-gradient"):
        FusedChainsADVI(spec, n_chains=2, optimizer="dowg", operator="prox")
    with pytest.raises(ValueError, match="n_samples >= 2"):
        FusedChainsADVI(spec, n_chains=2, n_samples=1, grad_est="scoregrad")
    # no TPU caps: the chain axis is the launch grid, and the card's per-block
    # shared-memory check (tests/test_torch_kernels.py) bounds n_samples
    FusedChainsADVI(spec, n_chains=500)
    FusedChainsADVI(spec, n_chains=8, n_samples=65)
    with pytest.raises(ValueError, match="step-size-driven"):
        FusedChainsADVI(spec, n_chains=8, lr=np.geomspace(1e-4, 1e-1, 8), optimizer="dowg")
    FusedChainsADVI(spec, n_chains=8, lr=np.geomspace(1e-4, 1e-1, 8), optimizer="adam")
    FusedChainsADVI(spec, n_chains=8, lr=torch.ones(8) * 1e-3, optimizer="descent")
    with pytest.raises(ValueError, match="entries"):
        FusedChainsADVI(spec, n_chains=8, optimizer=["adam"] * 7)
    with pytest.raises(ValueError, match="unknown optimizers"):
        FusedChainsADVI(spec, n_chains=8, optimizer=["adam"] * 7 + ["sgd"])
    with pytest.raises(ValueError, match="prox"):
        FusedChainsADVI(spec, n_chains=8, optimizer=["adam"] * 8, operator="prox")
    with pytest.raises(ValueError, match="lr"):
        FusedChainsADVI(spec, n_chains=8, optimizer=["dowg"] * 8, lr=np.ones(8) * 1e-3)
    with pytest.raises(ValueError, match="list"):
        FusedChainsADVI(spec, n_chains=8, optimizer="mixed")
    for bad in (dict(optimizer="sgdm"), dict(entropy="x"), dict(grad_est="x"),
                dict(operator="x")):
        with pytest.raises(ValueError, match="unknown"):
            FusedChainsADVI(spec, n_chains=2, **bad)
    eng = FusedChainsADVI(spec, n_chains=8)
    with pytest.raises(ValueError, match="locations"):
        eng.init(torch.zeros(4, d), torch.ones(4, d))
    st = eng.init(torch.zeros(8, d), 0.1 * torch.ones(8, d))
    with pytest.raises(ValueError, match="noise"):
        eng.run_chunk(st, 0, 2, noise=torch.zeros(8, 128))
    with pytest.raises(ValueError, match="log_every"):
        eng.run_chunk_traced(st, 0, 5, log_every=2)
    # run_sharded's checks (JAX's): 8 chains over an "mc" axis of 2 ranks
    # leave blocks of 4 (the sharded runs: tests/test_torch_multiprocess.py)
    class _TwoRanks:
        mesh_dim_names = ("data", "mc")

        def size(self, dim):
            return (1, 2)[dim]

    with pytest.raises(ValueError, match="per-device chain block 4 must be a multiple of 8"):
        eng.run_sharded(st, 0, 2, _TwoRanks())
    with pytest.raises(ValueError, match="mixed per-chain rule sweeps"):
        FusedChainsADVI(spec, n_chains=8, optimizer=["adam"] * 8).run_sharded(
            st, 0, 2, _TwoRanks())
    cocob = FusedChainsADVI(spec, n_chains=8, optimizer="cocob")
    with pytest.raises(ValueError, match="ext"):
        cocob.run_chunk(st, 0, 1)
    mixed = FusedChainsADVI(spec, n_chains=8, optimizer=MIXED)
    with pytest.raises(ValueError, match="cocob rows"):
        mixed.run_chunk(st, 0, 1)
    with pytest.raises(ValueError, match="no fused chains engine"):
        fused_chains_run_chunk(spec.model, spec.consts, spec.scalars,
                               st.stacked().to("meta"), eng.chain_seeds(0), 0, 1, 10, eng.hyp)
    seeds = eng.chain_seeds(5)
    assert seeds.dtype == torch.int32 and eng.chain_seeds(5) is seeds
    assert [(w0 & 0xFFFFFFFF, w1 & 0xFFFFFFFF) for w0, w1 in seeds.tolist()] == [
        chain_seed_words(5, c) for c in range(8)]
    assert isinstance(st, FusedChainsState) and st.ext is None


# The chains a block of a card launch (csrc/fused_chains.cu, K6).  The rule
# asks the kernel's own count of a block's shared memory, which only a card
# can build; here it asks a stand-in holding that count's figures at each
# layout, as (model, n_data, db, batch, n, d, n_rows): the bytes of one
# chain's block (the single-chain layout), and of a block of G > 1 chains,
# the model's data once plus G chains' arrays (tests/test_torch_kernels.py
# holds the kernel's count to these figures on the card).  The largest G
# whose block fits 232,448 bytes: the flagship logreg (72,800 bytes one
# chain, 220,544 eight), the diagonal Gaussian on its kGauss layout (each
# chain's state rows, row-block gradients and slice partials, nothing
# shared: capped at 32 chains, the ELBO threads of one warp, at d = 11, and
# 6 at d = 512), the three minibatch transports
# at n = 16,384, B = 512 (the staged slab 125 KB), and a design too large
# for the aligned layout (771 x 61, the kDensePlain group: one chain).
G_LAYOUTS = {
    "flagship": (("logreg", 208, 61, 0, 10, 62, 8), (72800, 51584, 21120), 8),
    "flagship-cocob": (("logreg", 208, 61, 0, 10, 62, 14), (74288, 51584, 22608), 8),
    "gaussian": (("gaussian", 0, 0, 0, 10, 11, 8), (1384, 0, 1384), MAX_CHAINS_PER_BLOCK),
    "gaussian-512": (("gaussian", 0, 0, 0, 10, 512, 8), (33292, 0, 33292), 6),
    "inplace": (("logreg_minibatch", 16384, 61, 512, 10, 62, 8), (33632, 256, 33280), 6),
    "staged": (("logreg_minibatch_staged", 16384, 61, 512, 10, 62, 8),
               (158560, 125184, 33280), 3),
    "prefetch": (("logreg_minibatch_prefetch", 16384, 61, 512, 10, 62, 14),
                 (160048, 125184, 34768), 3),
    "plain": (("logreg", 771, 61, 0, 10, 62, 8), (232384, 191208, 41080), 1),
}
SMEM = 232448


def _block_bytes(name):
    """The stand-in for the kernel's count: G -> a block's bytes."""
    one, shared, per_chain = G_LAYOUTS[name][1]
    return lambda G: one if G == 1 else shared + G * per_chain


def _per_block(name, C, sms):
    model, *shape = G_LAYOUTS[name][0]
    return chains_per_block(model, C, sms, shape[4], _block_bytes(name))


@pytest.mark.parametrize("name", list(G_LAYOUTS))
@pytest.mark.parametrize("sms", [1, 7, 132, 144])
def test_chains_per_block_is_one_while_the_chains_fit_the_sms(name, sms):
    """C <= SMs launches one chain a block, the single-chain body."""
    for C in sorted({1, max(1, sms // 2), sms}):
        assert _per_block(name, C, sms) == 1, C


@pytest.mark.parametrize("name", list(G_LAYOUTS))
def test_chains_per_block_is_capped_by_the_layout(name):
    """Above the SMs, G = ceil(C / SMs) up to the largest G whose layout fits
    one block (that layout fits and the next does not, or the cap holds);
    above SMs x G_max, the fewest chains a block whose blocks fill the
    fewest waves G_max allows."""
    g_max = G_LAYOUTS[name][2]
    fits = _block_bytes(name)
    assert fits(g_max) <= SMEM
    if g_max < MAX_CHAINS_PER_BLOCK:
        assert fits(g_max + 1) > SMEM
    for sms in (132, 7):
        def waves(C, g):
            return -(-(-(-C // g)) // sms)

        for C in (sms + 1, 2 * sms, 2 * sms + 1, 3 * sms, 4 * sms, 8 * sms, 64 * sms + 5):
            G = _per_block(name, C, sms)
            if C <= sms * g_max:
                assert G == min(-(-C // sms), g_max), (sms, C)
            assert 1 <= G <= g_max and waves(C, G) == waves(C, g_max), (sms, C, G)
            assert G == 1 or waves(C, G - 1) > waves(C, g_max), (sms, C, G)
    # the staged minibatch (G_max 3) at 512 chains on 132 SMs: two waves
    # either way, so two chains a block, not three
    assert _per_block("staged", 512, 132) == 2


def test_chains_per_block_asks_the_kernel_for_the_engines_layout(flagship):
    """The engine hands the kernel's count its model code, design, batch,
    samples, width and state rows, and a G for each block it weighs."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import MODEL_CODES

    _, _, _, spec = flagship
    asked = []

    def count(*args):
        asked.append(args)
        return _block_bytes("flagship")(args[-1])

    eng = FusedChainsADVI(spec, n_chains=1024, optimizer="cocob")
    assert eng.chains_per_block(132, count) == 8
    assert [a[:-1] for a in asked] == [(MODEL_CODES["logreg"], 208, 61, 0, 10, 62, 14)] * 7
    assert [a[-1] for a in asked] == list(range(2, 9))


def test_chains_per_block_is_one_for_ad_and_wide_chains(flagship):
    """K5's generated body is placed for one chain, and a block of several
    chains maps one lane a thread (d <= 512) but on the diagonal Gaussian,
    whose kGauss block takes the chains' 4-column groups in turn (any d)."""
    small = _block_bytes("gaussian")
    assert chains_per_block("ad", 4096, 132, 62, small) == 1
    assert chains_per_block("logreg", 4096, 132, 513, small) == 1
    assert chains_per_block("gaussian", 4096, 132, 513, small) > 1
    assert chains_per_block("gaussian", 4096, 132, 512, small) > 1
    _, tprob, _, spec = flagship
    assert [FusedChainsADVI(spec, n_chains=C).chains_per_block(
        132, lambda *a: _block_bytes("flagship")(a[-1]))
        for C in (64, 132, 133, 512, 1024, 4096)] == [1, 1, 2, 4, 8, 8]
    ad = FusedChainsADVI(avt.ad_spec(tprob.unconstrained()), n_chains=1024)
    assert ad.chains_per_block(132) == 1
