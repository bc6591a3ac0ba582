"""Port parity at the fused engines' envelope: the dense Gaussian
(``mvnormal_spec``) on every mean-field engine and the chains engine, and the
sizes whose arrays one block's shared memory cannot hold (on a card they run
the kernels' device-memory layouts: csrc/fused_meanfield_body.cuh
``wide_layout`` and, for the minibatch transports, ``mb_layout``;
csrc/fused_advi_fullrank.cu ``tier_layout`` for the full-rank family's
single-block launches), run here through the kernels' plain PyTorch versions
against the JAX engines in Pallas interpret mode on the same injected draws.
The kernels themselves are held to the plain versions on a card
(tests/test_torch_kernels.py, chip_smoke.py phases (af) and (ag)).  K5's
bodies at the envelope: tests/test_torch_fused_envelope_k5.py.

Tolerances are tests/test_fused_advi.py's: rtol 1e-5 and atol 1e-6 on the
parameters and their averages, 1e-4 on the ELBO.  DoWG runs with r0 scale
1e-2 for the reason given in tests/test_torch_prox_scoregrad.py.
"""

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
from advancedvi_jl_tpu.ops.pallas import fused_chains as jchains
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.ops.cuda import fused_advi as tfused
from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import MINIBATCH_MODELS
from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import FusedChainsADVI

torch.set_num_threads(2)

N = 10
PARAMS = ("mu", "sig", "avg_mu", "avg_sig")
TOL = dict(rtol=1e-5, atol=1e-6)
ALPHA = 1e-2


def _normal(d):
    """JAX's normal_fullrank fixture (tests/test_fused_advi.py:388 at d = 6)
    and the same target in the port."""
    jt, _, _ = jax_normal_fullrank(jax.random.key(2), d)
    tt = convert.normal_target_from_numpy(np.asarray(jt.mu), np.asarray(jt.scale_tril),
                                          device="cpu")
    return jt, tt


def _gauss(d, seed=1):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(d).astype(np.float32)
    sd = (0.5 + rng.random(d)).astype(np.float32)
    return (jfused.gaussian_spec(jnp.asarray(mean), jnp.asarray(sd)),
            tfused.gaussian_spec(torch.from_numpy(mean), torch.from_numpy(sd)))


def _logreg(n_data, n_features):
    jprob = jax_make_logreg(jax.random.key(4), n_data=n_data, n_features=n_features)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device="cpu")
    return (jfused.logreg_spec(jprob.X, jprob.y, prior_scale=jprob.prior_scale,
                               likeadj=float(jprob.likeadj)),
            tfused.logreg_spec(tprob.X, tprob.y, prior_scale=tprob.prior_scale,
                               likeadj=float(tprob.likeadj)))


def _mvnormal(d):
    jt, tt = _normal(d)
    return (jfused.mvnormal_spec(jt.mu, jt.scale_tril),
            tfused.mvnormal_spec(tt.mu, tt.scale_tril))


def _start(d, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.3, d).astype(np.float32),
            rng.uniform(0.3, 0.6, d).astype(np.float32))


def _single(jspec, tspec, kind, steps, n=N, seed=0, family="meanfield"):
    """The JAX engine (interpret mode) and the port's ``kind`` engine
    ("advi", "prox": DoWG, "dog": prox with DoG, "bbvi": VarGrad with Adam)
    on the same injected draws; the JAX state comes back in the port's
    layout."""
    d = tspec.dim
    kw = dict(family=family, n_samples=n)
    if kind == "advi":
        jeng = jfused.FusedADVI(jspec, lr=1e-3, interpret=True, **kw)
        teng = tfused.FusedADVI(tspec, lr=1e-3, **kw)
    elif kind in ("prox", "dog"):
        algo = "dog" if kind == "dog" else "dowg"
        jeng = jfused.FusedProxADVI(jspec, optimizer=algo, alpha=ALPHA, interpret=True, **kw)
        teng = tfused.FusedProxADVI(tspec, optimizer=algo, alpha=ALPHA, **kw)
    else:  # VarGrad: mean-field only
        jeng = jfused.FusedScoreGradVI(jspec, n_samples=n, optimizer="adam", lr=1e-3,
                                       operator="clip", interpret=True)
        teng = tfused.FusedScoreGradVI(tspec, n_samples=n, optimizer="adam", lr=1e-3,
                                       operator="clip")
    loc, sd = _start(d)
    scale = sd if family == "meanfield" else np.diag(sd)
    noise = np.random.default_rng(seed).standard_normal((steps, n, d)).astype(np.float32)
    js = jeng.run_chunk(jeng.init(jnp.asarray(loc), jnp.asarray(scale)), jax.random.key(1),
                        steps=steps,
                        noise=jnp.asarray(convert.pack_noise(noise, d_pad=jeng.d_pad)))
    ts = teng.run_chunk(teng.init(torch.from_numpy(loc), torch.from_numpy(scale)), 1, steps,
                        noise=torch.from_numpy(noise))
    return convert.fused_state_from_numpy(js, d, device="cpu"), ts, js


def _close(want, got, fields=PARAMS):
    for f in fields:
        assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(), err_msg=f, **TOL)


def _chains(jspec, tspec, n_chains, steps, n=N, seed=5):
    """The chains engines on the same injected draws, each chain from its
    own start."""
    d = tspec.dim
    rng = np.random.default_rng(seed)
    locs = rng.normal(0, 0.3, (n_chains, d)).astype(np.float32)
    sds = rng.uniform(0.3, 0.6, (n_chains, d)).astype(np.float32)
    draws = rng.standard_normal((steps, n_chains, n, d)).astype(np.float32)
    jeng = jchains.FusedChainsADVI(jspec, n_chains=n_chains, n_samples=n, interpret=True)
    teng = FusedChainsADVI(tspec, n_chains=n_chains, n_samples=n)
    js = jeng.run_chunk(jeng.init(jnp.asarray(locs), jnp.asarray(sds)), jax.random.key(1),
                        steps, noise=jnp.asarray(convert.pack_chains_noise(draws)))
    ts = teng.run_chunk(teng.init(torch.from_numpy(locs), torch.from_numpy(sds)), 1, steps,
                        noise=torch.from_numpy(draws))
    return convert.chains_state_from_numpy(js, n_chains, d, device="cpu"), ts


@pytest.mark.parametrize("d", [6, 200, 512])
@pytest.mark.parametrize("kind", ["advi", "prox", "bbvi"])
def test_mvnormal_on_the_meanfield_engines_matches_jax(kind, d):
    """The dense Gaussian on FusedADVI, FusedProxADVI (DoWG) and
    FusedScoreGradVI (VarGrad, Adam): JAX's fixture at d = 6, at d = 200
    (d_pad 256) and at d = 512 (on a card: P streamed through the product's
    ring), 5 steps."""
    jspec, tspec = _mvnormal(d)
    want, got, js = _single(jspec, tspec, kind, 5)
    _close(want, got)
    assert_allclose(float(got.elbo), float(js.elbo), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [6, 200, 512])
def test_mvnormal_on_the_chains_engine_matches_jax(d):
    """Four chains of the dense Gaussian, each chain at the same bars."""
    jspec, tspec = _mvnormal(d)
    want, got = _chains(jspec, tspec, 4, 5)
    _close(want, got)
    assert_allclose(got.elbo.numpy(), want.elbo.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [5, 62, 512])
def test_the_kernels_padded_precision_keeps_the_plain_version_bitwise(d):
    """The precision as the mean-field and chains wrappers hand it to the
    kernels (``kernel_precision``: rows of round4(d) floats, zeros beyond
    d, one copy per tensor; P itself where d is a multiple of 4) holds P's
    values bit for bit: the plain version on its first d columns gives the
    bits it gives on P (10 injected-noise steps, and the body alone)."""
    _, tspec = _mvnormal(d)
    mean, P = tspec.consts
    kp = tfused.kernel_precision(P)
    ld = -(-d // 4) * 4
    assert tuple(kp.shape) == (d, ld) and kp.data_ptr() % 16 == 0
    assert torch.equal(kp[:, :d], P) and not kp[:, d:].any()
    assert tfused.kernel_precision(P) is kp and (kp is P) == (ld == d)
    if ld != d:  # changed in place: copied again
        P2 = P.clone()
        first = tfused.kernel_precision(P2)
        P2[0, 0] += 1.0
        again = tfused.kernel_precision(P2)
        assert again is not first and float(again[0, 0]) == float(P2[0, 0])
    rng = np.random.default_rng(d)
    z = torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32))
    for a, b in zip(tfused.mvnormal_logpi_grad(z, mean, kp[:, :d], *tspec.scalars),
                    tfused.mvnormal_logpi_grad(z, mean, P, *tspec.scalars)):
        assert torch.equal(a, b)
    eng = avt.FusedADVI(tspec, n_samples=N)
    st = eng.init(torch.zeros(d), 0.5 * torch.ones(d)).stacked()
    noise = torch.from_numpy(rng.standard_normal((10, N, d)).astype(np.float32))
    hyp = tfused.FusedHyper()
    runs = [tfused.fused_run_chunk_reference("mvnormal", consts, tspec.scalars, st, (0, 1), 0,
                                             10, N, hyp, noise, 5)
            for consts in ((mean, kp[:, :d]), (mean, P))]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_fused_spec_for_a_normal_target_runs_on_the_meanfield_engine():
    """fused_spec_for routes a NormalTarget to mvnormal_spec, as JAX's does,
    and the mean-field engine takes it and runs (the plain version here)."""
    jt, _ = _normal(6)
    target = convert.normal_target_from_numpy(np.asarray(jt.mu), np.asarray(jt.scale_tril),
                                              device="cpu")
    spec = avt.fused_spec_for(target)
    assert spec.model == "mvnormal" and jfused.fused_spec_for(jt).step_factory is \
        jfused._mvnormal_step_factory
    eng = avt.FusedADVI(spec, n_samples=N)
    q, rows, st = eng.optimize(0, 300, avt.MeanFieldGaussian(torch.zeros(6), torch.ones(6)),
                               log_every=100)
    assert st.iteration == 300 and all(np.isfinite(r["elbo"]) for r in rows)
    assert rows[-1]["elbo"] > rows[0]["elbo"] and tuple(q.scale_diag.shape) == (6,)


# the sizes JAX's mean-field engines take that one block's shared memory
# cannot hold with every array in it (about 328 KB, 811 KB, 470 KB, 328 KB
# and over 1 MB at 8 state rows)
WIDE = {
    "gaussian_d2048": lambda: _gauss(2048),
    "gaussian_d512_n128": lambda: _gauss(512, seed=2),
    "logreg_512x199": lambda: _logreg(512, 198),
    "mvnormal_d512": lambda: _mvnormal(512),
}


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_configurations_match_jax(name):
    """2 steps of each wide configuration, at the same bars."""
    jspec, tspec = WIDE[name]()
    n = 128 if name.endswith("n128") else N
    want, got, js = _single(jspec, tspec, "advi", 2, n=n)
    _close(want, got)
    assert_allclose(float(got.elbo), float(js.elbo), rtol=1e-4, atol=1e-4)


def test_wide_chains_match_jax():
    """Eight chains of the d = 2,048 Gaussian (one chain a block on a card,
    each with its slice of the device workspace), 2 steps."""
    jspec, tspec = _gauss(2048)
    want, got = _chains(jspec, tspec, 8, 2)
    _close(want, got)
    assert_allclose(got.elbo.numpy(), want.elbo.numpy(), rtol=1e-4, atol=1e-4)


def _accepts(build) -> bool:
    try:
        build()
    except ValueError:
        return False
    return True


def _engines(engine, d, n=N, C=8):
    """(JAX build, port build) of ``engine`` on a Gaussian of width d:
    each builds the spec and the engine."""
    rng = np.random.default_rng(0)
    mean, sd = rng.standard_normal(d).astype(np.float32), np.ones(d, np.float32)

    def jax_build():
        spec = jfused.gaussian_spec(jnp.asarray(mean), jnp.asarray(sd))
        if engine == "chains":
            return jchains.FusedChainsADVI(spec, n_chains=C, n_samples=n, interpret=True)
        if engine == "bbvi":
            return jfused.FusedScoreGradVI(spec, n_samples=n, operator="clip", interpret=True)
        cls = {"advi": jfused.FusedADVI, "prox": jfused.FusedProxADVI}[engine]
        return cls(spec, n_samples=n, interpret=True)

    def port_build():
        spec = tfused.gaussian_spec(torch.from_numpy(mean), torch.from_numpy(sd))
        if engine == "chains":
            return FusedChainsADVI(spec, n_chains=C, n_samples=n)
        if engine == "bbvi":
            return tfused.FusedScoreGradVI(spec, n_samples=n, operator="clip")
        cls = {"advi": tfused.FusedADVI, "prox": tfused.FusedProxADVI}[engine]
        return cls(spec, n_samples=n)

    return jax_build, port_build


# (engine, d, n, chains, JAX accepts, the port accepts): each of JAX's
# envelope edges and one step beyond it.  The port refuses what JAX refuses
# for the algorithm or the kernels' layout: d > 2,048 (one block keeps the
# state rows) and VarGrad with n < 2.  JAX's sample-count and chain-budget
# caps were TPU VMEM budgets; the port keeps accepting beyond them (its
# chains engine since the chains slice, tests/test_torch_fused_chains.py
# test_fused_chains_validation's n_samples = 65 and 500 chains; the single-chain
# engines never had the cap), so there the two differ by design.
EDGES = [
    ("advi", 2048, N, 8, True, True), ("advi", 2049, N, 8, False, False),
    ("prox", 2048, N, 8, True, True), ("prox", 2049, N, 8, False, False),
    ("bbvi", 2048, N, 8, True, True), ("bbvi", 2049, N, 8, False, False),
    ("bbvi", 6, 2, 8, True, True), ("bbvi", 6, 1, 8, False, False),
    ("advi", 6, 128, 8, True, True), ("advi", 6, 129, 8, False, True),
    ("chains", 2048, N, 8, True, True), ("chains", 2049, N, 8, False, False),
    ("chains", 6, 64, 8, True, True), ("chains", 6, 65, 8, False, True),
    # c_pad d_pad = 16,384 (8 x 2,048; 128 x 128) and one chain beyond
    ("chains", 2048, 8, 8, True, True), ("chains", 2048, 8, 9, False, True),
    ("chains", 128, 8, 128, True, True), ("chains", 128, 8, 129, False, True),
    # n_pad c_pad d_pad = 262,144 (16 x 8 x 2,048) and 8 samples beyond
    ("chains", 2048, 16, 8, True, True), ("chains", 2048, 24, 8, False, True),
]


@pytest.mark.parametrize("engine,d,n,C,jax_ok,port_ok", EDGES,
                         ids=[f"{e[0]}-d{e[1]}-n{e[2]}-C{e[3]}" for e in EDGES])
def test_engines_accept_what_jax_accepts_at_its_edges(engine, d, n, C, jax_ok, port_ok):
    """At every edge of JAX's envelope both accept; one step beyond, the
    port refuses what JAX refuses but for the TPU budgets named above."""
    jax_build, port_build = _engines(engine, d, n, C)
    assert _accepts(jax_build) == jax_ok
    assert _accepts(port_build) == port_ok


# ---------------------------------------------------------------------------
# The minibatch transports and the full-rank family beyond one block
# ---------------------------------------------------------------------------


def _minibatch(n_data, batch, transport, n_features=60):
    """JAX's minibatch spec (its own permutation) of make_logreg(key 4) and
    the port's spec of ``transport`` on the same packed consts."""
    jprob = jax_make_logreg(jax.random.key(4), n_data=n_data, n_features=n_features)
    jspec = jfused.logreg_minibatch_spec(jprob.X, jprob.y, batch_size=batch,
                                         key=jax.random.key(2))
    tspec = convert.minibatch_spec_from_numpy(*jspec.consts, n_data, batch, jprob.prior_scale,
                                              transport, device="cpu", db=jprob.dim - 1)
    return jspec, tspec


# (n_data, B, n): the minibatch sizes JAX takes whose logits or staged slab
# one block's shared memory cannot hold (the kMbWide group on a card: a
# 1,024-row slab of 61 features is 249,856 bytes; 128 rows of 512 logits
# are 262,144)
MB_WIDE = [(4096, 1024, N), (4096, 512, 128)]


@pytest.mark.parametrize("transport", MINIBATCH_MODELS)
@pytest.mark.parametrize("n_data,batch,n", MB_WIDE, ids=[f"B{b}-n{n}" for _, b, n in MB_WIDE])
def test_wide_minibatch_transports_match_jax(n_data, batch, n, transport):
    """Each transport at B = 1,024 (n = 10) and at B = 512 (n = 128) on a
    4,096 x 61 design, 2 steps (batches 0 and 1)."""
    jspec, tspec = _minibatch(n_data, batch, transport)
    want, got, js = _single(jspec, tspec, "advi", 2, n=n)
    _close(want, got)
    assert_allclose(float(got.elbo), float(js.elbo), rtol=1e-4, atol=1e-4)


# (name, spec builder, n, kind): the full-rank engine's configurations that
# run on its single-block kernel's tiered layout on a card: the staged
# transports' 1,024-row slab (d = 62), the d = 512, n = 128 dense Gaussian
# (forced to one block there) under Adam, DoWG and DoG, and the 512 x 199
# logreg under DoWG (on one block by its rule)
FR_WIDE = {
    "mb_staged_B1024": (lambda: _minibatch(4096, 1024, tfused.LOGREG_MB_STAGED), N, "advi"),
    "mb_prefetch_B1024": (lambda: _minibatch(4096, 1024, tfused.LOGREG_MB_PREFETCH), N,
                          "advi"),
    "mvnormal_d512_n128_adam": (lambda: _mvnormal(512), 128, "advi"),
    "mvnormal_d512_n128_dowg": (lambda: _mvnormal(512), 128, "prox"),
    "mvnormal_d512_n128_dog": (lambda: _mvnormal(512), 128, "dog"),
    "logreg_512x199_dowg": (lambda: _logreg(512, 198), N, "prox"),
}


@pytest.mark.parametrize("name", list(FR_WIDE))
def test_wide_fullrank_configurations_match_jax(name):
    """2 steps of each on the full-rank engines, at the same bars."""
    build, n, kind = FR_WIDE[name]
    jspec, tspec = build()
    want, got, js = _single(jspec, tspec, kind, 2, n=n, family="fullrank")
    _close(want, got)
    assert_allclose(float(got.elbo), float(js.elbo), rtol=1e-4, atol=1e-4)


def _logreg_xy(n_data=64, n_features=4):
    jprob = jax_make_logreg(jax.random.key(4), n_data=n_data, n_features=n_features)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device="cpu")
    return jprob, tprob


# What the port refuses, each beside JAX's answer: the envelope's widths
# (EDGES above, tests/test_torch_fused_envelope_k5.py EDGES) and VarGrad's
# n >= 2, and here the minibatch builders' batch: a multiple of 8, at most
# n_data (JAX ops/pallas/fused_advi.py:1090-1141).  Nothing else: no
# configuration inside JAX's envelope is refused for shared memory.
BATCH_EDGES = [(8, True), (12, False), (64, True), (72, False)]


@pytest.mark.parametrize("batch,ok", BATCH_EDGES, ids=[f"B{b}" for b, _ in BATCH_EDGES])
def test_minibatch_builders_refuse_what_jax_refuses(batch, ok):
    """The two minibatch builders at B = 8 and 64 (= n_data) accept, as
    JAX's do; B = 12 (not a multiple of 8) and 72 (over n_data) are refused
    by both."""
    jprob, tprob = _logreg_xy()
    builds = (lambda: jfused.logreg_minibatch_spec(jprob.X, jprob.y, batch_size=batch),
              lambda: jfused.logreg_minibatch_hbm_spec(jprob.X, jprob.y, batch_size=batch),
              lambda: tfused.logreg_minibatch_spec(tprob.X, tprob.y, batch),
              lambda: tfused.logreg_minibatch_hbm_spec(tprob.X, tprob.y, batch))
    assert [_accepts(b) for b in builds] == [ok] * 4
