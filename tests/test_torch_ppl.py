"""Port parity of model ingestion (advancedvi_jl_tpu_torch.ppl) against the
JAX package's ppl, after tests/test_ppl.py (numpyro aside: the port has no
``from_numpyro``): the same model written in each package's ops, the same
numpy data through both, the ingested log density at the same theta, ADVI
steps on JAX's injected draws, the error paths word for word, and the
ingested model through ``fused_spec_for`` (K5's plain version, the graph's
replay) held to JAX's ad-spec engine in interpret mode
(tests/test_fused_ad_spec.py:125)."""

import functools
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
from advancedvi_jl_tpu import ppl as jppl
from advancedvi_jl_tpu.models.logreg import make_logreg as jax_make_logreg
from advancedvi_jl_tpu.ops.pallas import fused_advi as jfused
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch import ppl
from advancedvi_jl_tpu_torch.ops.cuda import ad_body
from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import FusedADVI

torch.set_num_threads(1)

T = 4
N_SAMPLES = 8
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# One model in each package's ops
# ---------------------------------------------------------------------------


def _jax_logreg_model(data):
    d = data["X"].shape[1]
    sigma = jppl.sample("sigma", jppl.LogNormal(0.0, 3.0))
    beta = jppl.sample("beta", jppl.Normal(jnp.zeros(d), sigma))
    logits = data["X"] @ beta
    with jppl.plate("obs", data["X"].shape[0]):
        jppl.sample("y", jppl.Bernoulli(logits=logits), obs=data["y"])


def _logreg_model(data):
    X = data["X"]
    sigma = ppl.sample("sigma", ppl.LogNormal(0.0, 3.0))
    beta = ppl.sample("beta", ppl.Normal(X.new_zeros(X.shape[1]), sigma))
    logits = X @ beta
    with ppl.plate("obs", X.shape[0]):
        ppl.sample("y", ppl.Bernoulli(logits=logits), obs=data["y"])


def _logreg_data(n=64, d=5, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    beta = rng.standard_normal(d)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ beta))).astype(np.float32)
    return {"X": X, "y": y}


def _flagship_data():
    """bench.py's design: make_logreg(key 11), 208 x 61 with the intercept."""
    jp = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
    return {"X": np.asarray(jp.X), "y": np.asarray(jp.y)}, jp


def _both(jmodel, tmodel, data=None):
    if data is None:
        return jppl.ingest(jmodel), ppl.ingest(tmodel, device="cpu")
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    return jppl.ingest(jmodel, data=jdata), ppl.ingest(tmodel, data=data, device="cpu")


def _thetas(d, n=6, seed=3, scale=0.7):
    return (scale * np.random.default_rng(seed).standard_normal((n, d))).astype(np.float32)


def _assert_same_layout(jm, tm):
    assert tm.dim == jm.dim and tm.dim_constrained == jm.dim_constrained
    assert list(tm.latents) == list(jm.latents)
    for name, meta in jm.latents.items():
        tmeta = tm.latents[name]
        for key in ("observed", "in_plate", "plate_size", "support", "dist_type", "interval"):
            assert tmeta[key] == meta[key], (name, key)
        assert tmeta["shape"] == tuple(meta["shape"]), name


def _assert_same_density(jm, tm, d, rtol=1e-6, atol=0.0, seed=3, scale=0.7):
    th = _thetas(d, seed=seed, scale=scale)
    want = np.asarray(jax.vmap(jm.target.log_density)(jnp.asarray(th)))
    got = tm.target.log_density(torch.from_numpy(th))
    assert got.shape == (th.shape[0],)
    assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    assert_allclose(float(tm.target.log_density(torch.from_numpy(th[0]))), want[0],
                    rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# The ingested log density
# ---------------------------------------------------------------------------


def test_logreg_layout_and_density_match_jax():
    jm, tm = _both(_jax_logreg_model, _logreg_model, _logreg_data())
    _assert_same_layout(jm, tm)
    assert tm.dim == 6 and list(tm.latents) == ["sigma", "beta"]
    _assert_same_density(jm, tm, 6)


def test_flagship_density_matches_jax_at_full_width():
    """bench.py's 208 x 61 design (d = 62), the smoke's ingested flagship."""
    data, _ = _flagship_data()
    jm, tm = _both(_jax_logreg_model, _logreg_model, data)
    _assert_same_layout(jm, tm)
    assert tm.dim == 62
    _assert_same_density(jm, tm, 62, seed=4, scale=0.3)


def test_ingested_density_equals_the_hand_written_logreg():
    """The constrained-space log joint is models/logreg.py's LogReg at the
    same [beta, sigma] (the ingested order is sigma, beta)."""
    data = _logreg_data()
    tm = ppl.ingest(_logreg_model, data=data, device="cpu")
    ref = convert.logreg_from_numpy(data["X"], data["y"], device="cpu")
    beta = torch.tensor([0.3, -0.2, 0.5, 0.1, -0.4])
    sigma = torch.tensor([1.7])
    assert_allclose(float(tm.target.prob.log_density(torch.cat([sigma, beta]))),
                    float(ref.log_density(torch.cat([beta, sigma]))), rtol=1e-6)


def test_numpy_data_become_float32_tensors_on_the_device():
    tm = ppl.ingest(_logreg_model, data=_logreg_data(), device="cpu")
    data = tm.target.prob.data
    assert data["X"].dtype == torch.float32 and data["X"].device.type == "cpu"
    assert tm.q_init().location.device.type == "cpu"


def _jax_rescale_model(data):
    mu = jppl.sample("mu", jppl.Normal(0.0, 1.0))
    jppl.sample("global_obs", jppl.Normal(mu, 2.0), obs=jnp.asarray(0.7))
    with jppl.plate("obs", data["y"].shape[0]):
        jppl.sample("y", jppl.Normal(mu, 1.0), obs=data["y"])


def _rescale_model(data):
    mu = ppl.sample("mu", ppl.Normal(0.0, 1.0))
    ppl.sample("global_obs", ppl.Normal(mu, 2.0), obs=torch.tensor(0.7))
    with ppl.plate("obs", data["y"].shape[0]):
        ppl.sample("y", ppl.Normal(mu, 1.0), obs=data["y"])


def test_subsample_rescales_only_plate_sites():
    """n / batch on the plate-observed likelihood only; the prior and the
    global evidence outside the plate are never rescaled (the reference's
    likeadj contract), as JAX's."""
    y = np.array([0.5, -1.0, 2.0, 0.0], np.float32)
    jm, tm = _both(_jax_rescale_model, _rescale_model, {"y": y})
    sub = tm.target.subsample(torch.tensor([1, 3]))
    jsub = jm.target.subsample(jnp.asarray([1, 3]))
    mu = 0.4

    def n01(x, loc, sc):
        return -0.5 * ((x - loc) / sc) ** 2 - math.log(sc) - 0.5 * math.log(2 * math.pi)

    want = n01(mu, 0.0, 1.0) + n01(0.7, mu, 2.0) + 2.0 * (n01(y[1], mu, 1.0) + n01(y[3], mu, 1.0))
    got = float(sub.log_density(torch.tensor([mu])))
    assert_allclose(got, want, rtol=1e-6)
    assert_allclose(got, float(jsub.log_density(jnp.asarray([mu]))), rtol=1e-6)
    assert float(sub.prob.likeadj) == 2.0


# ---------------------------------------------------------------------------
# Supports: simplex, interval, positive
# ---------------------------------------------------------------------------

ALPHA = np.array([2.0, 1.0, 3.0], np.float32)
COUNTS = np.array([14, 5, 21])
OBS = np.repeat(np.arange(3), COUNTS)


def _jax_dirichlet_model():
    p = jppl.sample("p", jppl.Dirichlet(jnp.asarray(ALPHA)))
    with jppl.plate("obs", OBS.shape[0]):
        jppl.sample("y", jppl.Categorical(logits=jnp.log(p)), obs=jnp.asarray(OBS))


def _dirichlet_model():
    p = ppl.sample("p", ppl.Dirichlet(torch.from_numpy(ALPHA)))
    with ppl.plate("obs", OBS.shape[0]):
        ppl.sample("y", ppl.Categorical(logits=torch.log(p)), obs=torch.from_numpy(OBS))


def _jax_interval_model():
    r = jppl.sample("rate", jppl.HalfNormal(2.0))
    w = jppl.sample("w", jppl.Uniform(-1.0, 1.0))
    jppl.sample("y", jppl.Normal(w * 3.0 + r, 1.0), obs=jnp.asarray([2.0, 2.2]))


def _interval_model():
    r = ppl.sample("rate", ppl.HalfNormal(2.0))
    w = ppl.sample("w", ppl.Uniform(-1.0, 1.0))
    ppl.sample("y", ppl.Normal(w * 3.0 + r, 1.0), obs=torch.tensor([2.0, 2.2]))


ALPHA2 = np.array([[2.0, 1.0, 3.0], [1.0, 1.0, 1.0]], np.float32)
COUNTS2 = np.array([[8, 3, 9], [2, 10, 4]])


def _jax_batched_dirichlet_model():
    p = jppl.sample("p", jppl.Dirichlet(jnp.asarray(ALPHA2)))
    for i in range(2):
        jppl.sample(f"y{i}", jppl.Categorical(logits=jnp.log(p[i])),
                    obs=jnp.asarray(np.repeat(np.arange(3), COUNTS2[i])))


def _batched_dirichlet_model():
    p = ppl.sample("p", ppl.Dirichlet(torch.from_numpy(ALPHA2)))
    for i in range(2):
        ppl.sample(f"y{i}", ppl.Categorical(logits=torch.log(p[i])),
                   obs=torch.from_numpy(np.repeat(np.arange(3), COUNTS2[i])))


SUPPORT_MODELS = {
    "simplex": (_jax_dirichlet_model, _dirichlet_model, (2, 3)),
    "interval_positive": (_jax_interval_model, _interval_model, (2, 2)),
    "batched_simplex": (_jax_batched_dirichlet_model, _batched_dirichlet_model, (4, 6)),
}


@pytest.mark.parametrize("name", sorted(SUPPORT_MODELS))
def test_support_models_match_jax(name):
    jmodel, tmodel, (d, dc) = SUPPORT_MODELS[name]
    jm, tm = _both(jmodel, tmodel)
    _assert_same_layout(jm, tm)
    assert (tm.dim, tm.dim_constrained) == (d, dc)
    _assert_same_density(jm, tm, d, rtol=1e-5, atol=1e-5)
    th = _thetas(d, n=3, seed=5)
    jc = jax.vmap(jm.constrain)(jnp.asarray(th))
    tc = tm.constrain(torch.from_numpy(th))
    for site in jc:
        assert_allclose(tc[site].numpy(), np.asarray(jc[site]), rtol=1e-6, atol=1e-6)


def _adam_alg(n_samples, lr=1e-2):
    return avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=n_samples,
                                   optimizer=avt.adam(lr), operator=avt.ClipScale())


def test_simplex_latent_recovers_the_dirichlet_posterior():
    """Dirichlet prior, categorical counts: the posterior mean of the
    stick-broken site is the conjugate one (tests/test_ppl.py:150)."""
    tm = ppl.ingest(_dirichlet_model, device="cpu")
    q, _, _ = avt.optimize(0, _adam_alg(32), 2000, tm.target, tm.q_init())
    post = tm.sample_posterior(5, q, 50_000)
    p_mean = post["p"].double().mean(0).numpy()
    assert_allclose(p_mean, (ALPHA + COUNTS) / (ALPHA + COUNTS).sum(), atol=0.02)
    assert_allclose(post["p"].sum(-1).numpy(), 1.0, rtol=1e-5)


def test_batched_simplex_rows_recover_their_posteriors():
    tm = ppl.ingest(_batched_dirichlet_model, device="cpu")
    assert_allclose(tm.constrain(torch.zeros(4))["p"].sum(-1).numpy(), [1.0, 1.0], rtol=1e-5)
    q, _, _ = avt.optimize(0, _adam_alg(32), 2000, tm.target, tm.q_init())
    p_mean = tm.sample_posterior(5, q, 50_000)["p"].double().mean(0).numpy()
    exact = (ALPHA2 + COUNTS2) / (ALPHA2 + COUNTS2).sum(-1, keepdims=True)
    assert_allclose(p_mean, exact, atol=0.03)


def test_interval_and_positive_draws_respect_their_supports():
    tm = ppl.ingest(_interval_model, device="cpu")
    q, infos, _ = avt.optimize(0, _adam_alg(16), 1500, tm.target, tm.q_init(), log_every=100)
    post = tm.sample_posterior(5, q, 4000)
    assert float(post["rate"].min()) > 0.0
    assert float(post["w"].min()) > -1.0 and float(post["w"].max()) < 1.0
    assert math.isfinite(infos[-1]["elbo"])


def test_posterior_pushes_the_family_through_the_transform():
    tm = ppl.ingest(_interval_model, device="cpu")
    q = avt.MeanFieldGaussian(torch.tensor([0.3, -0.2]), torch.tensor([0.5, 0.4]))
    post = tm.posterior(q)
    z = post.sample(7, 10)
    assert_allclose(post.log_prob(z).numpy(),
                    (q.log_prob(tm.transform.inverse(z))
                     - tm.transform.forward_and_ldj(tm.transform.inverse(z))[1]).numpy(),
                    rtol=1e-6)


# ---------------------------------------------------------------------------
# ADVI on JAX's draws, and K5's plain version
# ---------------------------------------------------------------------------


def _jax_general(target, q0, steps=T, n_samples=N_SAMPLES):
    alg = javt.KLMinRepGradDescent(entropy=javt.STL, n_samples=n_samples,
                                   optimizer=optax.adam(1e-3), operator=javt.ClipScale())
    state = alg.init(jax.random.key(0), q0, target)
    step = jax.jit(alg.step)
    draws, infos = [], []
    for _ in range(steps):
        _, u = state.q.sample_with_base(jax.random.fold_in(state.key, state.iteration),
                                        n_samples)
        draws.append(np.asarray(u))
        state, info = step(state)
        infos.append(info)
    return state, np.stack(draws), infos


def _port_general(target, q0, draws):
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=draws.shape[1],
                                  optimizer=avt.adam(1e-3), operator=avt.ClipScale())
    state = alg.init(0, q0, target)
    infos = []
    for u in draws:
        state, info = alg.step(state, noise=torch.from_numpy(u))
        infos.append(info)
    return state, infos


@pytest.mark.parametrize("which", ["logreg", "flagship"])
def test_advi_steps_match_jax_with_injected_draws(which):
    data = _logreg_data() if which == "logreg" else _flagship_data()[0]
    jm, tm = _both(_jax_logreg_model, _logreg_model, data)
    js, draws, jinfos = _jax_general(jm.target, jm.q_init())
    ts, tinfos = _port_general(tm.target, tm.q_init(), draws)
    assert_allclose(ts.q.location.numpy(), np.asarray(js.q.location), **PARAM_TOL)
    assert_allclose(ts.q.scale_diag.numpy(), np.asarray(js.q.scale_diag), **PARAM_TOL)
    for ti, ji in zip(tinfos, jinfos):
        assert_allclose(float(ti["elbo"]), float(ji["elbo"]), rtol=1e-5, atol=1e-4)


def _ad_model_data():
    rng = np.random.default_rng(5)
    n, p = 48, 4
    return {"X": rng.normal(size=(n, p)).astype(np.float32),
            "y": (rng.random(n) < 0.5).astype(np.float32)}


def _jax_ad_model(data):
    sigma = jppl.sample("sigma", jppl.LogNormal(0.0, 1.0))
    beta = jppl.sample("beta", jppl.Normal(jnp.zeros(data["X"].shape[1]), sigma))
    jppl.sample("y", jppl.Bernoulli(logits=data["X"] @ beta), obs=data["y"])


def _ad_model(data):
    X = data["X"]
    sigma = ppl.sample("sigma", ppl.LogNormal(0.0, 1.0))
    beta = ppl.sample("beta", ppl.Normal(X.new_zeros(X.shape[1]), sigma))
    ppl.sample("y", ppl.Bernoulli(logits=X @ beta), obs=data["y"])


def test_ingested_model_runs_fused_through_k5():
    """tests/test_fused_ad_spec.py:125 on the port: fused_spec_for falls back
    to ad_spec, and the engine (K5's plain version here) lands on JAX's
    ad-spec engine in interpret mode and on JAX's general path, on the same
    draws, within rtol 1e-5."""
    jm, tm = _both(_jax_ad_model, _ad_model, _ad_model_data())
    d = tm.dim
    jstate, draws, infos = _jax_general(jm.target, jm.q_init())
    spec = avt.fused_spec_for(tm.target)
    assert spec.model == "ad" and spec.dim == d
    eng = FusedADVI(spec, n_samples=N_SAMPLES, lr=1e-3)
    ts = eng.run_chunk(eng.init(torch.zeros(d), 0.1 * torch.ones(d)), 1, T,
                       noise=torch.from_numpy(draws))
    jeng = jfused.FusedADVI(javt.fused_spec_for(jm.target), n_samples=N_SAMPLES, lr=1e-3,
                            interpret=True)
    jst = jeng.run_chunk(jeng.init(jnp.zeros(d), 0.1 * jnp.ones(d)), jax.random.key(1), steps=T,
                         noise=jnp.asarray(convert.pack_noise(draws, d_pad=jeng.d_pad)))
    js = convert.fused_state_from_numpy(jst, d, device="cpu")
    assert_allclose(ts.mu.numpy(), js.mu.numpy(), **PARAM_TOL)
    assert_allclose(ts.sig.numpy(), js.sig.numpy(), **PARAM_TOL)
    assert_allclose(ts.mu.numpy(), np.asarray(jstate.q.location), **PARAM_TOL)
    assert_allclose(ts.sig.numpy(), np.asarray(jstate.q.scale_diag), **PARAM_TOL)
    assert_allclose(float(ts.elbo), float(infos[-1]["elbo"]), rtol=1e-4, atol=1e-4)


def test_k5_replay_of_the_flagship_is_autograd():
    """At the flagship's width the traced graph (the body's plain version)
    gives eager autograd's values and gradients on the ingested target."""
    data, _ = _flagship_data()
    tm = ppl.ingest(_logreg_model, data=data, device="cpu")
    prog = ad_body.ADModel(tm.target.log_density, 62, "cpu").program(10)
    z = torch.from_numpy(_thetas(62, n=10, seed=8, scale=0.3))
    lp, g = ad_body.replay(prog.gm, z)
    zz = z.clone().requires_grad_(True)
    v = tm.target.log_density(zz)
    (g2,) = torch.autograd.grad(v.sum(), zz)
    assert_allclose(lp.numpy(), v.detach().numpy(), rtol=1e-6)
    assert_allclose(g.numpy(), g2.numpy(), rtol=1e-5, atol=1e-5)


# which distributions' ingested graphs K5 takes, and the op that refuses the others
K5_LATENT = {
    "Normal": (lambda data: ppl.Normal(0.5, 2.0), None),
    "LogNormal": (lambda data: ppl.LogNormal(0.0, 1.0), None),
    "HalfNormal": (lambda data: ppl.HalfNormal(1.5), None),
    "HalfCauchy": (lambda data: ppl.HalfCauchy(1.0), None),
    "Exponential": (lambda data: ppl.Exponential(2.0), None),
    "Gamma": (lambda data: ppl.Gamma(2.0, 1.5), None),
    "Gamma_tensor": (lambda data: ppl.Gamma(data["a"][0], 1.5), "lgamma"),
    "Beta": (lambda data: ppl.Beta(2.0, 3.0), "sigmoid"),
    "Uniform": (lambda data: ppl.Uniform(-1.0, 2.0), "sigmoid"),
    "StudentT": (lambda data: ppl.StudentT(4.0, 0.0, 1.0), None),
    "Laplace": (lambda data: ppl.Laplace(0.0, 1.0), None),
    "Dirichlet": (lambda data: ppl.Dirichlet(torch.tensor([2.0, 1.0, 3.0])), "arange"),
}
K5_OBSERVED = {"Bernoulli": None, "Poisson": "lgamma", "Categorical": "_log_softmax"}
K5_DATA = {"y": torch.tensor([0.3, 1.2, 0.7]), "x": torch.tensor([0.5, -1.0, 2.0]),
           "n": torch.tensor([1.0, 0.0, 3.0]), "b": torch.tensor([1.0, 0.0, 1.0]),
           "L": torch.tensor([0.1, 0.5, -0.3]), "c": torch.tensor([0, 2, 1]),
           "a": torch.tensor([2.0, 2.0, 2.0])}


def _latent_model(make):
    def model(data):
        z = ppl.sample("z", make(data))
        with ppl.plate("obs", 3):
            ppl.sample("y", ppl.Normal(z if z.dim() == 0 else z[0], 1.0), obs=data["y"])
    return model


def _observed_model(kind):
    def model(data):
        z = ppl.sample("z", ppl.Normal(0.0, 1.0))
        with ppl.plate("obs", 3):
            if kind == "Bernoulli":
                ppl.sample("y", ppl.Bernoulli(logits=z * data["x"]), obs=data["b"])
            elif kind == "Poisson":
                ppl.sample("y", ppl.Poisson(torch.exp(z * data["x"])), obs=data["n"])
            else:
                ppl.sample("y", ppl.Categorical(logits=z * data["L"]), obs=data["c"])
    return model


K5_TABLE = {**{k: (_latent_model(make), op) for k, (make, op) in K5_LATENT.items()},
            **{k: (_observed_model(k), op) for k, op in K5_OBSERVED.items()}}


@pytest.mark.parametrize("name", sorted(K5_TABLE))
def test_k5_takes_or_refuses_each_distribution(name):
    """The table of ROADMAP (K5's op set): an ingested site of each
    distribution (discrete ones observed) passes ``ad_body.check_graph``, or
    the ValueError names the op K5 lacks."""
    model, op = K5_TABLE[name]
    tm = ppl.ingest(model, data=K5_DATA, device="cpu")
    if op is None:
        gm = ad_body.trace(tm.target.log_density, 4, tm.dim, "cpu")
        ad_body.check_graph(gm, 4, tm.dim)
        assert avt.fused_spec_for(tm.target).model == "ad"
    else:
        with pytest.raises(ValueError, match=f"op {op}"):
            avt.fused_spec_for(tm.target)


# ---------------------------------------------------------------------------
# Errors and the prior
# ---------------------------------------------------------------------------


def _messages(pkg_ppl, xp, fn):
    try:
        fn(pkg_ppl, xp)
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    raise AssertionError("no error")


def _discrete(p, xp):
    p.ingest(lambda: p.sample("z", p.Bernoulli(logits=0.0)))


def _duplicate(p, xp):
    def dup():
        p.sample("a", p.Normal(0.0, 1.0))
        p.sample("a", p.Normal(0.0, 1.0))
    p.ingest(dup)


def _no_latent(p, xp):
    p.ingest(lambda: p.sample("y", p.Normal(0.0, 1.0), obs=xp.ones(())))


def _simplex_local(p, xp):
    def model(data):
        with p.plate("obs", 4):
            q = p.sample("p", p.Dirichlet(xp.ones(3)))
            p.sample("y", p.Normal(q[..., 0], 1.0), obs=data["y"])
    p.ingest(model, data={"y": xp.zeros(4)})


def _nested(p, xp):
    def model(data):
        with p.plate("outer", 4):
            with p.plate("inner", 4):
                z = p.sample("z", p.Normal(0.0, 1.0))
            p.sample("y", p.Normal(z, 1.0), obs=data["y"])
    p.ingest(model, data={"y": xp.zeros(4)})


def _outside(p, xp):
    p.sample("x", p.Normal(0.0, 1.0))


ERRORS = {"discrete": _discrete, "duplicate": _duplicate, "no_latent": _no_latent,
          "simplex_local": _simplex_local, "nested": _nested, "outside": _outside}


class _PortOnCPU:
    """The port's ppl, its ingest on the CPU."""

    def __getattr__(self, name):
        if name == "ingest":
            return functools.partial(ppl.ingest, device="cpu")
        return getattr(ppl, name)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_error_paths_match_jax_word_for_word(name):
    assert _messages(_PortOnCPU(), torch, ERRORS[name]) == _messages(jppl, jnp, ERRORS[name])


def test_prior_predictive_shapes():
    data = _logreg_data()
    draws = ppl.prior_predictive(_logreg_model, 0, data=data, device="cpu")
    jdraws = jppl.prior_predictive(_jax_logreg_model, jax.random.key(0),
                                   data={k: jnp.asarray(v) for k, v in data.items()})
    assert set(draws) == set(jdraws) == {"sigma", "beta"}
    for k in draws:
        assert tuple(draws[k].shape) == tuple(jdraws[k].shape)
    assert draws["beta"].shape == (5,) and float(draws["sigma"]) > 0.0
    again = ppl.prior_predictive(_logreg_model, torch.Generator().manual_seed(0), data=data,
                                 device="cpu")
    assert torch.equal(again["beta"], draws["beta"])


def test_sample_posterior_and_constrain_shapes():
    tm = ppl.ingest(_logreg_model, data=_logreg_data(), device="cpu")
    q = tm.q_init()
    post = tm.sample_posterior(1, q, 11)
    assert post["beta"].shape == (11, 5) and post["sigma"].shape == (11,)
    assert bool((post["sigma"] > 0).all())
    one = tm.constrain(torch.zeros(6))
    assert one["beta"].shape == (5,) and one["sigma"].shape == ()
    assert_allclose(float(one["sigma"]), math.log(2.0), rtol=1e-6)  # softplus(0)
