"""Port parity of ingested local latents (advancedvi_jl_tpu_torch.ppl in
local-latent mode) after tests/test_ppl_local.py: the random-effects model
written in each package's ops, the same numpy data through both; the layout,
the log density full batch and subsampled, the ELBO and its gradient on
JAX's injected draws, and the port's doubly-stochastic fit against the
exact Gaussian posterior."""

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
from advancedvi_jl_tpu_torch import ppl

torch.set_num_threads(1)

N = 48
S0, SZ, SY = 2.0, 1.0, 0.5  # prior sd of mu, z | mu, y | z


def _data(seed=0):
    rng = np.random.default_rng(seed)
    mu = S0 * rng.standard_normal()
    z = mu + SZ * rng.standard_normal(N)
    return {"y": (z + SY * rng.standard_normal(N)).astype(np.float32)}


def _jax_model(data):
    mu = jppl.sample("mu", jppl.Normal(0.0, S0))
    with jppl.plate("obs", N):
        z = jppl.sample("z", jppl.Normal(mu, SZ))
        jppl.sample("y", jppl.Normal(z, SY), obs=data["y"])


def _model(data):
    mu = ppl.sample("mu", ppl.Normal(0.0, S0))
    with ppl.plate("obs", N):
        z = ppl.sample("z", ppl.Normal(mu, SZ))
        ppl.sample("y", ppl.Normal(z, SY), obs=data["y"])


def _both(jmodel=_jax_model, tmodel=_model, data=None):
    data = _data() if data is None else data
    return (jppl.ingest(jmodel, data={k: jnp.asarray(v) for k, v in data.items()}),
            ppl.ingest(tmodel, data=data, device="cpu"))


def _exact_posterior(y):
    """Means and precision diagonal of the Gaussian posterior of (mu, z)."""
    d = N + 1
    lam = np.zeros((d, d))
    lam[0, 0] = 1 / S0 ** 2 + N / SZ ** 2
    for i in range(N):
        lam[1 + i, 1 + i] = 1 / SZ ** 2 + 1 / SY ** 2
        lam[0, 1 + i] = lam[1 + i, 0] = -1 / SZ ** 2
    b = np.concatenate([[0.0], np.asarray(y, np.float64) / SY ** 2])
    return np.linalg.solve(lam, b), np.diag(lam)


def test_ingest_assembles_the_global_local_family_as_jax():
    jm, tm = _both()
    assert tm.local_names == jm.local_names == ["z"]
    assert tm.global_names == jm.global_names == ["mu"]
    assert (tm.dim, tm.dim_constrained, tm.local_k) == (jm.dim, jm.dim_constrained, 1)
    assert tm.dim == 1 + N
    q = tm.q_init()
    assert isinstance(q, avt.GlobalLocalFamily)
    assert q.global_q.dim == 1 and q.local_q.location.shape == (N, 1)
    idx = torch.arange(8)
    assert tm.target.subsample(idx).dim == jm.target.subsample(jnp.arange(8)).dim == 1 + 8
    assert q.subsample(idx).dim == 1 + 8 and q.subsample(idx).weight == N / 8


def test_full_batch_density_matches_jax_and_the_hand_rolled_joint():
    jm, tm = _both()
    th = np.random.default_rng(1).standard_normal((3, 1 + N)).astype(np.float32)
    got = tm.target.log_density(torch.from_numpy(th))
    assert_allclose(got.numpy(), np.asarray(jax.vmap(jm.target.log_density)(jnp.asarray(th))),
                    rtol=1e-6)
    y = _data()["y"].astype(np.float64)

    def norm_lp(x, loc, sd):
        return -0.5 * ((x - loc) / sd) ** 2 - 0.5 * np.log(2 * np.pi * sd ** 2)

    t = th.astype(np.float64)
    want = (norm_lp(t[:, 0], 0.0, S0) + norm_lp(t[:, 1:], t[:, :1], SZ).sum(-1)
            + norm_lp(y, t[:, 1:], SY).sum(-1))
    assert_allclose(got.numpy(), want, rtol=1e-5)


def test_subsampled_density_matches_jax():
    """The batch's rows and their local latents, the per-datapoint terms
    rescaled by N / B."""
    jm, tm = _both()
    idx = np.array([5, 0, 17, 33, 40, 2])
    jsub, tsub = jm.target.subsample(jnp.asarray(idx)), tm.target.subsample(torch.from_numpy(idx))
    th = np.random.default_rng(2).standard_normal((4, 1 + len(idx))).astype(np.float32)
    assert_allclose(tsub.log_density(torch.from_numpy(th)).numpy(),
                    np.asarray(jax.vmap(jsub.log_density)(jnp.asarray(th))), rtol=1e-6)
    assert float(tsub.likeadj) == N / len(idx)


def _jax_u(jq, key, n):
    kg, kl = jax.random.split(key)
    return np.concatenate([np.array(jax.random.normal(kg, (n, jq.global_q.dim))),
                           np.array(jax.random.normal(kl, (n, jq.local_q.dim)))], axis=1)


@pytest.mark.parametrize("entropy", ["stl", "closed_form"])
@pytest.mark.parametrize("batch", [None, 12])
def test_elbo_and_gradient_match_jax_on_injected_draws(entropy, batch):
    """RepGradELBO on the ingested target and its q_init (full batch, and a
    batch of 12 rows with the family subsampled in lockstep), JAX's draws."""
    jm, tm = _both()
    jq, tq = jm.q_init(), tm.q_init()
    jt, tt = jm.target, tm.target
    if batch is not None:
        idx = np.arange(3, 3 + batch)
        jq, jt = jq.subsample(jnp.asarray(idx)), jt.subsample(jnp.asarray(idx))
        tq, tt = tq.subsample(torch.from_numpy(idx)), tt.subsample(torch.from_numpy(idx))
    key = jax.random.key(7)
    jobj = javt.RepGradELBO(n_samples=16, entropy=entropy)
    jg, _, jinfo = jobj.value_and_grad(jq, jt, key, ())
    tobj = avt.RepGradELBO(n_samples=16, entropy=entropy)
    tg, _, tinfo = tobj.value_and_grad(tq, tt, 0, (),
                                       noise=torch.from_numpy(_jax_u(jq, key, 16)))
    assert_allclose(float(tinfo["elbo"]), float(jinfo["elbo"]), rtol=1e-5)
    for name in ("location", "scale_diag"):
        assert_allclose(getattr(tg.global_q, name).numpy(),
                        np.asarray(getattr(jg.global_q, name)), rtol=1e-5, atol=1e-5)
        assert_allclose(getattr(tg.local_q, name).numpy(),
                        np.asarray(getattr(jg.local_q, name)), rtol=1e-5, atol=1e-5)


def test_doubly_stochastic_fit_matches_the_exact_posterior():
    """tests/test_ppl_local.py:118 on the port: B = 12, 16 draws, Adam(2e-2),
    6,000 steps; means within 0.08, sds within rtol 0.2 of 1/sqrt(Lambda_ii)."""
    data = _data()
    tm = ppl.ingest(_model, data=data, device="cpu")
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=16, optimizer=avt.adam(2e-2),
                                  operator=avt.ClipScale(),
                                  subsampling=avt.ReshufflingBatchSubsampling(N, 12))
    q, infos, _ = avt.optimize(0, alg, 6000, tm.target, tm.q_init(), log_every=500)
    assert np.isfinite(infos[-1]["elbo"])
    mean, prec = _exact_posterior(data["y"])
    got_mean = torch.cat([q.global_q.location, q.local_q.location[:, 0]]).numpy()
    got_sd = torch.cat([q.global_q.scale_diag, q.local_q.scale_diag[:, 0]]).numpy()
    assert_allclose(got_mean, mean, atol=0.08)
    assert_allclose(got_sd, prec ** -0.5, rtol=0.2)


def _jax_gamma_model(data):
    rate = jppl.sample("rate", jppl.LogNormal(0.0, 1.0))
    with jppl.plate("obs", 24):
        lam = jppl.sample("lam", jppl.Gamma(2.0, rate))
        jppl.sample("y", jppl.Exponential(lam), obs=data["y"])


def _gamma_model(data):
    rate = ppl.sample("rate", ppl.LogNormal(0.0, 1.0))
    with ppl.plate("obs", 24):
        lam = ppl.sample("lam", ppl.Gamma(2.0, rate))
        ppl.sample("y", ppl.Exponential(lam), obs=data["y"])


def test_constrained_local_latents_match_jax_and_respect_the_support():
    """Positive local sites transform a plate row at a time; the per-row
    Jacobians ride the rescaled sum (tests/test_ppl_local.py:145)."""
    y = np.abs(1.0 + 0.5 * np.random.default_rng(1).standard_normal(24)).astype(np.float32)
    jm, tm = _both(_jax_gamma_model, _gamma_model, {"y": y})
    assert tm.local_names == ["lam"]
    th = np.random.default_rng(3).standard_normal((3, tm.dim)).astype(np.float32)
    assert_allclose(tm.target.log_density(torch.from_numpy(th)).numpy(),
                    np.asarray(jax.vmap(jm.target.log_density)(jnp.asarray(th))), rtol=1e-5)
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=8, optimizer=avt.adam(1e-2),
                                  operator=avt.ClipScale(),
                                  subsampling=avt.ReshufflingBatchSubsampling(24, 8))
    q, infos, _ = avt.optimize(0, alg, 500, tm.target, tm.q_init(), log_every=100)
    assert np.isfinite(infos[-1]["elbo"])
    post = tm.sample_posterior(2, q, 64)
    assert post["lam"].shape == (64, 24) and bool((post["lam"] > 0).all())
    assert post["rate"].shape == (64,) and bool((post["rate"] > 0).all())
    jc = jax.vmap(jm.constrain)(jnp.asarray(th))
    tc = tm.constrain(torch.from_numpy(th))
    for site in jc:
        assert_allclose(tc[site].numpy(), np.asarray(jc[site]), rtol=1e-6)


def test_vector_local_latents_keep_the_row_major_layout():
    n, k = 10, 3
    y = np.random.default_rng(3).standard_normal(n).astype(np.float32)

    def model(data):
        with ppl.plate("obs", n):
            z = ppl.sample("z", ppl.Normal(data["y"].new_zeros(k), 1.0))
            ppl.sample("y", ppl.Normal(torch.sum(z, dim=-1), 1.0), obs=data["y"])

    def jmodel(data):
        with jppl.plate("obs", n):
            z = jppl.sample("z", jppl.Normal(jnp.zeros(k), 1.0))
            jppl.sample("y", jppl.Normal(jnp.sum(z, axis=-1), 1.0), obs=data["y"])

    jm, tm = _both(jmodel, model, {"y": y})
    assert tm.local_k == jm.local_k == k and tm.dim == jm.dim == n * k
    th = np.random.default_rng(4).standard_normal((2, n * k)).astype(np.float32)
    assert_allclose(tm.target.log_density(torch.from_numpy(th)).numpy(),
                    np.asarray(jax.vmap(jm.target.log_density)(jnp.asarray(th))), rtol=1e-6)
    q = tm.q_init()
    assert q.local_q.location.shape == (n, k)
    alg = avt.KLMinRepGradDescent(entropy=avt.CLOSED_FORM, n_samples=4, optimizer=avt.adam(1e-2),
                                  operator=avt.ClipScale(),
                                  subsampling=avt.ReshufflingBatchSubsampling(n, 5))
    q1, infos, _ = avt.optimize(0, alg, 20, tm.target, q)
    assert np.isfinite(infos[-1]["elbo"])
    assert tm.sample_posterior(4, q1, 7)["z"].shape == (7, n, k)


def _messages(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no error")


def test_local_mode_errors_match_jax_word_for_word():
    def mismatched(p, xp):
        def model(data):
            with p.plate("obs", N + 1):
                z = p.sample("z", p.Normal(0.0, 1.0))
                p.sample("y", p.Normal(z[:N], 1.0), obs=data["y"])
        return model

    jdata, tdata = {"y": jnp.asarray(_data()["y"])}, _data()
    assert _messages(lambda: ppl.ingest(mismatched(ppl, torch), data=tdata, device="cpu")) == \
        _messages(lambda: jppl.ingest(mismatched(jppl, jnp), data=jdata))
    jm, tm = _both()
    assert _messages(lambda: tm.posterior(tm.q_init())) == \
        _messages(lambda: jm.posterior(jm.q_init()))


def test_weighted_family_is_refused_by_vargrad():
    """A subsampled GlobalLocalFamily carries the N/B weight; VarGrad
    refuses it (tests/test_ppl_local.py:245)."""
    _, tm = _both()
    q_sub = tm.q_init().subsample(torch.arange(8))
    assert q_sub.weight == N / 8
    with pytest.raises(ValueError, match="RepGradELBO"):
        avt.ScoreGradELBO(n_samples=4).loss_and_elbo(q_sub, tm.target.subsample(torch.arange(8)),
                                                     0)
