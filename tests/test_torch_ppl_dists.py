"""Port parity of the DSL's distributions (advancedvi_jl_tpu_torch.ppl.dists)
against the JAX package's (float32, the same inputs through both) and
against scipy's log densities (the port in float64), after
tests/test_ppl_dists.py; then each distribution's draws from a torch
generator against the law's own mean and variance, and scored finite by its
own log_prob."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import scipy.stats as st
import torch
from numpy.testing import assert_allclose

from advancedvi_jl_tpu.ppl import dists as J
from advancedvi_jl_tpu_torch.ppl import dists as T

torch.set_num_threads(1)

RTOL = 1e-5
ALPHA = np.array([[2.0, 1.0, 3.0], [0.7, 1.5, 4.0]])
LOGITS = np.array([0.3, -1.2, 2.0, 0.0])


def _simplex():
    x = np.array([[0.2, 0.5, 0.3], [0.6, 0.1, 0.3]])
    return x


def _cat_logp(y):
    return LOGITS[y] - sp.logsumexp(LOGITS)


# name, (JAX dist, port dist) from parameters, x, scipy's log density at x
CASES = {
    "Normal": (lambda m, p: m.Normal(0.7, 2.3), np.array([-5.0, -0.1, 0.0, 0.7, 3.14, 40.0]),
               lambda x: st.norm.logpdf(x, 0.7, 2.3)),
    "Normal_vec": (lambda m, p: m.Normal(p(np.array([0.0, 1.0, -2.0])), 0.5),
                   np.array([0.1, 0.2, 0.3]),
                   lambda x: st.norm.logpdf(x, np.array([0.0, 1.0, -2.0]), 0.5)),
    "LogNormal": (lambda m, p: m.LogNormal(-0.3, 0.8), np.array([1e-4, 0.5, 1.0, 2.7, 50.0]),
                  lambda x: st.lognorm.logpdf(x, s=0.8, scale=np.exp(-0.3))),
    "HalfNormal": (lambda m, p: m.HalfNormal(1.7), np.array([1e-6, 0.3, 1.0, 4.0]),
                   lambda x: st.halfnorm.logpdf(x, scale=1.7)),
    "HalfCauchy": (lambda m, p: m.HalfCauchy(0.6), np.array([1e-6, 0.3, 1.0, 25.0]),
                   lambda x: st.halfcauchy.logpdf(x, scale=0.6)),
    "Exponential": (lambda m, p: m.Exponential(2.5), np.array([0.0, 0.1, 1.0, 5.0]),
                    lambda x: st.expon.logpdf(x, scale=1 / 2.5)),
    "Gamma": (lambda m, p: m.Gamma(3.2, 1.7), np.array([1e-3, 0.5, 1.88, 12.0]),
              lambda x: st.gamma.logpdf(x, a=3.2, scale=1 / 1.7)),
    "Gamma_tensor": (lambda m, p: m.Gamma(p(np.array([3.2, 0.8])), p(np.array([1.7, 2.0]))),
                     np.array([0.5, 1.88]),
                     lambda x: st.gamma.logpdf(x, a=np.array([3.2, 0.8]),
                                               scale=1 / np.array([1.7, 2.0]))),
    "Beta": (lambda m, p: m.Beta(2.5, 0.7), np.array([1e-4, 0.3, 0.5, 0.999]),
             lambda x: st.beta.logpdf(x, 2.5, 0.7)),
    "Uniform": (lambda m, p: m.Uniform(-1.0, 3.0), np.array([-0.9, 0.0, 2.9]),
                lambda x: st.uniform.logpdf(x, -1.0, 4.0)),
    "StudentT": (lambda m, p: m.StudentT(4.0, 0.5, 1.5), np.array([-30.0, -1.0, 0.5, 7.0]),
                 lambda x: st.t.logpdf(x, 4.0, 0.5, 1.5)),
    "Laplace": (lambda m, p: m.Laplace(-0.2, 0.9), np.array([-4.0, -0.2, 0.0, 3.0]),
                lambda x: st.laplace.logpdf(x, -0.2, 0.9)),
    "Dirichlet": (lambda m, p: m.Dirichlet(p(ALPHA)), _simplex(),
                  lambda x: np.array([st.dirichlet.logpdf(r, a) for r, a in zip(x, ALPHA)])),
    "Bernoulli": (lambda m, p: m.Bernoulli(logits=p(np.array([-2.0, 0.0, 0.5, 3.0]))),
                  np.array([0.0, 1.0, 1.0, 0.0]),
                  lambda y: st.bernoulli.logpmf(y, sp.expit(np.array([-2.0, 0.0, 0.5, 3.0])))),
    "Poisson": (lambda m, p: m.Poisson(3.5), np.array([0.0, 1.0, 4.0, 11.0]),
                lambda y: st.poisson.logpmf(y, 3.5)),
    "Categorical": (lambda m, p: m.Categorical(logits=p(LOGITS)), np.array([0, 3, 2, 2, 1]),
                    _cat_logp),
}
NAMES = sorted(CASES)


def test_every_distribution_is_covered():
    ported = {n for n in dir(T) if isinstance(getattr(T, n), type) and hasattr(getattr(T, n),
                                                                                 "log_prob")}
    assert ported == {n.split("_")[0] for n in NAMES} and len(ported) == 14
    for n in ported:
        assert getattr(T, n)().support == getattr(J, n)().support, n


@pytest.mark.parametrize("name", NAMES)
def test_log_prob_matches_jax(name):
    make, x, _ = CASES[name]
    f32 = np.float32 if name != "Categorical" else np.int32
    jd = make(J, lambda a: jnp.asarray(a, jnp.float32))
    td = make(T, lambda a: torch.tensor(a, dtype=torch.float32))
    want = np.asarray(jd.log_prob(jnp.asarray(x.astype(f32))))
    got = td.log_prob(torch.from_numpy(x.astype(f32))).numpy()
    assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_log_prob_matches_scipy(name):
    make, x, ref = CASES[name]
    td = make(T, lambda a: torch.tensor(a, dtype=torch.float64))
    xt = torch.from_numpy(x) if name != "Categorical" else torch.from_numpy(x).long()
    assert_allclose(td.log_prob(xt).numpy(), ref(x), rtol=RTOL, atol=1e-12)


# name: the port's distribution, the law's mean and variance (elementwise)
MOMENTS = {
    "Normal": (T.Normal(0.7, 2.3), 0.7, 2.3 ** 2),
    "LogNormal": (T.LogNormal(-0.3, 0.5), math.exp(-0.3 + 0.125),
                  (math.exp(0.25) - 1) * math.exp(-0.6 + 0.25)),
    "HalfNormal": (T.HalfNormal(1.7), 1.7 * math.sqrt(2 / math.pi), 1.7 ** 2 * (1 - 2 / math.pi)),
    "Exponential": (T.Exponential(2.5), 0.4, 0.16),
    "Gamma": (T.Gamma(3.2, 1.7), 3.2 / 1.7, 3.2 / 1.7 ** 2),
    "Beta": (T.Beta(2.5, 0.7), 2.5 / 3.2, 2.5 * 0.7 / (3.2 ** 2 * 4.2)),
    "Uniform": (T.Uniform(-1.0, 3.0), 1.0, 16 / 12),
    "StudentT": (T.StudentT(5.0, 0.5, 1.5), 0.5, 1.5 ** 2 * 5 / 3),
    "Laplace": (T.Laplace(-0.2, 0.9), -0.2, 2 * 0.9 ** 2),
    "Bernoulli": (T.Bernoulli(0.4), float(sp.expit(0.4)),
                  float(sp.expit(0.4) * (1 - sp.expit(0.4)))),
    "Poisson": (T.Poisson(3.5), 3.5, 3.5),
}
DRAWS = 200_000


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_draws_have_the_laws_moments_and_score_finite(name):
    """The mean within 5 standard errors and the variance within 5% (the
    Student-t's within 10%: its fourth moment is large), from a seeded
    torch generator; the same generator state gives the same draws."""
    dist, mean, var = MOMENTS[name]
    x = dist.sample(torch.Generator().manual_seed(3), (DRAWS,)).double()
    assert x.shape == (DRAWS,)
    assert abs(float(x.mean()) - mean) < 5 * math.sqrt(var / DRAWS), float(x.mean())
    assert abs(float(x.var()) / var - 1.0) < (0.1 if name == "StudentT" else 0.05)
    assert bool(torch.isfinite(dist.log_prob(x[:1000])).all())
    again = dist.sample(torch.Generator().manual_seed(3), (DRAWS,)).double()
    assert torch.equal(x, again)


def test_halfcauchy_draws_median():
    x = T.HalfCauchy(0.6).sample(torch.Generator().manual_seed(4), (DRAWS,))
    assert bool((x > 0).all()) and abs(float(x.median()) - 0.6) < 0.01


def test_dirichlet_and_categorical_draws():
    a = torch.tensor(ALPHA, dtype=torch.float32)
    g = torch.Generator().manual_seed(5)
    p = torch.stack([T.Dirichlet(a).sample(g) for _ in range(20_000)]).double()
    assert p.shape == (20_000, 2, 3)
    assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert_allclose(p.mean(0).numpy(), ALPHA / ALPHA.sum(-1, keepdims=True), atol=0.01)
    assert bool(torch.isfinite(T.Dirichlet(a).log_prob(p[:100].float())).all())
    logits = torch.tensor(LOGITS, dtype=torch.float32)
    c = torch.stack([T.Categorical(logits).sample(g) for _ in range(20_000)])
    freq = np.bincount(c.numpy(), minlength=4) / 20_000
    assert_allclose(freq, sp.softmax(LOGITS), atol=0.015)


def test_sample_shapes_broadcast_the_parameters():
    g = torch.Generator().manual_seed(6)
    assert T.Normal(torch.zeros(3), 1.0).sample(g).shape == (3,)
    assert T.Gamma(2.0, torch.ones(2, 4)).sample(g).shape == (2, 4)
    assert T.StudentT(5.0).sample(g).shape == ()
    assert T.Poisson(torch.ones(5)).sample(g).shape == (5,)
