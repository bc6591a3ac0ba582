"""Port parity: the Student-t and Laplace bases (families/base.py), the base
draws the sampler kernels do not take (ops/base_draws.py) and the families'
``sampler=`` routes, against the JAX package and scipy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.families import base as jbase
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.families.location_scale import (
    FullRankLocationScale,
    MeanFieldLocationScale,
)
from advancedvi_jl_tpu_torch.families.low_rank import LowRankLocationScale
from advancedvi_jl_tpu_torch.ops import base_draws
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    PhiloxKey,
    fullrank_sample_reference,
    lowrank_sample_reference,
    meanfield_sample_reference,
    philox4x32_reference,
    philox4x32_words,
    seed_words,
)

torch.set_num_threads(1)

BASES = {
    "normal": (avt.Normal(), jbase.Normal()),
    "student_t3": (avt.StudentT(3.0), jbase.StudentT(df=3.0)),
    "student_t5": (avt.StudentT(5.0), jbase.StudentT(df=5.0)),
    "student_t7": (avt.StudentT(7.0), jbase.StudentT(df=7.0)),
    "laplace": (avt.Laplace(), jbase.Laplace()),
}
KS_DRAWS = 20_000
KEY = PhiloxKey(seed_words(9), 4)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(BASES))
def test_base_matches_jax(name, dtype):
    """log_prob, score, entropy, mean, var and symmetric() equal JAX's
    (rtol 1e-6 in float64, 1e-5 in float32; Laplace's score exactly)."""
    tb, jb = BASES[name]
    rtol = 1e-6 if dtype == "float64" else 1e-5
    u = np.random.default_rng(3).standard_normal(257).astype(dtype) * 3.0
    u[:3] = (0.0, 1e-30, -1e-30)
    with jax.enable_x64(dtype == "float64"):
        want_lp = np.asarray(jb.log_prob(jnp.asarray(u)))
        want_sc = np.asarray(jb.score(jnp.asarray(u)))
    got_lp = tb.log_prob(torch.from_numpy(u))
    got_sc = tb.score(torch.from_numpy(u))
    assert got_lp.dtype == got_sc.dtype == getattr(torch, dtype)
    assert_allclose(got_lp.numpy(), want_lp, rtol=rtol, atol=0)
    assert_allclose(got_sc.numpy(), want_sc, rtol=rtol, atol=0)
    if name == "laplace":
        assert np.array_equal(got_sc.numpy(), want_sc)
    assert_allclose(tb.entropy(), jb.entropy(), rtol=1e-12)
    assert (tb.mean(), tb.var(), tb.symmetric()) == (jb.mean(), jb.var(), jb.symmetric())


@pytest.mark.parametrize("name,dist", [
    ("student_t3", scipy.stats.t(3.0)), ("student_t5", scipy.stats.t(5.0)),
    ("student_t7", scipy.stats.t(7.0)), ("laplace", scipy.stats.laplace()),
    ("normal", scipy.stats.norm()),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_base_draws_follow_their_law(name, dist, dtype):
    """20,000 draws: Kolmogorov-Smirnov against scipy (p > 1e-3), and the
    dtype asked for."""
    u = base_draws.draw(BASES[name][0], KEY, KS_DRAWS // 4, 4, dtype, "cpu")
    assert u.shape == (KS_DRAWS // 4, 4) and u.dtype == dtype
    assert bool(torch.isfinite(u).all())
    assert scipy.stats.kstest(u.double().numpy().ravel(), dist.cdf).pvalue > 1e-3


@pytest.mark.parametrize("name", ["student_t5", "laplace", "normal"])
def test_base_draws_are_a_function_of_key_and_iteration(name):
    """The same (seed, it) gives the same bits; another it or seed others."""
    b = BASES[name][0]
    a = base_draws.draw(b, KEY, 64, 7, torch.float64, "cpu")
    assert torch.equal(a, base_draws.draw(b, KEY, 64, 7, torch.float64, "cpu"))
    assert not torch.equal(a, base_draws.draw(b, PhiloxKey(KEY.seed, KEY.it + 1), 64, 7,
                                              torch.float64, "cpu"))
    assert not torch.equal(a, base_draws.draw(b, PhiloxKey(seed_words(10), KEY.it), 64, 7,
                                              torch.float64, "cpu"))
    # a seed read as iteration 0
    assert torch.equal(base_draws.draw(b, 9, 5, 3, torch.float32, "cpu"),
                       base_draws.draw(b, PhiloxKey(seed_words(9), 0), 5, 3, torch.float32,
                                       "cpu"))


def test_scalar_philox_is_the_reference():
    """``philox4x32_words`` (Python ints, the per-step seeds) gives the words
    of ``philox4x32_reference`` (tensors) at any counter and key."""
    rng = np.random.default_rng(0)
    for _ in range(64):
        c = [int(x) for x in rng.integers(0, 2**32, 4)]
        k = [int(x) for x in rng.integers(0, 2**32, 2)]
        assert philox4x32_words(c, k) == tuple(int(w) for w in philox4x32_reference(c, k))


def test_generator_reads_the_words_as_one_seed():
    g = base_draws.generator((1, 2), "cpu")
    assert g.initial_seed() == (1 << 32) | 2
    assert base_draws.generator((2**32 - 1, 2**32 - 1), "cpu").initial_seed() == 2**64 - 1
    with pytest.raises(TypeError, match="no base draw"):
        base_draws.draw(object(), KEY, 2, 2, torch.float32, "cpu")


def _families(base, dtype, d=6, r=2):
    rng = np.random.default_rng(5)
    loc = torch.from_numpy(rng.standard_normal(d)).to(dtype)
    diag = torch.from_numpy(0.5 + rng.random(d)).to(dtype)
    C = torch.tril(torch.from_numpy(0.2 * rng.standard_normal((d, d)))).to(dtype) + torch.diag(diag)
    U = torch.from_numpy(0.3 * rng.standard_normal((d, r))).to(dtype)
    return {"meanfield": MeanFieldLocationScale(loc, diag, base=base),
            "fullrank": FullRankLocationScale(loc, C, base=base),
            "lowrank": LowRankLocationScale(loc, diag, U, base=base)}


@pytest.mark.parametrize("family", ["meanfield", "fullrank", "lowrank"])
@pytest.mark.parametrize("case", ["float64_normal", "student_t", "laplace"])
def test_families_draw_through_base_draws(family, case):
    """A float64 family or a non-Normal base draws u from ops/base_draws.py
    in the family's dtype, and z is the family's affine map of it."""
    base, dtype = {"float64_normal": (avt.Normal(), torch.float64),
                   "student_t": (avt.StudentT(5.0), torch.float32),
                   "laplace": (avt.Laplace(), torch.float32)}[case]
    q = _families(base, dtype)[family]
    z, u = q.sample_with_base(KEY, 9)
    assert z.dtype == u.dtype == dtype and u.shape == (9, q.base_dim)
    assert torch.equal(u, base_draws.draw(base, KEY, 9, q.base_dim, dtype, "cpu"))
    assert torch.equal(z, q.from_base(u))
    assert torch.equal(q.sample(KEY, 9), z)


@pytest.mark.parametrize("sampler", ["xla", "pallas"])
@pytest.mark.parametrize("family", ["meanfield", "fullrank", "lowrank"])
def test_float32_normal_draws_through_the_sampler_kernels(family, sampler):
    """A float32 Normal family draws the Philox sampler's u whatever
    ``sampler`` says (here the kernels' plain versions: CPU tensors)."""
    q = dataclasses.replace(_families(avt.Normal(), torch.float32)[family], sampler=sampler)
    z, u = q.sample_with_base(KEY, 7)
    if family == "meanfield":
        want = meanfield_sample_reference(KEY.seed, KEY.it, q.location, q.scale_diag, 7)
    elif family == "fullrank":
        want = fullrank_sample_reference(KEY.seed, KEY.it, q.location, q.scale, 7)
    else:
        zl, u1, u2 = lowrank_sample_reference(KEY.seed, KEY.it, q.location, q.scale_diag,
                                              q.scale_factors, 7)
        want = (zl, torch.cat([u1, u2], dim=1))
    assert torch.equal(z, want[0]) and torch.equal(u, want[1])


@pytest.mark.parametrize("family", ["meanfield", "fullrank", "lowrank"])
@pytest.mark.parametrize("case", ["student_t", "float64"])
def test_pallas_sampler_refuses_what_the_kernel_does_not_draw(family, case):
    """``sampler="pallas"`` on a non-Normal or non-float32 family raises the
    JAX package's ``_check_pallas_ok`` message, word for word."""
    base, dtype = (avt.StudentT(5.0), torch.float32) if case == "student_t" \
        else (avt.Normal(), torch.float64)
    q = dataclasses.replace(_families(base, dtype)[family], sampler="pallas")
    jbase_ = jbase.StudentT(df=5.0) if case == "student_t" else jbase.Normal()
    if case == "student_t":
        want = ("sampler='pallas' requires the Normal base (Box-Muller kernel); "
                "got StudentT")
        jq = javt.MeanFieldLocationScale(jnp.zeros(2), jnp.ones(2), base=jbase_,
                                         sampler="pallas")
        with pytest.raises(ValueError) as jerr:
            jq.sample(jax.random.key(0), 2)
        assert str(jerr.value) == want
    else:
        want = "sampler='pallas' requires float32 parameters, got torch.float64"
    with pytest.raises(ValueError) as err:
        q.sample_with_base(KEY, 4)
    assert str(err.value) == want


def test_gaussian_constructors_take_the_jax_argument_order():
    """``FullRankGaussian(m, C, "xla")`` hands "xla" to ``sampler`` as in
    JAX (it used to reach ``solve_mode`` and raise); ``MeanFieldGaussian``
    takes ``sampler`` third."""
    q = avt.FullRankGaussian(torch.zeros(3), torch.eye(3), "xla", None, "inverse", "packed")
    assert (q.sampler, q.solve_mode, q.layout) == ("xla", "inverse", "packed")
    jq = javt.FullRankGaussian(jnp.zeros(3), jnp.eye(3), "xla", None, "inverse", "packed")
    assert (jq.sampler, jq.solve_mode, jq.layout) == (q.sampler, q.solve_mode, q.layout)
    m = avt.MeanFieldGaussian(torch.zeros(3), torch.ones(3), "pallas")
    assert m.sampler == javt.MeanFieldGaussian(jnp.zeros(3), jnp.ones(3), "pallas").sampler
    qb = avt.FullRankGaussian(torch.zeros(3), None, "xla", "bfloat16")
    jqb = javt.FullRankGaussian(jnp.zeros(3), None, "xla", "bfloat16")
    assert (qb.sampler, qb.compute_dtype) == (jqb.sampler, jqb.compute_dtype) == ("xla",
                                                                               "bfloat16")


def test_float64_family_entropy_and_log_prob_match_jax():
    """A float64 Student-t full-rank family's log_prob and entropy against
    JAX's under x64 (rtol 1e-10)."""
    q = _families(avt.StudentT(5.0), torch.float64)["fullrank"]
    z = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 6)))
    with jax.enable_x64(True):
        jq = javt.FullRankLocationScale(jnp.asarray(q.location.numpy()),
                                        jnp.asarray(q.scale.numpy()),
                                        base=jbase.StudentT(df=5.0))
        want_lp = np.asarray(jq.log_prob(jnp.asarray(z.numpy())))
        want_h = float(jq.entropy())
    assert q.log_prob(z).dtype == torch.float64
    assert_allclose(q.log_prob(z).numpy(), want_lp, rtol=1e-10)
    assert_allclose(float(q.entropy()), want_h, rtol=1e-10)


def test_lowrank_family_with_a_student_t_base():
    """The low-rank family draws Student-t [u1 | u2] (heavier tails than the
    Gaussian's), its entropy takes the base's, and its log_prob stays the
    Gaussian-exact one, as in the JAX package."""
    q = _families(avt.StudentT(5.0), torch.float32)["lowrank"]
    jq = javt.LowRankLocationScale(jnp.asarray(q.location.numpy()),
                                   jnp.asarray(q.scale_diag.numpy()),
                                   jnp.asarray(q.scale_factors.numpy()),
                                   base=jbase.StudentT(df=5.0))
    z, u = q.sample_with_base(KEY, 4000)
    kurt = scipy.stats.kurtosis(u.numpy().ravel())
    assert kurt > 1.5  # Student-t(5) has excess kurtosis 6; a normal 0
    assert_allclose(float(q.entropy()), float(jq.entropy()), rtol=1e-5)
    assert_allclose(q.log_prob(z[:8]).numpy(), np.asarray(jq.log_prob(jnp.asarray(z[:8].numpy()))),
                    rtol=1e-5, atol=1e-5)
    assert_allclose(q.var().numpy(), np.asarray(jq.var()), rtol=1e-6)


@pytest.mark.parametrize("name", ["Normal", "StudentT", "Laplace"])
def test_base_from_jax_name(name):
    jb = {"Normal": jbase.Normal(), "StudentT": jbase.StudentT(df=3.0),
          "Laplace": jbase.Laplace()}[name]
    tb = convert.base_from_jax_name(type(jb).__name__, getattr(jb, "df", 5.0))
    assert type(tb).__name__ == name and tb.entropy() == pytest.approx(jb.entropy())
    q = convert.meanfield_from_numpy(np.zeros(2), np.ones(2), base=tb, device="cpu",
                                     dtype=torch.float64)
    assert q.base == tb and q.location.dtype == torch.float64
    with pytest.raises(ValueError, match="no port of the base"):
        convert.base_from_jax_name("Gumbel")
