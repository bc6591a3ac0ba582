"""Port parity: the measure-space algorithms (advancedvi_jl_tpu_torch
.algorithms.measure_space, gauss_expected, ops/sqrtm) against the JAX
package, and the port's own behaviour mirroring tests/test_measure_space.py.

The JAX step runs under ``jax.jit`` while its base draws are taken by its
own key schedule, ``q.base.sample(fold_in(state.key, state.iteration), (n,
d))``; the port's ``step`` takes the same draws through ``noise=`` from the
same state (``convert.measure_space_state_from_numpy``).  Here the full-rank
sampler runs its plain version (CPU tensors).  Tolerances are norm-wise,
||port - jax|| / ||jax||: 1e-5 after one step, 1e-4 after twenty, 1e-4 on
the ELBO; the eigh- and SVD-based steps keep these bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.algorithms import measure_space as jms
from advancedvi_jl_tpu.algorithms.gauss_expected import (
    gaussian_expected_grad_hess as jax_gegh,
)
from advancedvi_jl_tpu.core.problem import ORDER_GRAD as JAX_ORDER_GRAD
from advancedvi_jl_tpu.core.pytree import pytree_dataclass
from advancedvi_jl_tpu.models.logreg import make_logreg as jax_make_logreg
from advancedvi_jl_tpu.models.normal import NormalTarget as JaxNormalTarget
from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank
from advancedvi_jl_tpu.ops import sqrtm as jsqrtm
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.algorithms import measure_space as tms
from advancedvi_jl_tpu_torch.algorithms.gauss_expected import gaussian_expected_grad_hess
from advancedvi_jl_tpu_torch.core.problem import ORDER_GRAD, ORDER_HESS, order_of
from advancedvi_jl_tpu_torch.models.normal import normal_fullrank
from advancedvi_jl_tpu_torch.ops import sqrtm as tsqrtm
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import PhiloxKey

torch.set_num_threads(1)
CPU = "cpu"


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def t(a) -> torch.Tensor:
    return convert.to_tensor(a, device=CPU)


# -- targets on both sides ----------------------------------------------------


@pytree_dataclass
class JaxQuad:
    """tests/test_measure_space.py's quadratic, presented at order 1."""

    A: jax.Array
    b: jax.Array

    @property
    def dim(self):
        return self.b.shape[0]

    def order(self):
        return JAX_ORDER_GRAD

    def log_density(self, x):
        return -0.5 * x @ self.A @ x + self.b @ x

    def log_density_and_grad(self, x):
        return self.log_density(x), -self.A @ x + self.b


@dataclasses.dataclass(frozen=True)
class Quad:
    """The same quadratic in the port, batched: x (..., d)."""

    A: torch.Tensor
    b: torch.Tensor

    @property
    def dim(self):
        return self.b.shape[0]

    def order(self):
        return ORDER_GRAD

    def log_density(self, x):
        return -0.5 * torch.sum((x @ self.A) * x, dim=-1) + x @ self.b

    def log_density_and_grad(self, x):
        return self.log_density(x), -x @ self.A + self.b


@pytest.fixture(scope="module")
def quads():
    d = 4
    M = jax.random.normal(jax.random.key(9), (d, d))
    A = M @ M.T / d + jnp.eye(d)
    b = jax.random.normal(jax.random.key(10), (d,))
    return JaxQuad(A=A, b=b), Quad(A=t(A), b=t(b))


def autograd_quads(quads):
    jq, tq = quads
    jt = javt.fn_target(lambda x, data: -0.5 * x @ data[0] @ x + data[1] @ x, dim=4,
                        data=(jq.A, jq.b))
    tt = avt.fn_target(lambda x, data: -0.5 * torch.sum((x @ data[0]) * x, -1) + x @ data[1],
                       4, (tq.A, tq.b))
    return jt, tt


@pytest.fixture(scope="module")
def gaussians():
    """normal_fullrank(d = 5) of the JAX package on both sides (order 2)."""
    jt, mu, L = jax_normal_fullrank(jax.random.key(3), 5)
    return jt, convert.normal_target_from_numpy(jt.mu, jt.scale_tril, device=CPU)


# -- ops/sqrtm ----------------------------------------------------------------


def _spd(kind):
    rng = np.random.default_rng(0)
    if kind == "wellcond":
        M = rng.standard_normal((6, 6))
        A = M @ M.T / 6 + np.eye(6)
    else:  # tests/test_measure_space.py:314's spectrum, condition number 1e6
        Q, _ = np.linalg.qr(rng.standard_normal((16, 16)))
        A = (Q * np.logspace(-3, 3, 16)) @ Q.T
    A = A.astype(np.float32)
    return (A + A.T) / 2


@pytest.mark.parametrize("kind", ["wellcond", "illcond"])
def test_sqrtm_matches_jax(kind):
    """All three functions against JAX, rtol 1e-5 norm-wise.  The spectrum
    spanning 1e6 is compared in float64: in float32 eigh resolves its 1e-3
    eigenvalues only to ~1e-4 (eps ||A||), so two LAPACKs' inverse roots
    differ by ~1e-3 there whatever the code around them."""
    A = _spd(kind)
    if kind == "wellcond":
        tA, jA, n_iter = t(A), jnp.asarray(A), 20
        ctx = jax.enable_x64(False)
    else:
        tA, n_iter = torch.tensor(A, dtype=torch.float64), 100
        ctx = jax.enable_x64(True)
    with ctx:
        if kind == "illcond":
            jA = jnp.asarray(A, jnp.float64)
        assert rel(tsqrtm.sqrtm_psd(tA), jsqrtm.sqrtm_psd(jA)) <= 1e-5
        for got, want in zip(tsqrtm.inv_sqrtm_psd(tA), jsqrtm.inv_sqrtm_psd(jA)):
            assert rel(got, want) <= 1e-5
        assert rel(tsqrtm.sqrtm_newton_schulz(tA, n_iter),
                   jsqrtm.sqrtm_newton_schulz(jA, n_iter)) <= 1e-5


# -- gauss_expected -----------------------------------------------------------


@pytest.mark.parametrize("path,hessian", [("order1", "auto"), ("order1", "stein"),
                                          ("autograd", "auto"), ("autograd", "stein"),
                                          ("autograd", "exact")])
def test_gaussian_expected_grad_hess_matches_jax(quads, path, hessian):
    jq, tq = quads if path == "order1" else autograd_quads(quads)
    jfam = javt.FullRankGaussian(jnp.zeros(4), 0.7 * jnp.eye(4))
    tfam = avt.FullRankGaussian(torch.zeros(4), 0.7 * torch.eye(4))
    key = jax.random.key(4)
    u = np.asarray(jfam.base.sample(key, (64, 4), jnp.float32))
    want = jax_gegh(key, jfam, 64, jq, hessian=hessian)
    got = gaussian_expected_grad_hess(None, tfam, 64, tq, hessian=hessian, noise=t(u))
    assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert rel(g, w) <= 1e-5


def test_gaussian_expected_grad_hess_errors(quads):
    _, tq = quads
    tfam = avt.FullRankGaussian(torch.zeros(4))
    with pytest.raises(ValueError, match="hessian must be 'auto', 'stein', or 'exact'"):
        gaussian_expected_grad_hess(0, tfam, 2, tq, hessian="bogus")
    with pytest.raises(ValueError, match="hessian='exact' requires an order-2"):
        gaussian_expected_grad_hess(0, tfam, 2, tq, hessian="exact")
    # mc_axis outside a mesh: the unsharded expectations
    for a, b in zip(gaussian_expected_grad_hess(0, tfam, 2, tq, mc_axis="mc"),
                    gaussian_expected_grad_hess(0, tfam, 2, tq)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="noise must have shape"):
        gaussian_expected_grad_hess(0, tfam, 2, tq, noise=torch.zeros(3, 4))


def test_stein_matches_exact_hessian(quads):
    """tests/test_measure_space.py:60: the Stein estimate ~ -A with many
    samples, the exact path ~ -A, both on the port's Philox draws."""
    jq, tq = quads
    _, tt = autograd_quads(quads)
    q = avt.FullRankGaussian(torch.zeros(4), 0.7 * torch.eye(4))
    _, g_s, h_s = gaussian_expected_grad_hess(0, q, 200_000, tq)
    _, g_e, h_e = gaussian_expected_grad_hess(0, q, 1000, tt)
    assert_allclose(h_s.numpy(), -tq.A.numpy(), atol=0.05)
    assert_allclose(h_e.numpy(), -tq.A.numpy(), atol=1e-4)
    assert_allclose(g_s.numpy(), tq.b.numpy(), atol=0.05)
    assert_allclose(g_e.numpy(), tq.b.numpy(), atol=0.2)


def test_order2_oracle_uses_exact_path(quads):
    """tests/test_measure_space.py:180: a Hessian oracle raises the order to
    2 and the exact path uses it (a deliberately doubled Hessian)."""
    _, tq = quads
    A, b = tq.A, tq.b

    def vg(x, d):
        return -0.5 * torch.sum((x @ d[0]) * x, -1) + x @ d[1], -x @ d[0] + d[1]

    def vgh(x, d):
        v, g = vg(x, d)
        return v, g, (-2.0 * d[0]).expand(*x.shape[:-1], 4, 4)

    prob = avt.CustomGradTarget(data=(A, b), value_fn=lambda x, d: vg(x, d)[0],
                                value_and_grad_fn=vg, dim=4, value_grad_and_hess_fn=vgh)
    assert order_of(prob) == ORDER_HESS
    _, _, h = gaussian_expected_grad_hess(0, avt.FullRankGaussian(torch.zeros(4)), 100, prob)
    assert_allclose(h.numpy(), -2.0 * A.numpy(), rtol=1e-5)


# -- one step and twenty, against the JAX package ---------------------------------

ALGS = {
    "ngd": (lambda m: m.KLMinNaturalGradDescent(stepsize=0.1, n_samples=16)),
    "ngd_noposdef": (lambda m: m.KLMinNaturalGradDescent(stepsize=0.05, n_samples=16,
                                                          ensure_posdef=False)),
    "sqrt_ngd": (lambda m: m.KLMinSqrtNaturalGradDescent(stepsize=0.05, n_samples=16)),
    "wass": (lambda m: m.KLMinWassFwdBwd(stepsize=0.05, n_samples=16)),
    "wass_ns": (lambda m: m.KLMinWassFwdBwd(stepsize=0.05, n_samples=16,
                                             sqrtm="newton_schulz")),
    "bam": (lambda m: m.FisherMinBatchMatch(n_samples=32)),
}


def _jax_steps(jalg, jstate, steps):
    """JAX steps under jit with the draws its own key schedule takes."""
    step = jax.jit(jalg.step)
    draws, infos, states = [], [], []
    for _ in range(steps):
        key = jax.random.fold_in(jstate.key, jstate.iteration)
        draws.append(np.asarray(jstate.q.base.sample(key, (jalg.n_samples, jstate.q.dim),
                                                     jnp.float32)))
        jstate, info = step(jstate)
        infos.append(info)
        states.append(jstate)
    return states, draws, infos


def _compare(ts, js, tinfo, jinfo, rtol, tag, elbo_rtol=1e-4):
    assert rel(ts.q.location, js.q.location) <= rtol, tag
    assert rel(torch.tril(ts.q.scale), jnp.tril(js.q.scale)) <= rtol, tag
    if not isinstance(js.aux, tuple):
        assert rel(ts.aux, js.aux) <= rtol, tag
    assert ts.iteration == int(js.iteration)
    assert_allclose(float(tinfo["elbo"]), float(jinfo["elbo"]), rtol=elbo_rtol, atol=1e-4)
    assert not bool(tinfo["diverged"])
    if "covweighted_fisher" in jinfo:
        assert_allclose(float(tinfo["covweighted_fisher"]),
                        float(jinfo["covweighted_fisher"]), rtol=elbo_rtol, atol=1e-5)


def _parity(jalg, talg, jprob, tprob, jq0, steps, tol_one=1e-5, tol_all=1e-4,
            elbo_rtol=1e-4):
    """``steps`` injected steps of each side from one state: the first within
    ``tol_one``, the rest within ``tol_all`` (norm-wise)."""
    js0 = jalg.init(jax.random.key(0), jq0, jprob)
    states, draws, jinfos = _jax_steps(jalg, js0, steps)
    ts = convert.measure_space_state_from_numpy(js0, tprob, device=CPU)
    for k, u in enumerate(draws):
        ts, tinfo = talg.step(ts, noise=t(u))
        _compare(ts, states[k], tinfo, jinfos[k], tol_one if k == 0 else tol_all, k,
                 elbo_rtol)
    return ts, states[-1]


@pytest.mark.parametrize("name", sorted(ALGS))
def test_steps_match_jax_exact_path(gaussians, name):
    jt, tt = gaussians
    jq0 = javt.FullRankGaussian(jnp.zeros(5))
    _parity(ALGS[name](jms), ALGS[name](avt), jt, tt, jq0, 20)


@pytest.mark.parametrize("name", ["ngd", "ngd_noposdef", "sqrt_ngd", "wass", "wass_ns"])
def test_steps_match_jax_stein_path(quads, name):
    jq, tq = quads
    jq0 = javt.FullRankGaussian(jnp.zeros(4))
    _parity(ALGS[name](jms), ALGS[name](avt), jq, tq, jq0, 20)


def test_subsampled_ngd_matches_jax_on_its_permutation():
    """NGD with subsampling, the JAX schedule's permutation carried across
    (through an epoch boundary: 4 batches of 2)."""
    from advancedvi_jl_tpu.models.subsampled_normals import subsampled_normals as jsn

    jt, _, _ = jsn(jax.random.key(2), 8)
    tt = convert.subsampled_normals_from_numpy(jt.mus, jt.likeadj, device=CPU)
    jalg = jms.KLMinNaturalGradDescent(stepsize=0.05, n_samples=8,
                                       subsampling=javt.ReshufflingBatchSubsampling(8, 2))
    talg = avt.KLMinNaturalGradDescent(stepsize=0.05, n_samples=8,
                                       subsampling=avt.ReshufflingBatchSubsampling(8, 2))
    js = jalg.init(jax.random.key(0), javt.FullRankGaussian(jnp.zeros(1)), jt)
    ts = convert.measure_space_state_from_numpy(js, tt, device=CPU)
    step = jax.jit(jalg.step)
    for k in range(6):
        if int(js.sub_state.step) == 0:  # a new epoch: its permutation across
            ts = dataclasses.replace(ts, sub_state=convert.reshuffling_state_from_numpy(
                js.sub_state.perm, int(js.sub_state.epoch), 0, device=CPU))
        u = js.q.base.sample(jax.random.fold_in(js.key, js.iteration), (8, 1), jnp.float32)
        js, jinfo = step(js)
        ts, tinfo = talg.step(ts, noise=t(u))
        assert (tinfo["epoch"], tinfo["step"]) == (int(jinfo["epoch"]), int(jinfo["step"]))
        _compare(ts, js, tinfo, jinfo, 1e-5 if k == 0 else 1e-4, k)
    assert tinfo["epoch"] == 2


# -- the slice at the flagship's width ------------------------------------------


@pytest.fixture(scope="module")
def flagship():
    jprob = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device=CPU)
    return jprob.unconstrained(), tprob.unconstrained()


FLAGSHIP = {
    "ngd": (lambda m: m.KLMinNaturalGradDescent(stepsize=0.05, n_samples=32)),
    "ngd_noposdef": (lambda m: m.KLMinNaturalGradDescent(stepsize=0.05, n_samples=32,
                                                          ensure_posdef=False)),
    "sqrt_ngd": (lambda m: m.KLMinSqrtNaturalGradDescent(stepsize=0.05, n_samples=16)),
    # the forward step M = I + eta H needs eta < 2 / lam_max(-H): lam_max is
    # about 103 near this posterior, and 0.05 diverges in both packages by
    # step 3
    "wass": (lambda m: m.KLMinWassFwdBwd(stepsize=0.01, n_samples=16)),
    "wass_ns": (lambda m: m.KLMinWassFwdBwd(stepsize=0.01, n_samples=16,
                                             sqrtm="newton_schulz")),
    "bam": (lambda m: m.FisherMinBatchMatch(n_samples=32)),
    "ngd_stein": (lambda m: m.KLMinNaturalGradDescent(stepsize=0.05, n_samples=64,
                                                       hessian="stein")),
}


@pytest.mark.parametrize("name", sorted(FLAGSHIP))
def test_flagship_width_steps_match_jax(flagship, name):
    """5 injected steps on the 208 x 61 logistic regression (d = 62) from
    q0 = FullRankGaussian(0, 0.1 I), the settings chip_smoke.py (z) runs.
    BaM's first steps are float32-bound (lam = d n = 1,984 at step 1):
    both packages' float32 steps lie 5e-5 (location) and 3e-5 (scale)
    from a float64 step, and 7.4e-5 from each other, so its bound is 1e-4
    from the first step on (``test_bam_float32_floor``); its ELBO and Fisher
    divergence, of the q after those steps (a scale of ~100 after step 1),
    within 5e-4 (2.9e-4 shown at step 2; the first step's ELBO is exact)."""
    jt, tt = flagship
    jq0 = javt.FullRankGaussian(jnp.zeros(62), 0.1 * jnp.eye(62))
    tol = (1e-4, 1e-4, 5e-4) if name == "bam" else (1e-5, 1e-4)
    _parity(FLAGSHIP[name](jms), FLAGSHIP[name](avt), jt, tt, jq0, 5, *tol)


def _gaussian_256():
    """tests/test_measure_space.py:265's d = 256 target on both sides."""
    d = 256
    k1, k2 = jax.random.split(jax.random.key(3))
    mu = jax.random.normal(k1, (d,))
    L = jnp.tril((0.3 / d**0.5) * jax.random.normal(k2, (d, d)), -1) + jnp.eye(d)
    return (JaxNormalTarget(mu=mu, scale_tril=L), convert.normal_target_from_numpy(mu, L, device=CPU),
            javt.FullRankGaussian(jnp.zeros(d)))


def test_bam_large_d_steps_match_jax():
    """BaM at d = 256, n = 32, 5 injected steps: the factored SVD form at
    k = n + 1 < d.  Float32-bound (lam = 8,192 at step 1): the two packages'
    locations lie 5.5e-4 and 4.0e-4 from a float64 step and 6.3e-4 from
    each other, the scales 1.1e-4, 0.9e-4 and 1.4e-4 (1.7e-4 by step 2), so
    the bound is 1e-3 (``test_bam_float32_floor``); the ELBO within 5e-4
    (2.4e-4 shown), as at the flagship."""
    jt, tt, jq0 = _gaussian_256()
    _parity(jms.FisherMinBatchMatch(n_samples=32), avt.FisherMinBatchMatch(n_samples=32),
            jt, tt, jq0, 5, 1e-3, 1e-3, 5e-4)


@pytest.mark.parametrize("width", ["flagship", "gaussian_256"])
def test_bam_float32_floor(flagship, width):
    """Where BaM's bound is loose, the port's float32 step is no farther from
    a float64 step of the port than twice the JAX package's float32 step."""
    if width == "flagship":
        (jt, tt), jq0 = flagship, javt.FullRankGaussian(jnp.zeros(62), 0.1 * jnp.eye(62))
    else:
        jt, tt, jq0 = _gaussian_256()
    def double(obj):
        return dataclasses.replace(obj, **{k: v.double() for k, v in vars(obj).items()
                                           if isinstance(v, torch.Tensor)})

    tt64 = dataclasses.replace(tt, prob=double(tt.prob)) if width == "flagship" else double(tt)
    jalg, talg = jms.FisherMinBatchMatch(n_samples=32), avt.FisherMinBatchMatch(n_samples=32)
    js0 = jalg.init(jax.random.key(0), jq0, jt)
    (js,), (u,), _ = _jax_steps(jalg, js0, 1)
    ts0 = convert.measure_space_state_from_numpy(js0, tt, device=CPU)
    ts, _ = talg.step(ts0, noise=t(u))
    q64 = dataclasses.replace(ts0.q, location=ts0.q.location.double(),
                              scale=ts0.q.scale.double())
    t64, _ = talg.step(dataclasses.replace(ts0, q=q64, prob=tt64), noise=t(u).double())
    for got, want, exact in ((ts.q.location, js.q.location, t64.q.location),
                             (torch.tril(ts.q.scale), jnp.tril(js.q.scale),
                              torch.tril(t64.q.scale))):
        assert rel(got, exact) <= 2.0 * rel(want, exact)


def test_measure_space_state_round_trip(gaussians):
    """A JAX state carried across keeps every field bit for bit."""
    jt, tt = gaussians
    for name in ("ngd", "wass", "bam"):
        jalg = ALGS[name](jms)
        js, _, _ = _jax_steps(jalg, jalg.init(jax.random.key(0),
                                              javt.FullRankGaussian(jnp.zeros(5)), jt), 3)
        js = js[-1]
        ts = convert.measure_space_state_from_numpy(js, tt, seed=(5, 6), device=CPU)
        assert np.array_equal(ts.q.location.numpy(), np.asarray(js.q.location))
        assert np.array_equal(ts.q.scale.numpy(), np.tril(np.asarray(js.q.scale)))
        assert ts.iteration == 3 and ts.seed == (5, 6) and ts.prob is tt
        if isinstance(js.aux, tuple):
            assert ts.aux == ()
        else:
            assert np.array_equal(ts.aux.numpy(), np.asarray(js.aux))


# -- the port's own behaviour (tests/test_measure_space.py) -----------------------


@pytest.mark.parametrize("name", sorted(ALGS))
def test_convergence(name):
    """tests/test_measure_space.py:105: the parameter error at least halves
    in 400 steps on the d = 5 Gaussian."""
    target, mu, L = normal_fullrank(3, 5, device=CPU)
    out, infos, _ = avt.optimize(0, ALGS[name](avt), 400, target,
                                 avt.FullRankGaussian(torch.zeros(5)))
    err0 = float(torch.sum(mu**2) + torch.sum((torch.eye(5) - L) ** 2))
    err = float(torch.sum((out.location - mu) ** 2) + torch.sum((torch.tril(out.scale) - L) ** 2))
    assert err <= err0 / 2, (name, err, err0)
    assert np.isfinite(infos[-1]["elbo"])


def test_stein_path_convergence(quads):
    """tests/test_measure_space.py:124: NGD on an order-1 target."""
    _, tq = quads
    alg = avt.KLMinNaturalGradDescent(stepsize=0.2, n_samples=64)
    out, _, _ = avt.optimize(0, alg, 300, tq, avt.FullRankGaussian(torch.zeros(4)))
    A = tq.A.double()
    assert_allclose(out.location.numpy(), torch.linalg.solve(A, tq.b.double()).numpy(),
                    atol=0.1)
    assert_allclose(out.cov().numpy(), torch.linalg.inv(A).numpy(), atol=0.1)


def test_bam_fisher_objective():
    """tests/test_measure_space.py:138: ~0 at the exact posterior."""
    target, mu, L = normal_fullrank(3, 5, device=CPU)
    alg = avt.FisherMinBatchMatch(n_samples=64)
    assert float(alg.estimate_objective(0, avt.FullRankGaussian(mu, L), target)) < 1e-8
    assert float(avt.estimate_objective(0, alg, avt.FullRankGaussian(mu, L), target)) < 1e-8


def test_family_capability_and_option_errors(quads):
    target, _, _ = normal_fullrank(3, 5, device=CPU)
    with pytest.raises(ValueError, match="requires a FullRankGaussian variational family"):
        avt.KLMinWassFwdBwd(stepsize=0.1).init(0, avt.MeanFieldGaussian(torch.zeros(5)), target)
    value_only = avt.ExternalTarget(host_fn=lambda x: -0.5 * (x**2).sum(-1), dim=5)
    with pytest.raises(ValueError, match="requires at least first-order differentiation"):
        avt.KLMinNaturalGradDescent(stepsize=0.1).init(0, avt.FullRankGaussian(torch.zeros(5)),
                                                       value_only)
    with pytest.raises(ValueError, match="newton_schulz"):
        avt.KLMinWassFwdBwd(stepsize=0.05, sqrtm="pade")
    with pytest.raises(ValueError, match="n_samples >= 2"):
        avt.FisherMinBatchMatch(n_samples=1)
    assert avt.KLMinNaturalGradDescent(stepsize=0.1, mc_axis="mc").mc_axis == "mc"
    _, tq = quads
    bad = avt.KLMinNaturalGradDescent(stepsize=0.1, hessian="exact")
    with pytest.raises(ValueError, match="exact"):
        avt.optimize(0, bad, 2, tq, avt.FullRankGaussian(torch.zeros(4)))


@pytest.mark.parametrize("name", sorted(ALGS))
def test_step_keeps_a_row_major_scale(gaussians, name):
    """Every step hands the next one a contiguous scale: the K7b wrapper
    refuses any other on the card."""
    _, tt = gaussians
    alg = ALGS[name](avt)
    st = alg.init(0, avt.FullRankGaussian(torch.zeros(5)), tt)
    for _ in range(2):
        st, _ = alg.step(st)
        assert st.q.scale.is_contiguous() and st.q.location.is_contiguous()


def test_determinism_and_warm_start():
    """tests/test_measure_space.py:154, :244: two runs are equal, and 10 + 10
    steps by warm start equal 20, bitwise."""
    target, _, _ = normal_fullrank(3, 5, device=CPU)
    q0 = avt.FullRankGaussian(torch.zeros(5))
    for name in ("sqrt_ngd", "ngd", "wass", "bam"):
        alg = ALGS[name](avt)
        full, _, _ = avt.optimize(0, alg, 20, target, q0)
        again, _, _ = avt.optimize(0, alg, 20, target, q0)
        _, _, st = avt.optimize(0, alg, 10, target, q0)
        split, _, _ = avt.optimize(0, alg, 10, target, q0, state=st)
        for other in (again, split):
            assert torch.equal(full.location, other.location), name
            assert torch.equal(full.scale, other.scale), name


def test_bam_large_d_no_collapse():
    """tests/test_measure_space.py:265: BaM at d = 256, n = 32 stays finite
    for 150 steps with a healthy spectrum (the port's Philox draws)."""
    d = 256
    g = torch.Generator().manual_seed(3)
    mu = torch.randn(d, generator=g)
    L = torch.tril((0.3 / d**0.5) * torch.randn(d, d, generator=g), -1) + torch.eye(d)
    target = convert.normal_target_from_numpy(mu, L, device=CPU)
    alg = avt.FisherMinBatchMatch(n_samples=32)
    state = alg.init(0, avt.FullRankGaussian(torch.zeros(d)), target)
    for _ in range(150):
        state, info = alg.step(state)
        assert np.isfinite(float(info["elbo"]))
    sigma = state.q.scale.double() @ state.q.scale.double().T
    assert float(torch.linalg.eigvalsh(sigma)[0]) > 1e-4


def test_wass_newton_schulz_matches_eigh():
    """tests/test_measure_space.py:288."""
    target, _, _ = normal_fullrank(3, 8, device=CPU)
    q0 = avt.FullRankGaussian(torch.zeros(8))
    outs = {m: avt.optimize(0, avt.KLMinWassFwdBwd(stepsize=0.05, n_samples=16, sqrtm=m),
                            200, target, q0)[0] for m in ("eigh", "newton_schulz")}
    e, n = outs["eigh"], outs["newton_schulz"]
    assert_allclose(e.location.numpy(), n.location.numpy(), rtol=1e-3, atol=1e-4)
    assert_allclose(e.cov().numpy(), n.cov().numpy(), rtol=1e-2, atol=1e-4)


def test_non_pd_cholesky_is_nan_without_a_raise():
    """A factor of a matrix that is not positive definite is NaN, as JAX's
    cholesky gives (torch.linalg.cholesky would raise)."""
    A = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isnan(tms.cholesky(A)).all()
    # row-major, as the sampler kernel takes a scale (LAPACK's is column-major)
    assert tms.cholesky(4.0 * torch.eye(3) + 1.0).is_contiguous()
    assert torch.equal(tms.cholesky(torch.eye(2)), torch.eye(2))
    batch = tms.cholesky(torch.stack([A, torch.eye(2)]))
    assert torch.isnan(batch[0]).all() and torch.equal(batch[1], torch.eye(2))


def test_non_pd_step_diverges_at_that_step(gaussians):
    """NGD without the posdef correction and a step size past 1 turns
    S' = -2 S - 3 H indefinite (S = 100 I from q0's scale 0.1 I): the step's
    Cholesky is NaN, so its ELBO is, and optimize raises naming that step."""
    _, tt = gaussians
    alg = avt.KLMinNaturalGradDescent(stepsize=3.0, n_samples=16, ensure_posdef=False)
    q0 = avt.FullRankGaussian(torch.zeros(5), 0.1 * torch.eye(5))
    with pytest.raises(avt.DivergenceError, match="iteration 1\\."):
        avt.optimize(0, alg, 50, tt, q0)


def test_philox_key_schedule():
    """Step it draws with PhiloxKey(seed, it): a step with the sampler equals
    the step with that key's draws injected."""
    target, _, _ = normal_fullrank(3, 5, device=CPU)
    alg = avt.KLMinWassFwdBwd(stepsize=0.05, n_samples=8)
    st = alg.init(7, avt.FullRankGaussian(torch.zeros(5)), target)
    st, _ = alg.step(st)
    _, u = st.q.sample_with_base(PhiloxKey(st.seed, st.iteration), 8)
    a, _ = alg.step(st)
    b, _ = alg.step(st, noise=u)
    assert torch.equal(a.q.scale, b.q.scale) and torch.equal(a.q.location, b.q.location)
