"""Port parity of K5, the AD-derived fused model body
(advancedvi_jl_tpu_torch.ops.cuda.ad_body, ``ad_spec``, ``fused_spec_for``),
case for case with tests/test_fused_ad_spec.py: the port's engines run the
body's plain version here (the graph's replay) on the JAX package's draws,
held against the JAX engine in Pallas interpret mode, the JAX general path
and the port's hand-derived specs.  The generated CUDA itself is held to the
replay on a card (tests/test_torch_kernels.py, chip_smoke.py phase (y))."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.core import problem as jproblem
from advancedvi_jl_tpu.core import transforms as jtransforms
from advancedvi_jl_tpu.models.logreg import make_logreg as jax_make_logreg
from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank
from advancedvi_jl_tpu.models.normallognormal import (
    make_normallognormal as jax_make_normallognormal,
)
from advancedvi_jl_tpu.ops.pallas import fused_advi as jfused
from advancedvi_jl_tpu.ops.pallas import fused_chains as jchains
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.core import transforms
from advancedvi_jl_tpu_torch.core.problem import log_density_and_grad
from advancedvi_jl_tpu_torch.ops.cuda import _build, ad_body
from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
    AD,
    FULLRANK,
    GAUSSIAN,
    LOGREG,
    MVNORMAL,
    STATE_FIELDS,
    FusedADVI,
    FusedModelSpec,
    ad_spec,
    fused_spec_for,
    normallognormal_spec,
)

torch.set_num_threads(1)

T = 4
N_SAMPLES = 8
HAND_TOL = dict(rtol=2e-6, atol=1e-7)  # tests/test_fused_ad_spec.py:101
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)  # :115-116


# ---------------------------------------------------------------------------
# The two packages' targets, from the same numbers
# ---------------------------------------------------------------------------


def _nln(seed, n_dims):
    jt, _, _ = jax_make_normallognormal(jax.random.key(seed), n_dims)
    tt = convert.normallognormal_from_numpy(jt.mu_y, jt.sigma_y, jt.mu_x, jt.sigma_x,
                                            device="cpu")
    return jt, tt


def _logreg(seed, n_data, n_features):
    jp = jax_make_logreg(jax.random.key(seed), n_data=n_data, n_features=n_features)
    tp = convert.logreg_from_numpy(jp.X, jp.y, jp.likeadj, jp.prior_scale, device="cpu")
    return jp, tp


QUARTIC_D = 5
_ANCHOR = np.linspace(-1.0, 1.0, QUARTIC_D).astype(np.float32)
_W = np.arange(1.0, QUARTIC_D + 1.0).astype(np.float32)


def _jax_quartic(theta, data):
    r = theta - data["anchor"]
    return -jnp.sum(r * r * data["w"]) - 0.1 * jnp.sum(r ** 4)


def _torch_quartic(theta, data):  # the same density, batched over leading dims
    r = theta - data["anchor"]
    return -(r * r * data["w"]).sum(-1) - 0.1 * (r ** 4).sum(-1)


def _quartic_data():
    return ({"anchor": jnp.asarray(_ANCHOR), "w": jnp.asarray(_W)},
            {"anchor": torch.from_numpy(_ANCHOR), "w": torch.from_numpy(_W)})


# ---------------------------------------------------------------------------
# Runs on the same draws
# ---------------------------------------------------------------------------


def _jax_general(target, q0, steps=T, n_samples=N_SAMPLES):
    """JAX's general path (tests/test_fused_ad_spec.py:54-70), with the draws
    each step consumed."""
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


def _jax_fused(spec, q0, draws, family="meanfield"):
    """The JAX engine in interpret mode on the draws, in the port's layout."""
    eng = jfused.FusedADVI(spec, family=family, n_samples=N_SAMPLES, lr=1e-3, interpret=True)
    scale = q0.scale_matrix() if family == FULLRANK else q0.scale_diag
    st = eng.init(q0.location, scale)
    st = eng.run_chunk(st, jax.random.key(1), steps=len(draws),
                       noise=jnp.asarray(convert.pack_noise(draws, d_pad=eng.d_pad)))
    return convert.fused_state_from_numpy(st, q0.location.shape[0], device="cpu")


def _port_fused(spec, d, draws, family="meanfield", n_samples=N_SAMPLES):
    eng = FusedADVI(spec, family=family, n_samples=n_samples, lr=1e-3)
    scale = 0.1 * (torch.ones(d) if family == "meanfield" else torch.eye(d))
    return eng.run_chunk(eng.init(torch.zeros(d), scale), 1, len(draws),
                         noise=torch.as_tensor(draws))


def _jq0(d, family="meanfield"):
    if family == FULLRANK:
        return javt.FullRankGaussian(jnp.zeros(d), 0.1 * jnp.eye(d))
    return javt.MeanFieldGaussian(jnp.zeros(d), 0.1 * jnp.ones(d))


def _close_params(ts, loc, scale, tol=PARAM_TOL):
    assert_allclose(ts.mu.numpy(), np.asarray(loc), **tol)
    assert_allclose(ts.sig.numpy(), np.asarray(scale), **tol)


# ---------------------------------------------------------------------------
# The engines on ad specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["meanfield", "fullrank"])
def test_ad_spec_matches_hand_spec(family):
    """Same engine, same draws, the gradient from the traced graph instead of
    the hand derivation (tests/test_fused_ad_spec.py:87 and :181): states
    agree to float roundoff, and the full-rank one matches JAX's general
    path."""
    seed, n_dims = (1, 6) if family == "meanfield" else (2, 4)
    jt, tt = _nln(seed, n_dims)
    d = n_dims + 1
    jstate, draws, _ = _jax_general(jt.unconstrained(), _jq0(d, family))
    hand = _port_fused(normallognormal_spec(tt), d, draws, family)
    spec = ad_spec(tt.unconstrained())
    assert spec.dim == d and spec.model == AD
    ad = _port_fused(spec, d, draws, family)
    for f in STATE_FIELDS:
        assert_allclose(getattr(ad, f).numpy(), getattr(hand, f).numpy(), err_msg=f,
                        **HAND_TOL)
    assert_allclose(float(ad.elbo), float(hand.elbo), rtol=1e-5)
    if family == FULLRANK:
        assert_allclose(ad.mu.numpy(), np.asarray(jstate.q.location), **PARAM_TOL)


def test_ad_spec_logreg_matches_jax():
    """The flagship model through ad_spec at n_data 64, 12 features
    (tests/test_fused_ad_spec.py:105): the port's engine equals JAX's
    FusedADVI(ad_spec(...)) and JAX's general path on the same draws."""
    jp, tp = _logreg(11, 64, 12)
    d = jp.dim
    jstate, draws, infos = _jax_general(jp.unconstrained(), _jq0(d))
    ts = _port_fused(ad_spec(tp.unconstrained()), d, draws)
    js = _jax_fused(jfused.ad_spec(jp.unconstrained()), _jq0(d), draws)
    _close_params(ts, js.mu, js.sig)
    _close_params(ts, jstate.q.location, jstate.q.scale_diag)
    assert_allclose(float(ts.elbo), float(js.elbo), rtol=1e-4, atol=1e-4)
    assert_allclose(float(ts.elbo), float(infos[-1]["elbo"]), rtol=1e-4, atol=1e-4)


def test_from_log_density_custom_target():
    """A raw log density with no model class (tests/test_fused_ad_spec.py:156):
    the anisotropic quartic well, against JAX's general path and engine."""
    jdata, tdata = _quartic_data()
    d = QUARTIC_D
    jtarget = javt.fn_target(lambda t, dat: _jax_quartic(t, dat), d, data=jdata)
    jstate, draws, infos = _jax_general(jtarget, _jq0(d))
    spec = FusedModelSpec.from_log_density(_torch_quartic, d, data=tdata)
    ts = _port_fused(spec, d, draws)
    js = _jax_fused(jfused.FusedModelSpec.from_log_density(_jax_quartic, d, data=jdata),
                    _jq0(d), draws)
    _close_params(ts, jstate.q.location, jstate.q.scale_diag)
    _close_params(ts, js.mu, js.sig)
    assert_allclose(float(ts.elbo), float(infos[-1]["elbo"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("engine", ["prox", "scoregrad"])
def test_ad_spec_drives_every_engine(engine):
    """The same ad spec runs the proximal and score-gradient engines: equal
    to their run on the hand spec of the same target, same draws."""
    _, tt = _nln(3, 5)
    d = 6
    draws = np.random.default_rng(2).standard_normal((T, N_SAMPLES, d)).astype(np.float32)
    out = []
    for spec in (ad_spec(tt.unconstrained()), normallognormal_spec(tt)):
        if engine == "prox":
            eng = avt.FusedProxADVI(spec, family=FULLRANK, n_samples=N_SAMPLES,
                                    optimizer="descent", lr=1e-3)
            st = eng.init(torch.zeros(d), 0.1 * torch.eye(d))
        else:
            eng = avt.FusedScoreGradVI(spec, n_samples=N_SAMPLES, optimizer="adam",
                                       operator="clip")
            st = eng.init(torch.zeros(d), 0.1 * torch.ones(d))
        out.append(eng.run_chunk(st, 1, T, noise=torch.from_numpy(draws)))
    # the hand spec folds the log normalisers into one constant, the graph
    # adds them term by term: log pi differs in its last bits, which VarGrad's
    # centred coefficients (f_i - fbar) / n carry into the gradient (the
    # reparameterization gradient does not read log pi)
    tol = HAND_TOL if engine == "prox" else PARAM_TOL
    for f in STATE_FIELDS:
        assert_allclose(getattr(out[0], f).numpy(), getattr(out[1], f).numpy(), err_msg=f,
                        **tol)


def test_ad_spec_drives_chains_kernel():
    """Every chain of FusedChainsADVI on an ad spec equals the single-chain
    engine fed that chain's draws (tests/test_fused_ad_spec.py:210), and the
    JAX chains engine on the same draws."""
    jp, tp = _logreg(7, 32, 6)
    d = jp.dim
    C, n = 3, 4
    rng = np.random.default_rng(5)
    locs = rng.normal(0, 0.2, (C, d)).astype(np.float32)
    draws = rng.standard_normal((2, C, n, d)).astype(np.float32)
    spec = ad_spec(tp.unconstrained())
    eng = avt.FusedChainsADVI(spec, n_chains=C, n_samples=n, lr=1e-3)
    st = eng.run_chunk(eng.init(torch.from_numpy(locs), 0.1 * torch.ones(C, d)), 3, 2,
                       noise=torch.from_numpy(draws))
    single = FusedADVI(spec, n_samples=n, lr=1e-3)
    for c in range(C):
        s1 = single.run_chunk(single.init(torch.from_numpy(locs[c]), 0.1 * torch.ones(d)), 3,
                              2, noise=torch.from_numpy(draws[:, c]))
        for f in ("mu", "sig", "avg_mu", "avg_sig"):
            assert_allclose(getattr(st, f)[c].numpy(), getattr(s1, f).numpy(), err_msg=f,
                            **PARAM_TOL)
    jeng = jchains.FusedChainsADVI(jfused.ad_spec(jp.unconstrained()), n_chains=C,
                                   n_samples=n, lr=1e-3, interpret=True)
    js = jeng.run_chunk(jeng.init(jnp.asarray(locs), 0.1 * jnp.ones((C, d))),
                        jax.random.key(3), 2, noise=jnp.asarray(convert.pack_chains_noise(draws)))
    js = convert.chains_state_from_numpy(js, C, d, device="cpu")
    for f in ("mu", "sig", "avg_mu", "avg_sig"):
        assert_allclose(getattr(st, f).numpy(), getattr(js, f).numpy(), err_msg=f, **PARAM_TOL)


# ---------------------------------------------------------------------------
# Validation and routing
# ---------------------------------------------------------------------------


def _oracle():
    return avt.CustomGradTarget(data=None, value_fn=lambda t, _: -(t * t).sum(-1),
                                value_and_grad_fn=lambda t, _: (-(t * t).sum(-1), -2 * t),
                                dim=3)


VALIDATION = {
    "oracle target": (lambda: ad_spec(_oracle()), "order"),
    "bool leaf": (lambda: ad_spec(avt.fn_target(
        lambda t, dat: -(t * t).sum(-1), 2, {"mask": torch.ones(2, dtype=torch.bool)})),
        "bool"),
    "op off the list": (lambda: ad_spec(avt.fn_target(lambda t, _: torch.tanh(t).sum(-1), 3),
                                        device="cpu"), "tanh"),
    "data-dependent control flow": (lambda: ad_spec(avt.fn_target(
        lambda t, _: t.sum(-1) if bool(t.sum() > 0) else -t.sum(-1), 3), device="cpu"),
        "trace"),
}


@pytest.mark.parametrize("case", list(VALIDATION))
def test_ad_spec_validation(case):
    """tests/test_fused_ad_spec.py:249 and the port's own refusals: each
    raises ValueError at spec or engine build, never a silent fallback (a
    body over one block's shared memory is no refusal: the kernels' tiered
    layouts take it, tests/test_torch_fused_envelope_k5.py)."""
    build, match = VALIDATION[case]
    with pytest.raises(ValueError, match=match):
        build()
    if case == "oracle target":  # JAX refuses it the same way
        jt = jproblem.CustomGradTarget(data=None, value_fn=lambda t, _: -jnp.sum(t * t),
                                       value_and_grad_fn=lambda t, _: (-jnp.sum(t * t), -2 * t),
                                       dim=3)
        with pytest.raises(ValueError, match="order"):
            jfused.ad_spec(jt)


def _jax_spec_kind(spec) -> str:
    return {"_logreg_step_factory": LOGREG, "_mvnormal_step_factory": MVNORMAL,
            "_gaussian_step_factory": GAUSSIAN, "_ad_step_factory": AD}[
        spec.step_factory.__name__]


def _routing_case(case):
    """(JAX target, port target) of a routing case, from the same numbers."""
    if case == "normal":
        jt, mu, L = jax_normal_fullrank(jax.random.key(3), 4)
        return jt, convert.normal_target_from_numpy(mu, L, device="cpu")
    if case in ("nln", "nln-constrained"):
        jt, tt = _nln(4, 3)
        return (jt.unconstrained(), tt.unconstrained()) if case == "nln" else (jt, tt)
    jp, tp = _logreg(5, 16, 3)
    if case == "logreg":
        return jp.unconstrained(), tp.unconstrained()
    if case == "logreg-constrained":
        return jp, tp
    if case == "logreg-other-transform":  # identity on sigma: not the hand spec's bijector
        return (jtransforms.TransformedTarget(prob=jp, transform=jtransforms.stacked(
                    (jtransforms.Identity(), 4), (jtransforms.Identity(), 1))),
                transforms.TransformedTarget(prob=tp, transform=transforms.stacked(
                    (transforms.Identity(), 4), (transforms.Identity(), 1))))
    jdata, tdata = _quartic_data()
    return (javt.fn_target(_jax_quartic, QUARTIC_D, data=jdata),
            avt.fn_target(_torch_quartic, QUARTIC_D, data=tdata))


ROUTES = {"normal": MVNORMAL, "logreg": LOGREG, "nln": GAUSSIAN,
          "logreg-other-transform": AD, "fn-target": AD,
          "logreg-constrained": ValueError, "nln-constrained": ValueError}


@pytest.mark.parametrize("case", list(ROUTES))
def test_fused_spec_for_routes_as_jax(case):
    """fused_spec_for picks the spec JAX's picks (ops/pallas/fused_advi.py
    :1610-1650), case for case."""
    jt, tt = _routing_case(case)
    want = ROUTES[case]
    if want is ValueError:
        with pytest.raises(ValueError, match="constrained"):
            jfused.fused_spec_for(jt)
        with pytest.raises(ValueError, match="constrained"):
            fused_spec_for(tt)
        return
    spec = fused_spec_for(tt)
    assert spec.model == want == _jax_spec_kind(jfused.fused_spec_for(jt))
    assert spec.dim == jfused.fused_spec_for(jt).dim


# ---------------------------------------------------------------------------
# The body: replay, emission, oracle targets
# ---------------------------------------------------------------------------


def _targets():
    _, tt = _nln(1, 6)
    _, tp = _logreg(11, 64, 12)
    _, tdata = _quartic_data()
    return {"logreg": tp.unconstrained(), "nln": tt.unconstrained(),
            "quartic": avt.fn_target(_torch_quartic, QUARTIC_D, data=tdata)}


@pytest.mark.parametrize("name", ["logreg", "nln", "quartic"])
def test_replay_equals_eager_autograd_bitwise(name):
    """The plain version (the graph replayed on the packed constants) is the
    eager autograd value and gradient, bit for bit."""
    target = _targets()[name]
    prog = ad_spec(target).ad.program(N_SAMPLES)
    z = 0.3 * torch.randn(N_SAMPLES, target.dim, generator=torch.Generator().manual_seed(9))
    lp, grad = prog.logpi_grad(z)
    v, g = log_density_and_grad(target, z)
    assert torch.equal(lp, v) and torch.equal(grad, g)
    # a block of several n-row groups replays each group (the chains kernel's rows)
    lp3, g3 = prog.logpi_grad(torch.cat([z, z, z]))
    assert torch.equal(lp3, torch.cat([v, v, v])) and torch.equal(g3, torch.cat([g, g, g]))


@pytest.mark.parametrize("name", ["logreg", "nln", "quartic"])
def test_emitted_body_is_deterministic_and_listed(name):
    """Two traces of one target emit the same source (so the same library
    name), every op of the graph is on the list, and the source is one
    avi::ad::ad_body with its static shape and scratch."""
    target = _targets()[name]
    a = ad_spec(target).ad.program(N_SAMPLES)
    b = ad_spec(target).ad.program(N_SAMPLES)
    assert a.source == b.source and a.digest == b.digest
    listed = {ad_body._op_name(t) for t in ad_body.ALLOWED}
    assert set(a.ops) <= listed and a.ops
    assert "void ad_body(" in a.source and f"kN = {N_SAMPLES};" in a.source
    assert f"kD = {target.dim};" in a.source and f"kScratch = {a.scratch};" in a.source
    assert a.source.count("{") == a.source.count("}")
    assert a.source.count("__syncthreads();") == a.barriers
    assert "{DST:" not in a.source and "{OFF:" not in a.source
    assert _build.generated_library_path("fused_advi_meanfield", a.source) == \
        _build.generated_library_path("fused_advi_meanfield", b.source)
    # a program traced at another sample count is another body
    assert a.digest != ad_spec(target).ad.program(N_SAMPLES + 1).digest


def test_logreg_body_counts():
    """The flagship's graph: its two products are the logits and the
    likelihood gradient, n x 208 x 61 multiply-adds each."""
    _, tp = _logreg(11, 208, 60)
    prog = ad_spec(tp.unconstrained()).ad.program(10)
    assert prog.madds == 2 * 10 * 208 * 61
    assert "mm.default" in prog.ops and prog.d == 62 and prog.n == 10
    cf, ci = prog.consts
    assert cf.dtype == torch.float32 and ci.dtype == torch.int32
    assert cf.numel() == 208 * 61 + 208 + 1 + 1  # X, y, likeadj and the pad


def test_custom_grad_target_through_repgrad_matches_jax():
    """A CustomGradTarget's gradient reaches the ELBO through its oracle
    (maybe_wrap_custom_grad in RepGradELBO, JAX objectives/repgradelbo.py
    :154): the port's general path equals JAX's on the same draws, and the
    oracle, not autograd, gave the gradient."""
    d = 4
    m = np.linspace(-0.5, 0.5, d).astype(np.float32)
    calls = []

    def t_vag(t, _):
        calls.append(1)
        r = t - torch.from_numpy(m)
        return -0.5 * (r * r).sum(-1), -r

    jt = jproblem.CustomGradTarget(
        data=None, value_fn=lambda t, _: -0.5 * jnp.sum((t - m) ** 2),
        value_and_grad_fn=lambda t, _: (-0.5 * jnp.sum((t - m) ** 2), -(t - m)), dim=d)
    tt = avt.CustomGradTarget(data=None,
                              value_fn=lambda t, _: -0.5 * ((t - torch.from_numpy(m)) ** 2).sum(-1),
                              value_and_grad_fn=t_vag, dim=d)
    jstate, draws, infos = _jax_general(jt, _jq0(d))
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N_SAMPLES, optimizer=avt.adam(1e-3),
                                  operator=avt.ClipScale())
    state = alg.init(0, avt.MeanFieldGaussian(torch.zeros(d), 0.1 * torch.ones(d)), tt)
    for t in range(T):
        state, info = alg.step(state, noise=torch.from_numpy(draws[t]))
    assert len(calls) == T
    assert_allclose(state.q.location.numpy(), np.asarray(jstate.q.location), **PARAM_TOL)
    assert_allclose(state.q.scale_diag.numpy(), np.asarray(jstate.q.scale_diag), **PARAM_TOL)
    assert_allclose(float(info["elbo"]), float(infos[-1]["elbo"]), rtol=1e-4, atol=1e-4)
    assert avt.maybe_wrap_custom_grad(tt) is tt and tt.order() == avt.ORDER_GRAD


def test_log_density_grad_and_hess_matches_jax():
    """The order-2 path (JAX core/problem.py:69-81): the autograd Hessian of
    an fn_target, batched, and a Hessian oracle, against JAX's."""
    jdata, tdata = _quartic_data()
    th = np.random.default_rng(4).normal(0, 0.5, (3, QUARTIC_D)).astype(np.float32)
    jt = javt.fn_target(_jax_quartic, QUARTIC_D, data=jdata)
    tt = avt.fn_target(_torch_quartic, QUARTIC_D, data=tdata)
    v, g, h = avt.log_density_grad_and_hess(tt, torch.from_numpy(th))
    assert h.shape == (3, QUARTIC_D, QUARTIC_D)
    for i in range(3):
        jv, jg, jh = jproblem.log_density_grad_and_hess(jt, jnp.asarray(th[i]))
        assert_allclose(float(v[i]), float(jv), rtol=1e-6)
        assert_allclose(g[i].numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
        assert_allclose(h[i].numpy(), np.asarray(jh), rtol=1e-6, atol=1e-6)
    one = avt.log_density_grad_and_hess(tt, torch.from_numpy(th[0]))[2]
    assert torch.equal(one, h[0])
    oracle = avt.CustomGradTarget(
        data=None, value_fn=None, value_and_grad_fn=None, dim=2,
        value_grad_and_hess_fn=lambda t, _: (t.sum(), t, torch.eye(2)))
    assert oracle.order() == avt.ORDER_HESS
    assert torch.equal(avt.log_density_grad_and_hess(oracle, torch.ones(2))[2], torch.eye(2))
    with pytest.raises(ValueError, match="Hessian"):
        _oracle().log_density_grad_and_hess(torch.ones(3))


# ---------------------------------------------------------------------------
# The emitted body's plan: block products, staged constants, few barriers,
# and the static race check
# ---------------------------------------------------------------------------


def test_flagship_body_plan():
    """The flagship's body: its two mm nodes run the block product, at most
    8 barriers (20 before the planner fused element-local loops) and fewer
    than 26 loops; the engines' program stages its float constants in
    shared memory; the products keep k in order (one lane a sum), as the
    per-element loops before the block product did."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import ad_program

    _, tp = _logreg(11, 208, 60)
    spec = ad_spec(tp.unconstrained())
    prog = spec.ad.program(10)
    assert prog.barriers <= 8 and prog.loops < 26
    assert prog.products == 2 and prog.source.count("avi::block_mm<") == 2
    assert prog.source.count("__syncthreads();") == prog.barriers
    assert "avi::block_mm<kThreads, 5, 2, 1," in prog.source   # the logits
    assert "avi::block_mm<kThreads, 2, 2, 1," in prog.source   # the likelihood gradient
    assert prog.madds == 2 * 10 * 208 * 61
    for family, rows in (("meanfield", 8), (FULLRANK, 4)):
        staged = ad_program(spec, 10, family, rows)
        assert staged.staged and staged.stage >= prog.consts[0].numel()
        body = staged.source[staged.source.index("void ad_body("):]
        assert f"kStage = {staged.stage};" in staged.source and "cs[" in body and "cf[" not in body
        assert staged.barriers == prog.barriers and staged.scratch == prog.scratch
    assert ad_body._tile(10, 208, 61) == (5, 2, 1) and ad_body._tile(10, 61, 208) == (2, 2, 1)
    assert all(ad_body._tile(*mnk)[2] == 1 for mnk in ((1, 5, 5), (64, 64, 64), (10, 1, 5)))


def test_constants_that_do_not_fit_stay_in_device_memory():
    """A target whose constants cannot be staged beside the engine's arrays
    (800 x 61 design: 198,408 bytes of constants beside 77,088 of arrays
    and scratch) is still taken, and its body reads them from device
    memory; no program that fits unstaged is refused."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import ad_program, ad_smem_bytes

    _, tp = _logreg(11, 800, 60)
    spec = ad_spec(tp.unconstrained())
    prog = ad_program(spec, 10)
    assert not prog.staged and prog.stage == 0 and "kStage = 0;" in prog.source
    body = prog.source[prog.source.index("void ad_body("):]
    assert "cf[" in body and "cs[" not in body
    assert ad_smem_bytes("meanfield", 10, 62, prog.scratch, 8) <= _build.SMEM_LIMIT
    staged = spec.ad.program(10, staged=True)
    assert ad_smem_bytes("meanfield", 10, 62, staged.scratch, 8, staged.stage) > _build.SMEM_LIMIT
    assert FusedADVI(spec, n_samples=10).ad.digest == prog.digest


def _graph_targets():
    """Three more graphs of the allowed ops: chained products with a
    softplus between them (mm, transposes), row sums broadcast back over
    their rows, and cat/slice/select pieces with where and clamp_min."""
    g = torch.Generator().manual_seed(3)
    W1, W2 = torch.randn(6, 9, generator=g), torch.randn(9, 4, generator=g)

    def chained(t, dat):
        h = t @ dat["W1"]
        sp = torch.clamp_min(h, 0.0) + torch.log1p(torch.exp(-h.abs()))
        return -((sp @ dat["W2"]) ** 2).sum(-1) - 0.5 * (t * t).sum(-1)

    def rows(t, dat):
        r = (t * t).sum(-1, keepdim=True)
        return -((t - dat["c"] * r) ** 2).sum(-1) - torch.log1p(r).squeeze(-1)

    def pieces(t, dat):
        a, b = t[..., :3], t[..., 3:]
        c = torch.cat([torch.exp(b[..., :1]), a, b[..., 1:] * dat["s"]], dim=-1)
        w = torch.where(c >= 0.0, c, 0.5 * c)
        return -(w * w).sum(-1) + torch.clamp_min(t[..., 0], -1.0) - t[..., -1].abs()

    return {"chained": avt.fn_target(chained, 6, {"W1": W1, "W2": W2}),
            "rows": avt.fn_target(rows, 7, {"c": torch.tensor(0.1)}),
            "pieces": avt.fn_target(pieces, 6, {"s": torch.tensor([2.0])})}


def _race_targets():
    return {**_targets(), **_graph_targets()}


@pytest.mark.parametrize("name", ["logreg", "nln", "quartic", "chained", "rows", "pieces"])
def test_body_plan_has_no_race(name):
    """The static race check (ADProgram.race_check) on each target's plan:
    between two barriers every element one loop writes and another reads or
    writes falls to one thread, and no scratch float is reused without a
    barrier; the body's value and gradient are still the eager autograd's."""
    target = _race_targets()[name]
    prog = ad_spec(target).ad.program(N_SAMPLES)
    prog.race_check()
    z = 0.3 * torch.randn(N_SAMPLES, target.dim, generator=torch.Generator().manual_seed(4))
    lp, grad = prog.logpi_grad(z)
    v, gr = log_density_and_grad(target, z)
    assert torch.equal(lp, v) and torch.equal(grad, gr)


@pytest.mark.parametrize("name", ["logreg", "nln", "chained", "rows"])
def test_race_check_finds_a_missing_barrier(name):
    """Take away any one barrier of a plan and the race check fails: every
    barrier the planner places guards a real cross-thread dependence."""
    prog = ad_spec(_race_targets()[name]).ad.program(N_SAMPLES)
    planner, need, offsets = prog.planner
    assert any(need)
    for k in [k for k, bar in enumerate(need) if bar]:
        cut = list(need)
        cut[k] = False
        with pytest.raises(AssertionError):
            planner.race_check(cut, offsets)


def test_block_mm_plain_version_on_the_cpu():
    """The block product's wrapper runs torch.mm for CPU tensors and
    refuses them in its card entry; its configs are the tiles that the hand
    body, the minibatch body and K5's flagship body emit."""
    from advancedvi_jl_tpu_torch.ops.cuda.block_mm_kernels import (
        CONFIGS, block_mm, block_mm_cuda,
    )

    g = torch.Generator().manual_seed(0)
    A, B = torch.randn(10, 61, generator=g), torch.randn(61, 208, generator=g)
    assert torch.equal(block_mm(A, B), torch.mm(A, B))
    # the configs are the tiles the callers emit: the hand body's constants
    # (fused_common.cuh) on both layouts, and K5's flagship calls
    hand = (_build.CSRC / "fused_common.cuh").read_text()
    for tile, cfgs in (("Logit", (0, 2)), ("Grad", (1, 3))):
        want = tuple(int(re.search(rf"k{tile}{part} = (\d+)", hand).group(1))
                     for part in ("Rows", "Cols", "Split"))
        assert [CONFIGS[c] for c in cfgs] == [want + (True,), want + (False,)]
    for tile, cfg in (("MbLogit", 6), ("MbGrad", 7)):  # the minibatch body: aligned only
        want = tuple(int(re.search(rf"k{tile}{part} = (\d+)", hand).group(1))
                     for part in ("Rows", "Cols", "Split"))
        assert CONFIGS[cfg] == want + (True,)
    _, tp = _logreg(11, 208, 60)
    calls = re.findall(r"avi::block_mm<kThreads, (\d+), (\d+), (\d+), (true|false), false>",
                       ad_spec(tp.unconstrained()).ad.program(10).source)
    assert [CONFIGS[4], CONFIGS[5]] == [(*map(int, c[:3]), c[3] == "true") for c in calls]
    with pytest.raises(ValueError, match="CUDA"):
        block_mm_cuda(A, B)
    with pytest.raises(ValueError, match="config"):
        block_mm_cuda(A, B, config=8)
