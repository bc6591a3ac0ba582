"""Port parity: the normalizing-flow families (``PlanarFlowFamily``,
``RadialFlowFamily``, ``CouplingFlowFamily``, ``planar_flow``,
``radial_flow``, ``coupling_flow``) and ``FlowELBO`` against the JAX
package on the same numpy parameters and JAX's own base draws injected,
and the cases of tests/test_flows.py on the port's Philox draws.

Tolerances: rtol 1e-5 on draws and densities (the coupling flow's inverse
2e-5 against its forward path, as in JAX); after 20 injected-noise steps
rtol 1e-5 on the parameters, Adam moments and averaged parameters (atol
1e-6), 1e-4 on each step's ELBO.  The base draw is one K7a launch at
(n, d), held bit for bit to the sampler's plain version.  The fits run
half or a third of JAX's steps (1,500 on the banana, 1,000 for the radial
and coupling flows) and hold JAX's bars.
"""

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
from advancedvi_jl_tpu.algorithms.paramspace import ParamSpaceSGD as JParamSpaceSGD
from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.core.pytree import tree_leaves
from advancedvi_jl_tpu_torch.families.flows import _base_log_prob
from advancedvi_jl_tpu_torch.models.normal import normal_fullrank
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    PhiloxKey,
    chain_seed_words,
    meanfield_sample_reference,
)
from advancedvi_jl_tpu_torch.parallel.chains import chain_slice, init_chains, optimize_chains

torch.set_num_threads(1)
CPU = "cpu"
D, LAYERS = 3, 4


def _params(kind, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    base = (r(D, s=0.3), (0.6 + rng.random(D)).astype(np.float32))
    if kind == "planar":
        return base + (r(LAYERS, D, s=0.5), r(LAYERS, D, s=0.5), r(LAYERS, s=0.2))
    if kind == "radial":
        return base + (r(LAYERS, D, s=0.3), r(LAYERS), r(LAYERS))
    h = 8
    return base + (r(LAYERS, D, h, s=0.5), r(LAYERS, h, s=0.1), r(LAYERS, h, 2 * D, s=0.3),
                   r(LAYERS, 2 * D, s=0.1))


_JAX = {"planar": javt.PlanarFlowFamily, "radial": javt.RadialFlowFamily,
        "coupling": javt.CouplingFlowFamily}
_CONVERT = {"planar": convert.planar_flow_from_numpy, "radial": convert.radial_flow_from_numpy,
            "coupling": convert.coupling_flow_from_numpy}


def _pair(kind, seed=0):
    p = _params(kind, seed)
    return _JAX[kind](*(jnp.asarray(a) for a in p)), _CONVERT[kind](*p, device=CPU)


@pytest.mark.parametrize("kind", ["planar", "radial", "coupling"])
def test_sample_and_log_prob_match_jax_on_injected_draws(kind):
    jq, tq = _pair(kind)
    key = jax.random.key(2)
    z, logq = jq.sample_and_log_prob(key, 16)
    u = jax.random.normal(key, (16, D))
    tz, tlogq = tq.sample_and_log_prob_from_base(torch.from_numpy(np.array(u)))
    assert_allclose(tz.numpy(), np.asarray(z), rtol=1e-5, atol=1e-6)
    assert_allclose(tlogq.numpy(), np.asarray(logq), rtol=1e-5, atol=1e-6)
    assert (tq.dim, tq.n_layers, tq.base_dim) == (D, LAYERS, D)
    if kind == "coupling":
        zt = torch.from_numpy(np.array(z))
        assert_allclose(tq.log_prob(zt).numpy(), np.asarray(jq.log_prob(z)), rtol=1e-5,
                        atol=1e-6)
        assert_allclose(float(tq.log_prob(zt[0])), float(jq.log_prob(z[0])), rtol=1e-5)
    else:
        assert not hasattr(tq, "log_prob")


@pytest.mark.parametrize("kind", ["planar", "radial", "coupling"])
def test_base_draw_is_one_k7a_launch(kind):
    """z0 = u s + m is the mean-field sampler's draw on the base location and
    scale (its plain version here), bit for bit."""
    _, tq = _pair(kind)
    z, logq = tq.sample_and_log_prob(PhiloxKey((7, 8), 5), 10)
    z0, u = meanfield_sample_reference((7, 8), 5, tq.base_location, tq.base_scale_diag, 10)
    wz, wl = tq._push(z0, _base_log_prob(tq, u))
    assert torch.equal(z, wz) and torch.equal(logq, wl)
    assert torch.equal(tq.sample(PhiloxKey((7, 8), 5), 10), z)


def _push_fn(q):
    """u -> z of the whole flow for one (d,) base draw (for autograd)."""
    return lambda u: q.sample_and_log_prob_from_base(u[None])[0][0]


@pytest.mark.parametrize("kind", ["planar", "radial", "coupling"])
def test_change_of_variables_vs_autograd(kind):
    """log q = base log N(u) - log|det J| with J of the u -> z map by
    autograd (float64), and the coupling flow's log_prob at the pushed
    point equals it."""
    p = _params(kind, seed=3)
    q = _CONVERT[kind](*p, device=CPU, dtype=torch.float64)
    u = torch.randn(D, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    J = torch.autograd.functional.jacobian(_push_fn(q), u)
    logdet = torch.linalg.slogdet(J)[1]
    log_base = torch.sum(-0.5 * u * u) - 0.5 * D * math.log(2 * math.pi)  # J holds the scale
    z, logq = q.sample_and_log_prob_from_base(u[None])
    assert_allclose(float(logq[0]), float(log_base - logdet), rtol=1e-8)
    if kind == "coupling":
        assert_allclose(float(q.log_prob(z[0])), float(log_base - logdet), rtol=1e-8)


def test_coupling_log_prob_inverts_the_sampling_path():
    _, q = _pair("coupling", seed=7)
    z, logq = q.sample_and_log_prob(0, 256)
    assert_allclose(q.log_prob(z).numpy(), logq.numpy(), rtol=2e-5, atol=2e-5)
    assert_allclose(float(q.log_prob(z[0])), float(logq[0]), rtol=2e-5, atol=2e-5)


def test_planar_log_q_is_sane():
    q = avt.planar_flow(0, dim=2, n_layers=4, device=CPU)
    _, logq = q.sample_and_log_prob(1, 50_000)
    assert torch.isfinite(logq).all()
    assert 1.0 < -float(logq.mean()) < 10.0


def _assert_tree_close(t, j, **tol):
    jl, tl = jax.tree.leaves(j), tree_leaves(t)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("kind,entropy", [("planar", "monte_carlo"), ("radial", "monte_carlo"),
                                          ("coupling", "monte_carlo"), ("coupling", "stl")])
def test_twenty_steps_match_jax(kind, entropy):
    """FlowELBO (n = 8), Adam(1e-2), no operator, polynomial averaging on a
    d = 3 Gaussian: 20 steps on JAX's injected draws."""
    jt, mu, L = jax_normal_fullrank(jax.random.key(9), D)
    tt = convert.normal_target_from_numpy(mu, L, device=CPU)
    jq0, tq0 = _pair(kind)
    jalg = JParamSpaceSGD(objective=javt.FlowELBO(n_samples=8, entropy=entropy),
                          optimizer=optax.adam(1e-2), averager=javt.PolynomialAveraging(),
                          operator=javt.IdentityOperator())
    talg = avt.ParamSpaceSGD(objective=avt.FlowELBO(n_samples=8, entropy=entropy),
                             optimizer=avt.adam(1e-2), averager=avt.PolynomialAveraging(),
                             operator=avt.IdentityOperator())
    js, ts = jalg.init(jax.random.key(0), jq0, jt), talg.init(0, tq0, tt)
    step = jax.jit(jalg.step)
    for _ in range(20):
        u = jax.random.normal(jax.random.fold_in(js.key, js.iteration), (8, D))
        js, jinfo = step(js)
        ts, tinfo = talg.step(ts, noise=torch.from_numpy(np.array(u)))
        assert_allclose(float(tinfo["elbo"]), float(jinfo["elbo"]), rtol=1e-4, atol=1e-4)
    tol = dict(rtol=1e-5, atol=1e-6)
    _assert_tree_close(ts.q, js.q, **tol)
    _assert_tree_close(talg.output(ts), jalg.output(js), **tol)
    _assert_tree_close(ts.opt_state.mu, js.opt_state[0].mu, **tol)
    _assert_tree_close(ts.opt_state.nu, js.opt_state[0].nu, rtol=5e-5, atol=1e-9)


def test_refusals():
    q = avt.planar_flow(0, dim=2, n_layers=2, device=CPU)
    target = avt.fn_target(lambda th, _: -0.5 * torch.sum(th * th, dim=-1), dim=2)
    with pytest.raises(ValueError, match="analytic flow inverse"):
        avt.FlowELBO(n_samples=4, entropy="stl").init(0, q, target)
    with pytest.raises(ValueError, match="monte_carlo"):
        avt.FlowELBO(n_samples=4, entropy="closed_form")
    # mc_axis is taken; outside a mesh it changes nothing
    g1, _, i1 = avt.FlowELBO(n_samples=4, mc_axis="mc").value_and_grad(q, target, 3)
    g2, _, i2 = avt.FlowELBO(n_samples=4).value_and_grad(q, target, 3)
    assert torch.equal(i1["elbo"], i2["elbo"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g2)))
    with pytest.raises(ValueError, match=r"noise must have shape \(4, 2\)"):
        avt.FlowELBO(n_samples=4).loss(q, target, 0, noise=torch.zeros(4, 3))


def test_estimate_objective_falls_back_to_the_training_objective():
    """A flow without log_prob is scored by FlowELBO's own estimator, as
    JAX's ParamSpaceSGD.estimate_objective does; the coupling flow by
    RepGradELBO with the Monte-Carlo entropy."""
    target, _, _ = normal_fullrank(9, D, device=CPU)
    alg = avt.ParamSpaceSGD(objective=avt.FlowELBO(n_samples=8), optimizer=avt.adam(1e-2),
                            averager=avt.NoAveraging(), operator=avt.IdentityOperator())
    _, q = _pair("planar")
    want = avt.FlowELBO(n_samples=64).estimate_objective(3, q, target)
    assert torch.equal(alg.estimate_objective(3, q, target, 64), want)
    assert torch.equal(avt.estimate_objective(3, alg, q, target, 64), want)
    _, qc = _pair("coupling")
    got = alg.estimate_objective(3, qc, target, 64)
    assert torch.equal(got, avt.RepGradELBO(64, avt.MONTE_CARLO).estimate_objective(3, qc, target))


def _banana(th, _):
    x, y = th[..., 0], th[..., 1]
    return -0.5 * (x ** 2 / 4.0 + (y - 0.5 * x ** 2 + 1.0) ** 2 * 4.0)


def test_flow_vi_beats_meanfield_on_banana():
    target = avt.fn_target(_banana, dim=2)
    alg = avt.ParamSpaceSGD(objective=avt.FlowELBO(n_samples=64), optimizer=avt.adam(5e-3),
                            averager=avt.NoAveraging(), operator=avt.IdentityOperator())
    out, _, _ = avt.optimize(0, alg, 1500, target, avt.planar_flow(1, 2, 8, device=CPU),
                             log_every=500)
    flow_elbo = -float(avt.FlowELBO(n_samples=20_000).estimate_objective(5, out, target))
    algg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=64, optimizer=avt.adam(5e-3),
                                   operator=avt.ClipScale())
    outg, _, _ = avt.optimize(0, algg, 1500, target,
                              avt.MeanFieldGaussian(torch.zeros(2), torch.ones(2)),
                              log_every=500)
    gauss_elbo = -float(algg.estimate_objective(5, outg, target, 20_000))
    assert np.isfinite(flow_elbo) and np.isfinite(gauss_elbo)
    assert flow_elbo > gauss_elbo + 0.05, (flow_elbo, gauss_elbo)


def test_radial_flow_vi_improves_elbo():
    target, _, _ = normal_fullrank(9, 3, device=CPU)
    q0 = avt.radial_flow(1, dim=3, n_layers=6, device=CPU)
    alg = avt.ParamSpaceSGD(objective=avt.FlowELBO(n_samples=32), optimizer=avt.adam(1e-2),
                            averager=avt.NoAveraging(), operator=avt.IdentityOperator())
    elbo0 = -float(avt.FlowELBO(n_samples=5000).estimate_objective(5, q0, target))
    out, _, _ = avt.optimize(0, alg, 1000, target, q0, log_every=500)
    elbo1 = -float(avt.FlowELBO(n_samples=5000).estimate_objective(5, out, target))
    assert elbo1 > elbo0 + 0.5, (elbo0, elbo1)
    assert elbo1 > -0.5, elbo1


def test_coupling_stl_reduces_gradient_variance_on_banana():
    """Near the optimum the STL gradient (through the analytic inverse) has
    a lower variance than the Monte-Carlo-entropy gradient."""
    target = avt.fn_target(_banana, dim=2)
    alg = avt.ParamSpaceSGD(objective=avt.FlowELBO(n_samples=32, entropy="stl"),
                            optimizer=avt.adam(5e-3), averager=avt.NoAveraging(),
                            operator=avt.IdentityOperator())
    out, _, _ = avt.optimize(0, alg, 1000, target, avt.coupling_flow(1, 2, 6, 16, device=CPU),
                             log_every=500)
    flow_elbo = -float(avt.FlowELBO(n_samples=20_000).estimate_objective(5, out, target))
    assert flow_elbo > -0.05, flow_elbo

    def grad_var(entropy):
        obj = avt.FlowELBO(n_samples=4, entropy=entropy)
        gs = torch.stack([torch.cat([g.reshape(-1) for g in tree_leaves(
            obj.value_and_grad(out, target, PhiloxKey((9, 9), i))[0])]) for i in range(64)])
        return float(gs.var(0, unbiased=False).sum())

    v_stl, v_mc = grad_var("stl"), grad_var("monte_carlo")
    assert v_stl < v_mc, (v_stl, v_mc)


def test_optimize_chains_on_a_planar_flow_is_optimize_per_chain():
    """C = 2 chains of a jittered planar flow (its base_location) equal
    ``optimize`` keyed by each chain's seed words, bit for bit."""
    target, _, _ = normal_fullrank(9, D, device=CPU)
    alg = avt.ParamSpaceSGD(objective=avt.FlowELBO(n_samples=4), optimizer=avt.adam(1e-2),
                            averager=avt.PolynomialAveraging(),
                            operator=avt.IdentityOperator())
    q0 = avt.planar_flow(2, D, n_layers=3, device=CPU)
    outs, info, states, _ = optimize_chains(3, alg, 15, target, q0, n_chains=2, jitter=0.3)
    starts = init_chains(3, alg, q0, target, n_chains=2, jitter=0.3)[0]
    for c in range(2):
        start = starts.chains[c].q
        assert not torch.equal(start.base_location, q0.base_location)
        out, infos, st = avt.optimize(chain_seed_words(3, c), alg, 15, target, start)
        for a, b in zip(tree_leaves(st.q), tree_leaves(chain_slice(states.q, c))):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(out), tree_leaves(chain_slice(outs, c))):
            assert torch.equal(a, b)
        assert float(infos[-1]["elbo"]) == float(info["elbo"][c])
