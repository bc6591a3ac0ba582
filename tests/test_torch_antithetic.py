"""Port parity: RepGradELBO's ``antithetic``, ``fast_entropy`` and ``remat``
and ``KLMinRepGradDescent(antithetic=, fast_entropy=)`` against the JAX
package (its tests/test_fast_entropy.py and tests/test_klmin_repgrad.py),
with JAX's own base draws injected as noise (n/2 rows when antithetic)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.families import base as jbase
from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank
from advancedvi_jl_tpu.objectives import entropy as jent
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.core.pytree import tree_stop_gradient
from advancedvi_jl_tpu_torch.families.location_scale import (
    FullRankLocationScale,
    MeanFieldLocationScale,
)
from advancedvi_jl_tpu_torch.models.normal import normal_fullrank, normal_meanfield
from advancedvi_jl_tpu_torch.objectives import entropy as tent
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import PhiloxKey, seed_words

torch.set_num_threads(1)

D, N = 5, 8
BASES = {"normal": (avt.Normal(), jbase.Normal()),
         "student_t": (avt.StudentT(7.0), jbase.StudentT(df=7.0)),
         "laplace": (avt.Laplace(), jbase.Laplace())}


@pytest.fixture(scope="module")
def targets():
    jt, mu, L = jax_normal_fullrank(jax.random.key(3), D)
    return jt, convert.normal_target_from_numpy(mu, L, device="cpu")


def _params(qtype):
    rng = np.random.default_rng(11)
    loc = (0.3 * rng.standard_normal(D)).astype(np.float32)
    if qtype == "meanfield":
        return loc, (0.5 + 0.4 * rng.random(D)).astype(np.float32)
    A = 0.25 * rng.standard_normal((D, D))
    return loc, (np.tril(A) + 0.8 * np.eye(D)).astype(np.float32)


def _pair(qtype, base_name, solve_mode="solve"):
    """(JAX family, port family) on the same parameters and base."""
    tb, jb = BASES[base_name]
    loc, scale = _params(qtype)
    if qtype == "meanfield":
        return (javt.MeanFieldLocationScale(jnp.asarray(loc), jnp.asarray(scale), base=jb),
                MeanFieldLocationScale(torch.from_numpy(loc), torch.from_numpy(scale), base=tb))
    return (javt.FullRankLocationScale(jnp.asarray(loc), jnp.asarray(scale), base=jb),
            FullRankLocationScale(torch.from_numpy(loc), torch.from_numpy(scale), base=tb,
                                  solve_mode=solve_mode))


def _scale(q):
    return q.scale_diag if hasattr(q, "scale_diag") else q.scale


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("estimator", tent.ALL_ENTROPY_ESTIMATORS)
@pytest.mark.parametrize("qtype", ["meanfield", "fullrank"])
@pytest.mark.parametrize("base_name", list(BASES))
def test_loss_and_grad_match_jax(targets, base_name, qtype, estimator, antithetic):
    """Loss (rtol 1e-5) and gradient (rtol 1e-4, atol 1e-6) of every family
    x base x estimator x antithetic setting against JAX's, with
    ``fast_entropy`` on and off (equal to each other too)."""
    jt, tt = targets
    jq, tq = _pair(qtype, base_name)
    key = jax.random.key(42)
    _, u = jq.sample_with_base(key, N // 2 if antithetic else N)
    jobj = javt.RepGradELBO(n_samples=N, entropy=estimator, antithetic=antithetic)
    jloss, jgrad = jax.value_and_grad(lambda q: jobj.loss(q, jt, key))(jq)
    got = {}
    for fast in (True, False):
        obj = avt.RepGradELBO(n_samples=N, entropy=estimator, antithetic=antithetic,
                              fast_entropy=fast)
        grad, _, info = obj.value_and_grad(tq, tt, None, noise=torch.from_numpy(np.array(u)))
        assert_allclose(-float(info["elbo"]), float(jloss), rtol=1e-5, atol=1e-6)
        assert_allclose(grad.location.numpy(), np.asarray(jgrad.location), rtol=1e-4, atol=1e-6)
        assert_allclose(_scale(grad).numpy(), np.asarray(_scale(jgrad)), rtol=1e-4, atol=1e-6)
        got[fast] = (float(info["elbo"]), grad)
    assert_allclose(got[True][0], got[False][0], rtol=2e-5, atol=2e-5)
    for a, b in zip((got[True][1].location, _scale(got[True][1])),
                    (got[False][1].location, _scale(got[False][1]))):
        assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", ["meanfield", "fullrank-solve", "fullrank-pallas",
                                  "fullrank-inverse"])
@pytest.mark.parametrize("base_name", list(BASES))
def test_stl_custom_backward_against_autograd(base_name, case):
    """``_STLEntropyFast``'s backward in z against autograd through
    -mean log q_stop(z), and against JAX's custom VJP (every solve mode:
    K8's plain version under "pallas", ops/trinv.py under "inverse")."""
    qtype, _, mode = case.partition("-")
    jq, tq = _pair(qtype, base_name, mode or "solve")
    _, u = jq.sample_with_base(jax.random.key(7), 16)
    ut = torch.from_numpy(np.array(u))
    z = tq.from_base(ut).detach()
    q_stop = tree_stop_gradient(tq)

    def grad_of(fn):
        zz = z.clone().requires_grad_(True)
        val = fn(zz)
        return float(val.detach()), torch.autograd.grad(val, zz)[0].numpy()

    vf, gf = grad_of(lambda zz: tent.estimate_entropy_from_draw("stl", zz, ut, q_stop, q_stop))
    vs, gs = grad_of(lambda zz: tent.estimate_entropy("stl", zz, q_stop, q_stop))
    assert_allclose(vf, vs, rtol=2e-5, atol=2e-5)
    assert_allclose(gf, gs, rtol=2e-4, atol=1e-6)
    zj = jnp.asarray(z.numpy())
    gj = jax.grad(lambda zz: jent.estimate_entropy_from_draw("stl", zz, u, jq, jq))(zj)
    assert_allclose(gf, np.asarray(gj), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("qtype", ["meanfield", "fullrank"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_remat_matches_plain(targets, qtype, antithetic):
    """Checkpointing the log-density changes memory, not values (rtol 1e-6);
    the draw is made once, before the checkpointed call."""
    _, tt = targets
    _, tq = _pair(qtype, "normal")
    calls = []

    class Counting:
        dim = D

        def log_density(self, z):
            calls.append(z.shape)
            return tt.log_density(z)

    key = PhiloxKey(seed_words(3), 5)
    outs = []
    for remat in (False, True):
        calls.clear()
        obj = avt.RepGradELBO(n_samples=16, entropy=avt.STL, remat=remat, antithetic=antithetic)
        g, _, info = obj.value_and_grad(tq, Counting(), key)
        outs.append((g, info))
        assert len(calls) == (2 if remat else 1)  # the backward recomputes it once
    (g1, i1), (g2, i2) = outs
    assert_allclose(float(i1["elbo"]), float(i2["elbo"]), rtol=1e-6)
    for a, b in ((g1.location, g2.location), (_scale(g1), _scale(g2))):
        assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


@dataclasses.dataclass(frozen=True)
class Skewed:
    """A base that does not declare symmetry."""

    def symmetric(self):
        return False


class NotLocationScale:
    """A family without a location."""


@pytest.mark.parametrize("case", ["odd_n", "no_location", "asymmetric_base"])
def test_antithetic_refusals_match_jax_word_for_word(case):
    q_t = {"odd_n": avt.MeanFieldGaussian(torch.zeros(3)), "no_location": NotLocationScale(),
           "asymmetric_base": MeanFieldLocationScale(torch.zeros(3), torch.ones(3),
                                                     base=Skewed())}[case]
    q_j = {"odd_n": javt.MeanFieldGaussian(jnp.zeros(3)), "no_location": NotLocationScale(),
           "asymmetric_base": javt.MeanFieldLocationScale(jnp.zeros(3), jnp.ones(3),
                                                          base=Skewed())}[case]
    n = 3 if case == "odd_n" else 4
    with pytest.raises(ValueError) as jerr:
        javt.RepGradELBO(n_samples=n, antithetic=True)._check_antithetic(q_j, n)
    with pytest.raises(ValueError) as terr:
        avt.RepGradELBO(n_samples=n, antithetic=True)._check_antithetic(q_t, n)
    assert str(terr.value) == str(jerr.value)
    if case != "no_location":  # through the public path too
        with pytest.raises(ValueError, match="antithetic sampling requires"):
            avt.RepGradELBO(n_samples=n, antithetic=True).value_and_grad(
                q_t, normal_meanfield(1, 3, device="cpu")[0], 0)


def test_antithetic_pairs_mirror_and_estimate_objective():
    """z' = 2m - z and u' = -u row for row; estimate_objective pairs the
    draws for an even n and draws plainly for an odd one."""
    tt, _, _ = normal_meanfield(2, D, device="cpu")
    q = avt.MeanFieldGaussian(torch.full((D,), 0.2), 0.7 * torch.ones(D))
    key = PhiloxKey(seed_words(1), 3)
    obj = avt.RepGradELBO(n_samples=6, entropy=avt.MONTE_CARLO, antithetic=True)
    z, u = obj._draw_with_base(q, key)
    z0, u0 = q.sample_with_base(key, 3)
    assert torch.equal(z[:3], z0) and torch.equal(u[3:], -u0)
    assert torch.equal(z[3:], 2.0 * q.location - z0)
    want = -(tt.log_density(z).mean() + tent.estimate_entropy(avt.MONTE_CARLO, z, q, q))
    assert torch.equal(obj.estimate_objective(key, q, tt), want)
    plain = avt.RepGradELBO(n_samples=5, entropy=avt.MONTE_CARLO)
    assert torch.equal(obj.estimate_objective(key, q, tt, 5),
                       plain.estimate_objective(key, q, tt))


def test_antithetic_lowers_the_gradient_variance():
    """JAX's test: 64 gradient estimates at a fixed q on a smooth target;
    the antithetic estimator's total variance is below 0.7 of the plain
    one's (closed-form entropy, so all the noise is the energy term's)."""
    tt, mu, _ = normal_meanfield(4, D, device="cpu")
    q = avt.MeanFieldGaussian(torch.zeros(D), 0.5 * torch.ones(D))

    def total_var(antithetic):
        obj = avt.RepGradELBO(n_samples=8, entropy=avt.CLOSED_FORM, antithetic=antithetic)
        gs = []
        for i in range(64):
            g = obj.value_and_grad(q, tt, PhiloxKey(seed_words(0), i))[0]
            gs.append(torch.cat([g.location, g.scale_diag]))
        return float(torch.stack(gs).var(dim=0).sum())

    assert total_var(True) < 0.7 * total_var(False)


def test_constructor_takes_jax_order_and_refuses_mc_axis():
    alg = avt.KLMinRepGradDescent(avt.STL, None, 10, None, None, None, None, True, False)
    assert (alg.objective.antithetic, alg.objective.fast_entropy) == (True, False)
    jalg = javt.KLMinRepGradDescent(javt.STL, None, 10, None, None, None, None, True, False)
    assert (jalg.objective.antithetic, jalg.objective.fast_entropy) == (True, False)
    assert avt.KLMinRepGradDescent().objective.fast_entropy
    # mc_axis is taken (tests/test_torch_multiprocess.py shards it); outside
    # a mesh the antithetic estimate is the one without it
    sharded = avt.KLMinRepGradDescent(avt.STL, n_samples=10, antithetic=True, mc_axis="mc")
    plain = avt.KLMinRepGradDescent(avt.STL, n_samples=10, antithetic=True)
    assert sharded.objective.mc_axis == "mc"
    target, _, _ = normal_fullrank(3, 4, device="cpu")
    q = avt.FullRankGaussian(torch.zeros(4))
    g1, _, i1 = sharded.objective.value_and_grad(q, target, 5)
    g2, _, i2 = plain.objective.value_and_grad(q, target, 5)
    assert torch.equal(g1.location, g2.location) and torch.equal(i1["elbo"], i2["elbo"])


def _jax_run(jtarget, jq0, steps, n_draw):
    alg = javt.KLMinRepGradDescent(entropy=javt.STL, n_samples=N, optimizer=optax.adam(1e-3),
                                   operator=javt.ClipScale(), antithetic=True)
    state = alg.init(jax.random.key(0), jq0, jtarget)
    step = jax.jit(alg.step)
    draws, infos = [], []
    for _ in range(steps):
        _, u = state.q.sample_with_base(jax.random.fold_in(state.key, state.iteration), n_draw)
        draws.append(np.array(u))
        state, info = step(state)
        infos.append(float(info["elbo"]))
    return alg, state, draws, infos


@pytest.mark.parametrize("qtype", ["meanfield", "fullrank"])
@pytest.mark.parametrize("base_name", ["normal", "student_t"])
def test_antithetic_advi_twenty_steps_match_jax(targets, qtype, base_name):
    """KLMinRepGradDescent(antithetic=True), STL, Adam, ClipScale: 20 steps
    on JAX's injected half draws; parameters and averages within rtol 1e-5."""
    jt, tt = targets
    jq0, tq0 = _pair(qtype, base_name)
    jalg, js, draws, jinfos = _jax_run(jt, jq0, 20, N // 2)
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N, optimizer=avt.adam(1e-3),
                                  operator=avt.ClipScale(), antithetic=True)
    st = alg.init(0, tq0, tt)
    for u, je in zip(draws, jinfos):
        st, info = alg.step(st, noise=torch.from_numpy(u))
        assert_allclose(float(info["elbo"]), je, rtol=1e-4, atol=1e-4)
    tol = dict(rtol=1e-5, atol=1e-6)
    assert_allclose(st.q.location.numpy(), np.asarray(js.q.location), **tol)
    assert_allclose(_scale(st.q).numpy(), np.asarray(_scale(js.q)), **tol)
    tout, jout = alg.output(st), jalg.output(js)
    assert_allclose(tout.location.numpy(), np.asarray(jout.location), **tol)
    assert_allclose(_scale(tout).numpy(), np.asarray(_scale(jout)), **tol)
