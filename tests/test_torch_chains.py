"""Port parity: the general multi-chain path (``parallel/chains.py``), the
cases of tests/test_chains.py on the mean-field and low-rank families (a
planar flow's chains: tests/test_torch_flows.py).  The JAX
package vmaps the step over the chains; the port steps each chain's
state in turn, so chain c is ``optimize`` keyed by ``chain_seed_words(seed,
c)`` bit for bit.  Draws are the port's Philox normals (JAX's threefry
bits cannot be reproduced), so convergence is held to the JAX test's
bounds, not to its numbers.  Against the JAX module on shared numpy
inputs: ``step_chains`` with the JAX chains' own draws injected (the
tolerances of tests/test_torch_paramspace.py), ``best_chain``, the
stacked init, the axis tree and the error messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.models.logreg import make_logreg as jax_make_logreg
from advancedvi_jl_tpu.models.normal import normal_meanfield as jax_normal_meanfield
from advancedvi_jl_tpu.parallel import chains as jchains
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.models.normal import normal_meanfield
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import chain_seed_words
from advancedvi_jl_tpu_torch.parallel.chains import (
    ChainStates,
    _jitter_field,
    _state_axes,
    best_chain,
    chain_slice,
    init_chains,
    optimize_chains,
    stack_families,
    step_chains,
)

torch.set_num_threads(1)


def _alg(n_samples=4, lr=None):
    return avt.KLMinRepGradDescent(
        entropy=avt.STL, n_samples=n_samples,
        optimizer=avt.adam(lr) if lr is not None else None, operator=avt.ClipScale(),
    )


def _q0(d=5):
    return avt.MeanFieldGaussian(torch.zeros(d), torch.ones(d))


def test_chains_converge_and_best_chain():
    """8 jittered chains converge near the posterior; the best chain is
    picked through estimate_objective (tests/test_chains.py:18)."""
    target, mu, _ = normal_meanfield(1, 5, device="cpu")
    alg = _alg(8, 1e-2)
    outs, last_info, states, axes = optimize_chains(0, alg, 800, target, _q0(), n_chains=8,
                                                    jitter=0.5)
    assert outs.location.shape == (8, 5) and outs.scale_diag.shape == (8, 5)
    assert last_info["elbo"].shape == (8,) and bool(torch.isfinite(last_info["elbo"]).all())
    errs = torch.linalg.norm(outs.location - mu, dim=1)
    assert bool((errs < 0.5).all()), errs
    scores = torch.stack([
        -avt.estimate_objective(7, alg, chain_slice(outs, c), target, n_samples=2000)
        for c in range(8)])
    best = best_chain(outs, scores)
    assert best.location.shape == (5,)
    assert torch.equal(best.location, outs.location[int(torch.argmax(scores))])
    assert states.iteration == 800 and isinstance(states, ChainStates)


def test_chains_distinct_trajectories():
    """Distinct seed words give distinct chains (tests/test_chains.py:44)."""
    target, _, _ = normal_meanfield(1, 5, device="cpu")
    outs, _, states, _ = optimize_chains(0, _alg(), 20, target, _q0(), n_chains=4)
    assert len({tuple(np.round(r.numpy(), 6)) for r in outs.location}) == 4
    assert len({s.seed for s in states.chains}) == 4


def test_chains_share_target_memory():
    """The target is held once, not stacked (tests/test_chains.py:58)."""
    target, _, _ = normal_meanfield(1, 5, device="cpu")
    states, axes = init_chains(0, _alg(), _q0(), target, n_chains=4)
    assert states.prob.mu.shape == (5,)
    assert all(s.prob is target for s in states.chains)
    assert states.q.location.shape == (4, 5)
    assert axes.prob is None and axes.iteration is None and axes.q == 0
    assert _state_axes(states.chains[0]) == axes


def test_chain_c_is_optimize_on_its_seed_words():
    """Chain c of optimize_chains equals optimize keyed by
    chain_seed_words(seed, c), bit for bit, jitter included."""
    target, _, _ = normal_meanfield(2, 6, device="cpu")
    alg = _alg(4, 1e-2)
    q0 = _q0(6)
    outs, info, states, axes = optimize_chains(3, alg, 30, target, q0, n_chains=3, jitter=0.2)
    for c in range(3):
        qc = chain_slice(states.q, c)
        start = init_chains(3, alg, q0, target, n_chains=3, jitter=0.2)[0].chains[c].q
        out, infos, st = avt.optimize(chain_seed_words(3, c), alg, 30, target, start)
        assert torch.equal(st.q.location, qc.location)
        assert torch.equal(st.q.scale_diag, qc.scale_diag)
        assert torch.equal(out.location, outs.location[c])
        assert float(infos[-1]["elbo"]) == float(info["elbo"][c])
    # one step more through step_chains continues every chain
    more, step_info = step_chains(alg, states, axes)
    assert more.iteration == 31 and step_info["elbo"].shape == (3,)


def test_chains_stacked_flag_explicit():
    """Pre-stacked inits need stacked=True; shape mismatches and jitter on
    families without a location field raise (tests/test_chains.py:123,
    :155)."""
    target, _, _ = normal_meanfield(1, 5, device="cpu")
    q_stack = avt.MeanFieldGaussian(
        torch.stack([torch.zeros(5), torch.ones(5), -torch.ones(5)]), torch.ones(3, 5))
    states, _ = init_chains(0, _alg(), q_stack, target, n_chains=3, stacked=True)
    assert states.q.location.shape == (3, 5)
    assert torch.equal(states.q.location[1], torch.ones(5))
    with pytest.raises(ValueError, match="leading chain axis"):
        init_chains(0, _alg(), q_stack, target, n_chains=4, stacked=True)

    class NoLoc:
        pass

    with pytest.raises(ValueError, match="pre-stacked"):
        _jitter_field(NoLoc())
    with pytest.raises(ValueError, match="stacked=True"):
        init_chains(0, _alg(), avt.MeanFieldGaussian(torch.zeros(4, 3), torch.ones(4, 3)),
                    target, n_chains=4)
    with pytest.raises(ValueError, match="axes"):
        step_chains(_alg(), states, object())


def test_chains_jitter_is_keyed_and_low_rank_chains_run():
    """Jitter perturbs the location field with noise keyed by each chain's
    seed words (same words, same starts); it takes the low-rank family too."""
    target, _, _ = normal_meanfield(1, 5, device="cpu")
    a, _ = init_chains(4, _alg(), _q0(), target, n_chains=3, jitter=0.5)
    b, _ = init_chains(4, _alg(), _q0(), target, n_chains=3, jitter=0.5)
    assert torch.equal(a.q.location, b.q.location)
    assert torch.equal(a.q.scale_diag, torch.ones(3, 5))
    assert len({tuple(r.tolist()) for r in a.q.location}) == 3
    q0 = avt.LowRankGaussian(torch.zeros(5), torch.ones(5), 0.1 * torch.ones(5, 2))
    outs, info, _, _ = optimize_chains(0, _alg(8, 1e-2), 50, target, q0, n_chains=2,
                                       jitter=0.3)
    assert outs.scale_factors.shape == (2, 5, 2)
    assert bool(torch.isfinite(info["elbo"]).all())


# ---------------------------------------------------------------------------
# Against the JAX module on the same numpy inputs
# ---------------------------------------------------------------------------

C_JAX, N_JAX, T_JAX = 3, 6, 3


def _stacked(rng, c, d):
    """One stacked mean-field family of ``c`` chains, as JAX and as the port."""
    loc = (0.2 * rng.standard_normal((c, d))).astype(np.float32)
    scale = (0.1 + 0.05 * rng.uniform(size=(c, d))).astype(np.float32)
    return (javt.MeanFieldGaussian(jnp.asarray(loc), jnp.asarray(scale)),
            avt.MeanFieldGaussian(torch.from_numpy(loc), torch.from_numpy(scale)))


def _jax_chain_draws(states, n):
    """Each JAX chain's base draws for its next step: the vmapped step keys
    chain c by fold_in(key[c], iteration), as the single-chain step does."""
    def one(key, q):
        return q.sample_with_base(jax.random.fold_in(key, states.iteration), n)[1]

    return np.array(jax.vmap(one)(states.key, states.q))


@pytest.mark.parametrize("rule", ["adam", "dowg"])
def test_step_chains_matches_jax_on_the_same_draws(rule):
    """T steps of step_chains from one stacked start, each chain fed the JAX
    chain's own base draws: every chain's parameters, averages and ELBO
    agree with the JAX vmapped step."""
    jprob = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device="cpu")
    jq, tq = _stacked(np.random.default_rng(4), C_JAX, jprob.dim)
    jopt, topt = ((optax.adam(1e-3), avt.adam(1e-3)) if rule == "adam"
                  else (javt.dowg(), avt.dowg()))
    jalg = javt.KLMinRepGradDescent(entropy=javt.STL, n_samples=N_JAX, optimizer=jopt,
                                    operator=javt.ClipScale())
    talg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N_JAX, optimizer=topt,
                                   operator=avt.ClipScale())
    jtarget, ttarget = jprob.unconstrained(), tprob.unconstrained()
    js, jaxes = jchains.init_chains(jax.random.key(0), jalg, jq, jtarget, C_JAX, stacked=True)
    ts, taxes = init_chains(0, talg, tq, ttarget, C_JAX, stacked=True)
    jstep = jax.jit(lambda s: jchains.step_chains(jalg, s, jaxes))
    for _ in range(T_JAX):
        draws = _jax_chain_draws(js, N_JAX)
        js, jinfo = jstep(js)
        ts, tinfo = step_chains(talg, ts, taxes, noise=torch.from_numpy(draws))
        assert_allclose(tinfo["elbo"].numpy(), np.asarray(jinfo["elbo"]), rtol=1e-4, atol=1e-4)
    assert ts.iteration == int(js.iteration) == T_JAX
    assert_allclose(ts.q.location.numpy(), np.asarray(js.q.location), rtol=1e-5, atol=1e-6)
    assert_allclose(ts.q.scale_diag.numpy(), np.asarray(js.q.scale_diag), rtol=1e-5, atol=1e-6)
    jout = jax.vmap(jalg.output, in_axes=(jaxes,))(js)
    tout = stack_families([talg.output(s) for s in ts.chains])
    assert_allclose(tout.location.numpy(), np.asarray(jout.location), rtol=1e-5, atol=1e-6)
    assert_allclose(tout.scale_diag.numpy(), np.asarray(jout.scale_diag), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="leading chain axis"):
        step_chains(talg, ts, taxes, noise=torch.zeros(C_JAX + 1, N_JAX, jprob.dim))


def test_best_chain_matches_jax():
    """The same scores pick the same chain, ties and NaN included (argmax
    takes the first maximum; a NaN counts as the maximum in both)."""
    rng = np.random.default_rng(5)
    jq, tq = _stacked(rng, 6, 4)
    for scores in (rng.standard_normal(6), [0.1, 2.0, 3.0, 3.0, -1.0, 0.0],
                   [0.1, np.nan, 3.0, 3.0, -1.0, 0.0]):
        scores = np.asarray(scores, dtype=np.float32)
        jb = jchains.best_chain(jq, jnp.asarray(scores))
        for given in (torch.from_numpy(scores), scores.tolist()):
            tb = best_chain(tq, given)
            np.testing.assert_array_equal(tb.location.numpy(), np.asarray(jb.location))
            np.testing.assert_array_equal(tb.scale_diag.numpy(), np.asarray(jb.scale_diag))


def test_init_chains_stacked_axes_and_errors_match_jax():
    """A stacked init keeps every chain's start exactly, the axis tree
    matches JAX's on every shared field, and each refusal raises JAX's
    message word for word."""
    jtarget, _, _ = jax_normal_meanfield(jax.random.key(1), 5)
    ttarget, _, _ = normal_meanfield(1, 5, device="cpu")
    jalg = javt.KLMinRepGradDescent(entropy=javt.STL, n_samples=4, operator=javt.ClipScale())
    jq, tq = _stacked(np.random.default_rng(6), 3, 5)
    js, jaxes = jchains.init_chains(jax.random.key(0), jalg, jq, jtarget, 3, stacked=True)
    ts, taxes = init_chains(0, _alg(), tq, ttarget, 3, stacked=True)
    np.testing.assert_array_equal(ts.q.location.numpy(), np.asarray(js.q.location))
    np.testing.assert_array_equal(ts.q.scale_diag.numpy(), np.asarray(js.q.scale_diag))
    shared = {f for f in vars(jaxes)} & {f for f in vars(taxes)}
    assert {"prob", "q", "iteration", "opt_state", "obj_state", "avg_state"} <= shared
    assert {f: getattr(taxes, f) for f in shared} == {f: getattr(jaxes, f) for f in shared}

    class NoLoc:
        pass

    jq2 = javt.MeanFieldGaussian(jnp.zeros((4, 3)), jnp.ones((4, 3)))
    tq2 = avt.MeanFieldGaussian(torch.zeros(4, 3), torch.ones(4, 3))
    calls = [
        (lambda: jchains.init_chains(jax.random.key(0), jalg, jq, jtarget, 4, stacked=True),
         lambda: init_chains(0, _alg(), tq, ttarget, 4, stacked=True)),
        (lambda: jchains.init_chains(jax.random.key(0), jalg, jq2, jtarget, 4),
         lambda: init_chains(0, _alg(), tq2, ttarget, 4)),
        (lambda: jchains._jitter_field(NoLoc()), lambda: _jitter_field(NoLoc())),
    ]
    for jcall, tcall in calls:
        with pytest.raises(ValueError) as jerr:
            jcall()
        with pytest.raises(ValueError) as terr:
            tcall()
        assert str(terr.value) == str(jerr.value)
