"""Port parity: the per-datapoint family (``PerDatapointMeanField``,
``per_datapoint_meanfield``) and the global-local product family
(``GlobalLocalFamily``) against the JAX package on the same numpy
parameters and JAX's own base draws injected; the cases of
tests/test_amortized.py and the parts of tests/test_ppl_local.py that need
no ppl (the random-effects model written as a factorized target), on the
port's Philox draws.

Tolerances: rtol 1e-5 on densities, entropies and moments; after 20
injected-noise subsampled steps rtol 1e-5 on the parameters, Adam moments
and averaged parameters (atol 1e-6), 1e-4 on each step's ELBO; the
statistical cases hold JAX's bounds.  Every draw is one K7a launch a part,
held bit for bit to the sampler's plain version; the global and local
parts draw under two sub-keys of the step's key.
"""

import dataclasses
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
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.core.pytree import tree_leaves
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    PhiloxKey,
    meanfield_sample_reference,
    split_seed_words,
)

torch.set_num_threads(1)
CPU = "cpu"
N = 48
S0, SZ, SY = 2.0, 1.0, 0.5  # prior sd of mu, z | mu, y | z


def _y(n=N, seed=0):
    rng = np.random.default_rng(seed)
    mu = S0 * rng.standard_normal()
    z = mu + SZ * rng.standard_normal(n)
    return (z + SY * rng.standard_normal(n)).astype(np.float32)


def _norm_lp(x, loc, sd):
    return -0.5 * ((x - loc) / sd) ** 2 - 0.5 * math.log(2 * math.pi * sd ** 2)


def random_effects_target(y):
    """The random-effects model of tests/test_ppl_local.py as a factorized
    target over theta = [mu, z_1 .. z_B] (batched)."""
    return avt.factorized_target(
        logprior_fn=lambda th: _norm_lp(th[..., 0], 0.0, S0),
        loglike_fn=lambda th, data: torch.sum(
            _norm_lp(th[..., 1:], th[..., :1], SZ) + _norm_lp(data["y"], th[..., 1:], SY), dim=-1),
        data={"y": torch.as_tensor(y)}, dim=1 + len(y))


def _jax_random_effects_target(y):
    return javt.factorized_target(
        logprior_fn=lambda th: _norm_lp(th[0], 0.0, S0),
        loglike_fn=lambda th, data: jnp.sum(_norm_lp(th[1:], th[0], SZ)
                                            + _norm_lp(data["y"], th[1:], SY)),
        data={"y": jnp.asarray(y)}, dim=1 + len(y))


def exact_posterior(y):
    """Mean and precision diagonal of the Gaussian posterior over (mu, z)."""
    n = len(y)
    lam = np.zeros((n + 1, n + 1))
    lam[0, 0] = 1 / S0 ** 2 + n / SZ ** 2
    idx = np.arange(1, n + 1)
    lam[idx, idx] = 1 / SZ ** 2 + 1 / SY ** 2
    lam[0, idx] = lam[idx, 0] = -1 / SZ ** 2
    b = np.concatenate([[0.0], np.asarray(y, np.float64) / SY ** 2])
    return np.linalg.solve(lam, b), np.diag(lam)


def _local_params(rows=5, k=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, k)).astype(np.float32),
            (0.3 + rng.random((rows, k))).astype(np.float32))


def test_per_datapoint_matches_jax_on_injected_draws():
    loc, sd = _local_params()
    jq = javt.PerDatapointMeanField(jnp.asarray(loc), jnp.asarray(sd))
    tq = convert.per_datapoint_from_numpy(loc, sd, device=CPU)
    idx = np.array([3, 0, 4])
    jsub, tsub = jq.subsample(jnp.asarray(idx)), tq.subsample(torch.from_numpy(idx))
    assert tsub.weight == jsub.weight == 5 / 3
    for j, t in ((jq, tq), (jsub, tsub)):
        key = jax.random.key(1)
        z = j.sample(key, 9)
        u = jax.random.normal(key, (9, j.dim))
        assert_allclose(t.from_base(torch.from_numpy(np.array(u))).numpy(), np.asarray(z),
                        rtol=1e-5, atol=1e-6)
        zt = torch.from_numpy(np.array(z))
        assert_allclose(t.log_prob(zt).numpy(), np.asarray(j.log_prob(z)), rtol=1e-5)
        assert_allclose(float(t.entropy()), float(j.entropy()), rtol=1e-5)
        assert_allclose(t.mean().numpy(), np.asarray(j.mean()), rtol=1e-6)
        assert_allclose(t.var().numpy(), np.asarray(j.var()), rtol=1e-6)
        assert t.dim == t.base_dim == j.dim


def test_per_datapoint_draw_is_one_k7a_launch():
    loc, sd = _local_params()
    tq = convert.per_datapoint_from_numpy(loc, sd, device=CPU)
    z, u = tq.sample_with_base(PhiloxKey((1, 2), 3), 6)
    kz, ku = meanfield_sample_reference((1, 2), 3, tq.location.reshape(-1),
                                        tq.scale_diag.reshape(-1), 6)
    assert torch.equal(z, kz) and torch.equal(u, ku)
    assert torch.equal(tq.sample(PhiloxKey((1, 2), 3), 6), z)


def _global_local_pair(global_kind="meanfield"):
    loc, sd = _local_params()
    g_loc = np.array([0.3, -0.2], np.float32)
    if global_kind == "meanfield":
        g_scale = np.array([0.7, 1.2], np.float32)
        jg = javt.MeanFieldGaussian(jnp.asarray(g_loc), jnp.asarray(g_scale))
    else:
        g_scale = np.array([[0.9, 0.0], [0.3, 1.1]], np.float32)
        jg = javt.FullRankGaussian(jnp.asarray(g_loc), jnp.asarray(g_scale))
    jq = javt.GlobalLocalFamily(jg, javt.PerDatapointMeanField(jnp.asarray(loc), jnp.asarray(sd)))
    return jq, convert.global_local_from_numpy(g_loc, g_scale, loc, sd, device=CPU)


def _jax_global_local_u(jq, key, n):
    kg, kl = jax.random.split(key)
    return np.concatenate([np.array(jax.random.normal(kg, (n, jq.global_q.dim))),
                           np.array(jax.random.normal(kl, (n, jq.local_q.dim)))], axis=1)


@pytest.mark.parametrize("global_kind", ["meanfield", "fullrank"])
def test_global_local_matches_jax_on_injected_draws(global_kind):
    jq, tq = _global_local_pair(global_kind)
    key = jax.random.key(6)
    z = jq.sample(key, 11)
    tz = tq.from_base(torch.from_numpy(_jax_global_local_u(jq, key, 11)))
    assert_allclose(tz.numpy(), np.asarray(z), rtol=1e-5, atol=1e-6)
    zt = torch.from_numpy(np.array(z))
    assert_allclose(tq.log_prob(zt).numpy(), np.asarray(jq.log_prob(z)), rtol=1e-5)
    for name in ("entropy", "mean", "var"):
        assert_allclose(np.asarray(getattr(tq, name)()), np.asarray(getattr(jq, name)()),
                        rtol=1e-5)
    idx = np.array([1, 2])
    jsub, tsub = jq.subsample(jnp.asarray(idx)), tq.subsample(torch.from_numpy(idx))
    assert tsub.weight == jsub.weight == 2.5 and tsub.dim == jsub.dim == 6
    assert_allclose(float(tsub.entropy()), float(jsub.entropy()), rtol=1e-5)


def test_global_and_local_parts_draw_under_their_own_sub_keys():
    """Part i draws under split_seed_words(seed, i) at the key's iteration:
    the two u blocks are K7a's draws for those keys, and no column of the
    global u equals the same column of the local u (one shared key would
    make the first dg columns equal)."""
    _, tq = _global_local_pair()
    key = PhiloxKey((11, 12), 4)
    z, u = tq.sample_with_base(key, 64)
    _, ug = meanfield_sample_reference(split_seed_words((11, 12), 0), 4,
                                       tq.global_q.location, tq.global_q.scale_diag, 64)
    _, ul = meanfield_sample_reference(split_seed_words((11, 12), 1), 4,
                                       tq.local_q.location.reshape(-1),
                                       tq.local_q.scale_diag.reshape(-1), 64)
    assert torch.equal(u, torch.cat([ug, ul], dim=1))
    assert torch.equal(z, tq.from_base(u)) and torch.equal(tq.sample(key, 64), z)
    dg = tq.global_q.dim
    assert not (u[:, :dg] == u[:, dg:2 * dg]).any(dim=0).any()
    assert split_seed_words((11, 12), 0) != split_seed_words((11, 12), 1)


def test_operators_match_jax():
    """ClipScale clips both parts of a global-local family; the entropy prox
    takes the per-datapoint family and refuses the product, as JAX's."""
    loc, sd = _local_params()
    sd[1, 0] = -1.0
    g_loc, g_sd = np.array([0.3, -0.2], np.float32), np.array([1e-7, 1.2], np.float32)
    jq = javt.GlobalLocalFamily(javt.MeanFieldGaussian(jnp.asarray(g_loc), jnp.asarray(g_sd)),
                                javt.PerDatapointMeanField(jnp.asarray(loc), jnp.asarray(sd)))
    tq = convert.global_local_from_numpy(g_loc, g_sd, loc, sd, device=CPU)
    jc, tc = javt.ClipScale().apply(jq, None), avt.ClipScale().apply(tq, None)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=0)
    jp = javt.ProximalLocationScaleEntropy().apply(jq.local_q, javt.descent(0.1).init(jq.local_q))
    tp = avt.ProximalLocationScaleEntropy().apply(tq.local_q, avt.descent(0.1).init(tq.local_q))
    assert_allclose(tp.scale_diag.numpy(), np.asarray(jp.scale_diag), rtol=1e-6)
    with pytest.raises(TypeError, match="only supports location-scale"):
        avt.ProximalLocationScaleEntropy().apply(tq, avt.descent(0.1).init(tq))


def test_twenty_subsampled_steps_match_jax():
    """Random-effects model, N = 48, B = 12: KLMinRepGradDescent (STL, 16
    draws, Adam(2e-2), ClipScale, polynomial averaging) on a global-local
    family, 20 steps through epoch boundaries with JAX's permutations and
    JAX's draws (the global and local blocks under JAX's split) injected."""
    y = _y()
    jt, tt = _jax_random_effects_target(y), random_effects_target(y)
    jq0 = javt.GlobalLocalFamily(javt.MeanFieldGaussian(jnp.zeros(1)),
                                 javt.per_datapoint_meanfield(N, scale=0.5))
    tq0 = avt.GlobalLocalFamily(avt.MeanFieldGaussian(torch.zeros(1)),
                                avt.per_datapoint_meanfield(N, scale=0.5, device=CPU))
    kw = dict(entropy="stl", n_samples=16)
    jalg = javt.KLMinRepGradDescent(optimizer=optax.adam(2e-2), operator=javt.ClipScale(),
                                    subsampling=javt.ReshufflingBatchSubsampling(N, 12), **kw)
    talg = avt.KLMinRepGradDescent(optimizer=avt.adam(2e-2), operator=avt.ClipScale(),
                                   subsampling=avt.ReshufflingBatchSubsampling(N, 12), **kw)
    js, ts = jalg.init(jax.random.key(0), jq0, jt), talg.init(0, tq0, tt)
    step = jax.jit(jalg.step)
    for _ in range(20):
        sched = js.obj_state
        if int(sched.step) == 0:
            ts = dataclasses.replace(ts, obj_state=convert.reshuffling_state_from_numpy(
                sched.perm, int(sched.epoch), 0, device=CPU))
        sub = js.q.subsample(jnp.arange(12))
        u = _jax_global_local_u(sub, jax.random.fold_in(js.key, js.iteration), 16)
        js, jinfo = step(js)
        ts, tinfo = talg.step(ts, noise=torch.from_numpy(u))
        assert (tinfo["epoch"], tinfo["step"]) == (int(jinfo["epoch"]), int(jinfo["step"]))
        assert_allclose(float(tinfo["elbo"]), float(jinfo["elbo"]), rtol=1e-4, atol=1e-4)
    assert tinfo["epoch"] == 5
    tol = dict(rtol=1e-5, atol=1e-6)

    def close(t, j, **k):
        jl, tl = jax.tree.leaves(j), tree_leaves(t)
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            assert_allclose(a.detach().numpy(), np.asarray(b), **k)

    close(ts.q, js.q, **tol)
    close(talg.output(ts), jalg.output(js), **tol)
    close(ts.opt_state.mu, js.opt_state[0].mu, **tol)
    close(ts.opt_state.nu, js.opt_state[0].nu, rtol=5e-5, atol=1e-9)


def test_resumed_run_is_bitwise_the_uninterrupted_one():
    """The sub-keys depend on (seed words, iteration) alone: 10 steps equal
    6 then 4 from the warm state, chunked or not."""
    y = _y()
    tt = random_effects_target(y)
    q0 = avt.GlobalLocalFamily(avt.MeanFieldGaussian(torch.zeros(1)),
                               avt.per_datapoint_meanfield(N, scale=0.5, device=CPU))
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=4, optimizer=avt.adam(2e-2),
                                  operator=avt.ClipScale(),
                                  subsampling=avt.ReshufflingBatchSubsampling(N, 12))
    _, _, full = avt.optimize(3, alg, 10, tt, q0, chunk_size=3)
    _, _, part = avt.optimize(3, alg, 6, tt, q0)
    _, _, part = avt.optimize(None, alg, 4, tt, None, state=part)
    for a, b in zip(tree_leaves(full.q), tree_leaves(part.q)):
        assert torch.equal(a, b)


def _amortized(n=32):
    y = torch.from_numpy((1.0 + 1.5 * np.random.default_rng(7).standard_normal(n))
                         .astype(np.float32))
    target = avt.factorized_target(
        logprior_fn=lambda th: torch.zeros(th.shape[:-1]),
        loglike_fn=lambda th, data: torch.sum(-0.5 * th ** 2 - 0.5 * (data["y"] - th) ** 2,
                                              dim=-1),
        data={"y": y}, dim=n)
    return target, avt.per_datapoint_meanfield(n, k=1, scale=0.5, device=CPU), y


def test_subsample_weight_bookkeeping():
    _, q, _ = _amortized()
    idx = torch.tensor([3, 7, 11, 19])
    q_sub = q.subsample(idx)
    assert q_sub.location.shape == (4, 1) and q_sub.weight == 32 / 4
    sel = avt.PerDatapointMeanField(location=q.location[idx], scale_diag=q.scale_diag[idx])
    assert_allclose(float(q_sub.entropy()), 32 / 4 * float(sel.entropy()), rtol=1e-6)


def test_epoch_averaged_subsampled_grad_matches_full():
    """The mean of one reshuffled epoch's batch gradients is the full
    gradient, which lands in the full (N, k) tensors."""
    target, q, _ = _amortized()
    obj_full = avt.RepGradELBO(n_samples=8192, entropy=avt.CLOSED_FORM)
    g_full, _, _ = obj_full.value_and_grad(q, target, PhiloxKey((0, 0), 0))
    obj_sub = avt.SubsampledObjective(objective=avt.RepGradELBO(n_samples=8192,
                                                                entropy=avt.CLOSED_FORM),
                                      subsampling=avt.ReshufflingBatchSubsampling(32, 8))
    st = obj_sub.init(0, q, target)
    grads = []
    for i in range(4):
        g, st, _ = obj_sub.value_and_grad(q, target, PhiloxKey((0, 0), i), st)
        assert g.location.shape == (32, 1)
        grads.append(g)
    for name in ("location", "scale_diag"):
        avg = sum(getattr(g, name) for g in grads) / 4
        assert_allclose(avg.numpy(), getattr(g_full, name).numpy(), rtol=0.1, atol=0.1)


def test_subsampled_estimate_matches_full():
    target, q, _ = _amortized()
    full = float(avt.RepGradELBO(n_samples=4096, entropy=avt.CLOSED_FORM)
                 .estimate_objective(0, q, target))
    sub = avt.SubsampledObjective(objective=avt.RepGradELBO(n_samples=4096,
                                                            entropy=avt.CLOSED_FORM),
                                  subsampling=avt.ReshufflingBatchSubsampling(32, 8))
    assert_allclose(float(sub.estimate_objective(0, q, target)), full, rtol=0.05)


def test_amortized_doubly_stochastic_convergence():
    """Every local posterior N(y_i / 2, 1/2) is recovered (2,000 steps,
    JAX's 4,000, at JAX's bounds)."""
    target, q0, y = _amortized()
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=16, optimizer=avt.adam(5e-2),
                                  operator=avt.ClipScale(),
                                  subsampling=avt.ReshufflingBatchSubsampling(32, 8))
    q, infos, _ = avt.optimize(0, alg, 2000, target, q0, log_every=1000)
    assert_allclose(q.location[:, 0].numpy(), (y / 2.0).numpy(), atol=0.08)
    assert_allclose(q.scale_diag[:, 0].numpy(), np.full(32, math.sqrt(0.5)), rtol=0.15)
    assert np.isfinite(infos[-1]["elbo"])


def test_random_effects_fit_matches_exact_posterior():
    """tests/test_ppl_local.py's doubly-stochastic fit (N = 48, B = 12, 16
    draws, Adam(2e-2), ClipScale) on the hand-written target, 2,000 steps
    (JAX's 6,000): every mean within 0.08 of the exact posterior mean, every
    sd within rtol 0.2 of Lambda_ii^-1/2, the global sd included."""
    y = _y()
    q0 = avt.GlobalLocalFamily(avt.MeanFieldGaussian(torch.zeros(1)),
                               avt.per_datapoint_meanfield(N, scale=0.1, device=CPU))
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=16, optimizer=avt.adam(2e-2),
                                  operator=avt.ClipScale(),
                                  subsampling=avt.ReshufflingBatchSubsampling(N, 12))
    q, infos, _ = avt.optimize(0, alg, 2000, random_effects_target(y), q0, log_every=1000)
    assert np.isfinite(infos[-1]["elbo"])
    mean, prec = exact_posterior(y)
    got_mean = torch.cat([q.global_q.location, q.local_q.location[:, 0]]).numpy()
    got_sd = torch.cat([q.global_q.scale_diag, q.local_q.scale_diag[:, 0]]).numpy()
    assert_allclose(got_mean, mean, atol=0.08)
    assert_allclose(got_sd, prec ** -0.5, rtol=0.2)


def _refusal(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("family", ["per_datapoint", "global_local"])
def test_weighted_families_refused_word_for_word(family):
    """ScoreGradELBO and IWELBO refuse a subsampled (weighted) family with
    JAX's messages; the full family (weight 1) is accepted."""
    y = _y()
    jt, tt = _jax_random_effects_target(y), random_effects_target(y)
    if family == "per_datapoint":
        jq = javt.per_datapoint_meanfield(N)
        tq = avt.per_datapoint_meanfield(N, device=CPU)
    else:
        jq = javt.GlobalLocalFamily(javt.MeanFieldGaussian(jnp.zeros(1)),
                                    javt.per_datapoint_meanfield(N))
        tq = avt.GlobalLocalFamily(avt.MeanFieldGaussian(torch.zeros(1)),
                                   avt.per_datapoint_meanfield(N, device=CPU))
    jsub, tsub = jq.subsample(jnp.arange(8)), tq.subsample(torch.arange(8))
    assert tsub.weight == jsub.weight == N / 8
    key = jax.random.key(0)
    jmsg = _refusal(lambda: javt.ScoreGradELBO(n_samples=4).loss(jsub, jt.subsample(
        jnp.arange(8)), key))
    tmsg = _refusal(lambda: avt.ScoreGradELBO(n_samples=4).loss_and_elbo(
        tsub, tt.subsample(torch.arange(8)), 0))
    assert tmsg == jmsg and "RepGradELBO" in tmsg
    jmsg = _refusal(lambda: javt.IWELBO(n_samples=4).init(key, jsub, jt))
    tmsg = _refusal(lambda: avt.IWELBO(n_samples=4).init(0, tsub, tt))
    assert tmsg == jmsg
    if family == "per_datapoint":
        target, q, _ = _amortized()
        assert np.isfinite(float(avt.ScoreGradELBO(n_samples=4).loss_and_elbo(q, target, 0)[0]))
