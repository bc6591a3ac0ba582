"""Port parity: the importance-weighted ELBO (objectives/iwelbo.py, DReG and
plain IWAE gradients) and ``KLMinIWRepGradDescent`` against the JAX package
(its tests/test_iwelbo.py), with JAX's draws injected as noise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.models.normal import normal_meanfield
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import PhiloxKey, seed_words

torch.set_num_threads(1)

D = 4


@pytest.fixture(scope="module")
def targets():
    jt, mu, L = jax_normal_fullrank(jax.random.key(3), D)
    return jt, convert.normal_target_from_numpy(mu, L, device="cpu")


def _pair(qtype, solve_mode="solve"):
    rng = np.random.default_rng(2)
    loc = (0.3 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    if qtype == "meanfield":
        sd = (0.7 + 0.5 * rng.random(D)).astype(np.float32)
        return (javt.MeanFieldGaussian(jnp.asarray(loc), jnp.asarray(sd)),
                convert.meanfield_from_numpy(loc, sd, device="cpu"))
    C = (np.tril(0.2 * rng.standard_normal((D, D)), -1) + np.diag(0.7 + 0.5 * rng.random(D))
         ).astype(np.float32)
    return (javt.FullRankGaussian(jnp.asarray(loc), jnp.asarray(C)),
            convert.fullrank_from_numpy(loc, C, solve_mode=solve_mode, device="cpu"))


def _scale(q):
    return q.scale_diag if hasattr(q, "scale_diag") else q.scale


@pytest.mark.parametrize("qtype", ["meanfield", "fullrank"])
def test_k1_is_the_elbo(targets, qtype):
    """IW-ELBO_1 is the ELBO on the same draw, and the k = 1 DReG gradient is
    the STL ELBO's."""
    _, tt = targets
    _, q = _pair(qtype)
    key = PhiloxKey(seed_words(5), 2)
    iw = avt.IWELBO(n_samples=1).estimate_objective(key, q, tt)
    elbo = avt.RepGradELBO(n_samples=1, entropy=avt.MONTE_CARLO).estimate_objective(key, q, tt)
    assert_allclose(float(iw), float(elbo), rtol=1e-6)
    g_iw, _, i_iw = avt.IWELBO(n_samples=1).value_and_grad(q, tt, key)
    g_stl, _, i_stl = avt.RepGradELBO(n_samples=1, entropy=avt.STL,
                                      fast_entropy=False).value_and_grad(q, tt, key)
    assert_allclose(float(i_iw["elbo"]), float(i_stl["elbo"]), rtol=1e-6)
    for a, b in ((g_iw.location, g_stl.location), (_scale(g_iw), _scale(g_stl))):
        assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("dreg", [True, False])
@pytest.mark.parametrize("family", ["meanfield", "fullrank-solve", "fullrank-pallas",
                                    "fullrank-inverse"])
def test_loss_and_grad_match_jax(targets, family, dreg, k):
    """Surrogate loss, IW bound and gradient against JAX's on JAX's draws
    (loss and bound rtol 1e-5, gradient rtol 1e-4 / atol 1e-6); the
    full-rank density through every solve mode (K8's plain version under
    "pallas")."""
    jt, tt = targets
    qtype, _, mode = family.partition("-")
    jq, tq = _pair(qtype, mode or "solve")
    key = jax.random.key(17)
    _, u = jq.sample_with_base(key, k)
    jobj = javt.IWELBO(n_samples=k, dreg=dreg)
    (jloss, jinfo), jgrad = jax.value_and_grad(
        lambda q: jobj._loss_and_aux(q, jt, key), has_aux=True)(jq)
    obj = avt.IWELBO(n_samples=k, dreg=dreg)
    noise = torch.from_numpy(np.array(u))
    grad, _, info = obj.value_and_grad(tq, tt, None, noise=noise)
    loss = obj.loss(tq, tt, None, noise=noise)
    assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert_allclose(float(info["elbo"]), float(jinfo["elbo"]), rtol=1e-5, atol=1e-6)
    assert not info["elbo"].requires_grad
    assert_allclose(grad.location.numpy(), np.asarray(jgrad.location), rtol=1e-4, atol=1e-6)
    assert_allclose(_scale(grad).numpy(), np.asarray(_scale(jgrad)), rtol=1e-4, atol=1e-6)


def test_bound_is_monotone_in_k_and_dreg_agrees_with_plain():
    """Burda et al.: the mean IW bound does not decrease in k = 1, 8, 64
    (within 3 standard errors, 512 replicates), stays below log Z = 0; and
    the DReG and plain IWAE gradient means agree within 3 joint standard
    errors (both are unbiased for the same gradient)."""
    tt, mu, L = normal_meanfield(3, D, device="cpu")
    q = avt.MeanFieldGaussian(mu + 0.5, 2.0 * torch.diagonal(L))
    reps = [PhiloxKey(seed_words(7), i) for i in range(512)]
    means = []
    for k in (1, 8, 64):
        b = torch.stack([-avt.IWELBO(n_samples=k).estimate_objective(r, q, tt) for r in reps])
        means.append((float(b.mean()), float(b.std() / len(reps) ** 0.5)))
    for (m0, s0), (m1, s1) in zip(means, means[1:]):
        assert m1 > m0 - 3.0 * (s0 * s0 + s1 * s1) ** 0.5, means
    assert means[-1][0] < 3.0 * means[-1][1], means
    q2 = avt.MeanFieldGaussian(mu + 0.3, 1.3 * torch.diagonal(L))

    def grads(dreg):
        obj = avt.IWELBO(n_samples=8, dreg=dreg)
        return torch.stack([torch.cat([g.location, g.scale_diag]) for g in
                            (obj.value_and_grad(q2, tt, r)[0] for r in reps)])

    gd, gp = grads(True), grads(False)
    se = ((gd.var(0) + gp.var(0)) / len(reps)).sqrt()
    assert bool(((gd.mean(0) - gp.mean(0)).abs() < 3.0 * se + 1e-4).all())


def _jax_run(jtarget, jq0, steps, k, dreg):
    alg = javt.KLMinIWRepGradDescent(n_samples=k, dreg=dreg, optimizer=javt.dowg(1e-2),
                                     operator=javt.ClipScale())
    state = alg.init(jax.random.key(0), jq0, jtarget)
    step = jax.jit(alg.step)
    draws, infos = [], []
    for _ in range(steps):
        _, u = state.q.sample_with_base(jax.random.fold_in(state.key, state.iteration), k)
        draws.append(np.array(u))
        state, info = step(state)
        infos.append(float(info["elbo"]))
    return alg, state, draws, infos


@pytest.mark.parametrize("dreg", [True, False])
@pytest.mark.parametrize("family", ["meanfield", "fullrank-pallas"])
def test_iw_algorithm_twenty_steps_match_jax(targets, family, dreg):
    """KLMinIWRepGradDescent (DoWG, r0 scale 1e-2, polynomial averaging,
    ClipScale), k = 8: 20 steps on JAX's injected draws.  Each step's bound
    within 1e-4; parameters and averages within rtol 1e-5 after 5 steps (as
    the port's other DoWG parity tests) and within 1e-3 after 20: DoWG's
    step grows with the distance travelled, and by step 20 the DReG runs
    carry float32 rounding of the weights up to ~1e-4 of the parameters'
    size (the per-step gradient is held at rtol 1e-4 above)."""
    jt, tt = targets
    qtype, _, mode = family.partition("-")
    jq0, tq0 = _pair(qtype, mode or "solve")
    alg = avt.KLMinIWRepGradDescent(n_samples=8, dreg=dreg, optimizer=avt.dowg(1e-2),
                                    operator=avt.ClipScale())
    for steps, tol in ((5, dict(rtol=1e-5, atol=1e-6)), (20, dict(rtol=1e-3, atol=1e-3))):
        jalg, js, draws, jinfos = _jax_run(jt, jq0, steps, 8, dreg)
        st = alg.init(0, tq0, tt)
        for u, je in zip(draws, jinfos):
            st, info = alg.step(st, noise=torch.from_numpy(u))
            assert_allclose(float(info["elbo"]), je, rtol=1e-4, atol=1e-4)
        assert_allclose(st.q.location.numpy(), np.asarray(js.q.location), **tol)
        want = np.asarray(_scale(js.q))
        assert_allclose(_scale(st.q).numpy(), want if qtype == "meanfield" else np.tril(want),
                        **tol)
        tout, jout = alg.output(st), jalg.output(js)
        assert_allclose(tout.location.numpy(), np.asarray(jout.location), **tol)


@dataclasses.dataclass(frozen=True)
class NoDensity:
    """A family with parameters but no log_prob (as the JAX flows)."""

    location: torch.Tensor = dataclasses.field(default_factory=lambda: torch.zeros(2))


class Weighted:
    weight = 0.5

    def log_prob(self, z):
        return z.sum(-1)


@pytest.mark.parametrize("family", [NoDensity, Weighted])
def test_family_refusals_match_jax_word_for_word(family):
    q = family()
    with pytest.raises(ValueError) as jerr:
        javt.IWELBO._check_family(q)
    with pytest.raises(ValueError) as terr:
        avt.IWELBO(n_samples=4).init(0, q, None)
    assert str(terr.value) == str(jerr.value)


def test_the_check_fires_under_subsampling_and_mc_axis_is_refused():
    """SubsampledObjective.init runs IWELBO's check; a subsampled IW run on a
    factorized target takes finite steps."""
    y = torch.linspace(-1.0, 1.0, 16)
    target = avt.factorized_target(
        logprior_fn=lambda th: -0.5 * (th * th).sum(-1),
        loglike_fn=lambda th, data: -0.5 * ((data["y"] - th[..., :1]) ** 2).sum(-1),
        data={"y": y}, dim=2)
    alg = avt.KLMinIWRepGradDescent(
        n_samples=4, operator=avt.ClipScale(),
        subsampling=avt.ReshufflingBatchSubsampling(n_data=16, batchsize=4))
    with pytest.raises(ValueError, match="log_prob"):
        alg.init(0, NoDensity(), target)
    q, infos, _ = avt.optimize(0, alg, 8, target, avt.MeanFieldGaussian(torch.zeros(2)))
    assert all(np.isfinite(r["elbo"]) for r in infos)
    # mc_axis is taken (sharded in tests/test_torch_multiprocess.py); outside
    # a mesh the run is the one without it
    sharded = avt.KLMinIWRepGradDescent(
        n_samples=4, operator=avt.ClipScale(), mc_axis="mc",
        subsampling=avt.ReshufflingBatchSubsampling(n_data=16, batchsize=4))
    assert sharded.objective.objective.mc_axis == "mc"
    q2, infos2, _ = avt.optimize(0, sharded, 8, target, avt.MeanFieldGaussian(torch.zeros(2)))
    assert infos2 == infos and torch.equal(q2.location, q.location)
