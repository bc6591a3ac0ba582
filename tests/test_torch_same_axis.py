"""A target's data on the mesh axis that splits the estimate's terms
(parallel/mesh.py ``data_split``): the objective's ``mc_axis`` or a
mixture's ``ep_axis`` is also the target's ``data_axis``.  Four gloo CPU
ranks run every scenario below on the meshes (data x mc) = (1, 4) and
(2, 2), with the data and the terms on "mc", and (4, 1), with both on
"data"; the tests hold rank 0's results against the same scenario run here
in one process without a mesh at the JAX package's tests/test_parallel.py
bars (rtol 1e-5, atol 1e-6), every rank's against rank 0's bit for bit,
and a mesh of one rank against the run without a mesh bit for bit.

The scenarios: one gradient estimate of each objective (RepGradELBO with
its closed-form and STL entropies, the entropy without the fast path,
antithetic and ``remat``; ScoreGradELBO; IWELBO with and without DReG;
SubsampledObjective around RepGradELBO and IWELBO; MixtureELBO with
``ep_axis``), one step of each measure-space algorithm (NGD with Stein and
exact Hessians, sqrt-NGD, Wasserstein, BaM), and ``optimize(mesh=)`` runs.
Two scenarios are held against the JAX package on its 8-device CPU mesh
with the data and the draws on "mc", on the same numpy data and JAX's draws
(written by the fixture to ``inputs/jax.npz`` and injected as ``noise``):
``LogReg(data_axis="mc")`` under ``RepGradELBO(mc_axis="mc")``, and one NGD
step.

The ranks are this file run as a script (``__main__`` below), launched once
by a module-scoped fixture through ``torch_ranks.run_ranks``:
``python tests/test_torch_same_axis.py RANK WORLD PORT OUTDIR``; each writes ``rank<R>.pt``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu_torch.models.logreg import LogReg, make_logreg
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import PhiloxKey
from torch_ranks import close, equal, leaves, run_ranks, under

WORLD = 4
MESHES = ((1, 4), (2, 2), (4, 1))  # (n_data, n_mc)
MC, DATA = avt.MC_AXIS, avt.DATA_AXIS
# the axis of each mesh that holds both the data and the terms: the larger
AXIS = {(1, 4): MC, (2, 2): MC, (4, 1): DATA}
TIMEOUT = 300
D_FEATURES, N_ROWS = 6, 41  # d = 7; 41 rows: 11, 10, 10, 10 over four ranks


# ---------------------------------------------------------------------------
# Scenarios: every rank runs them under a mesh, the tests without one
# ---------------------------------------------------------------------------


def target(axis):
    """The unconstrained logistic regression with its rows over ``axis``."""
    return make_logreg(11, n_data=N_ROWS, n_features=D_FEATURES, data_axis=axis,
                       device="cpu").unconstrained()


def families(d):
    """The families the objectives start from, away from the origin."""
    from advancedvi_jl_tpu_torch import convert

    rng = np.random.default_rng(d)
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    loc = f32(0.1 * rng.standard_normal(d))
    C = f32(0.3 * np.eye(d) + np.tril(0.05 * rng.standard_normal((d, d)), -1))
    K = 6  # components: 2, 2, 1, 1 over four ranks
    return {"meanfield": convert.meanfield_from_numpy(loc, f32(0.2 + 0.2 * rng.random(d)),
                                                      device="cpu"),
            "fullrank": convert.fullrank_from_numpy(loc, C, device="cpu"),
            "mixture": convert.mixture_meanfield_from_numpy(
                f32(0.3 * rng.standard_normal(K)), f32(0.3 * rng.standard_normal((K, d))),
                f32(0.2 + 0.2 * rng.random((K, d))), device="cpu")}


def objective_cases(axis):
    """(objective, family) of each case, its terms over ``axis``."""
    sub = avt.ReshufflingBatchSubsampling(n_data=N_ROWS, batchsize=16)
    return {
        "repgrad": (avt.RepGradELBO(n_samples=16, mc_axis=axis), "fullrank"),
        # 10 draws over 4 ranks: 3, 3, 2, 2 rows
        "repgrad_stl": (avt.RepGradELBO(n_samples=10, entropy=avt.STL, mc_axis=axis),
                        "meanfield"),
        "repgrad_no_fast_entropy": (avt.RepGradELBO(n_samples=10, entropy=avt.STL,
                                                    fast_entropy=False, mc_axis=axis),
                                    "fullrank"),
        # a rank's mirrored rows come from base rows another rank draws too
        "repgrad_antithetic": (avt.RepGradELBO(n_samples=12, entropy=avt.STL, antithetic=True,
                                               mc_axis=axis), "fullrank"),
        "repgrad_remat": (avt.RepGradELBO(n_samples=16, entropy=avt.STL, remat=True,
                                          mc_axis=axis), "meanfield"),
        "scoregrad": (avt.ScoreGradELBO(n_samples=16, mc_axis=axis), "meanfield"),
        "iwelbo_dreg": (avt.IWELBO(n_samples=16, mc_axis=axis), "meanfield"),
        "iwelbo_plain": (avt.IWELBO(n_samples=16, dreg=False, mc_axis=axis), "fullrank"),
        "subsampled_repgrad": (avt.SubsampledObjective(
            avt.RepGradELBO(n_samples=10, entropy=avt.STL, mc_axis=axis), sub), "meanfield"),
        "subsampled_iwelbo": (avt.SubsampledObjective(
            avt.IWELBO(n_samples=16, mc_axis=axis), sub), "meanfield"),
        "mixture": (avt.MixtureELBO(n_samples=8, ep_axis=axis), "mixture"),
    }


OBJECTIVE_CASES = list(objective_cases(MC))


def objectives(mesh, axis):
    """One gradient estimate of each objective case on the target whose rows
    are over ``axis``: its gradient leaves, then the ELBO (or the IW bound)."""
    prob = target(axis)
    fams = families(prob.dim)
    key = PhiloxKey((7, 11), 3)
    out = {}
    with under(mesh):
        for name, (obj, fam) in objective_cases(axis).items():
            q = fams[fam]
            grad, _, info = obj.value_and_grad(q, prob, key, obj.init(5, q, prob))
            out[name] = leaves(grad) + [info["elbo"].detach().clone()]
    return out


def measure_cases(axis):
    from advancedvi_jl_tpu_torch.algorithms import measure_space as ms

    return {
        "ngd_stein": ms.KLMinNaturalGradDescent(stepsize=0.05, n_samples=16, mc_axis=axis,
                                                hessian="stein"),
        # exact Hessians: a double backward through the target; 10 draws, uneven
        "ngd_exact": ms.KLMinNaturalGradDescent(stepsize=0.05, n_samples=10, mc_axis=axis,
                                                hessian="exact"),
        "sqrt_ngd": ms.KLMinSqrtNaturalGradDescent(stepsize=0.05, n_samples=16, mc_axis=axis),
        "wass": ms.KLMinWassFwdBwd(stepsize=0.05, n_samples=16, mc_axis=axis),
        "bam": ms.FisherMinBatchMatch(n_samples=16, mc_axis=axis),
    }


MEASURE_CASES = list(measure_cases(MC))


def measure_space(mesh, axis):
    """One step of each measure-space algorithm from N(0, 0.1^2 I) with its
    draws over ``axis``, on the target whose rows are over ``axis``: the
    location, the scale, the ELBO (and BaM's covariance-weighted Fisher)."""
    prob = target(axis)
    d = prob.dim
    out = {}
    for name, alg in measure_cases(axis).items():
        with under(mesh):
            st = alg.init(0, avt.FullRankGaussian(torch.zeros(d), 0.1 * torch.eye(d)), prob)
            st, info = alg.step(st)
        extra = [info["covweighted_fisher"]] if name == "bam" else []
        out[name] = [st.q.location, st.q.scale, info["elbo"]] + extra
    return out


def optimize_runs(mesh, axis):
    """``optimize(mesh=)`` on the target whose rows are over ``axis``: 30
    steps of mean-field ADVI (STL, Adam, ClipScale, averaging; 10 draws)
    and 5 NGD steps (16 draws), the draws over ``axis``."""
    from advancedvi_jl_tpu_torch.algorithms.measure_space import KLMinNaturalGradDescent

    prob = target(axis)
    d = prob.dim
    runs = {
        "advi": (avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=10, optimizer=avt.adam(1e-2),
                                         operator=avt.ClipScale(), mc_axis=axis),
                 avt.MeanFieldGaussian(torch.zeros(d), 0.1 * torch.ones(d)), 30),
        "ngd": (KLMinNaturalGradDescent(stepsize=0.05, n_samples=16, mc_axis=axis),
                avt.FullRankGaussian(torch.zeros(d), 0.1 * torch.eye(d)), 5),
    }
    out = {}
    for name, (alg, q0, steps) in runs.items():
        q, infos, _ = avt.optimize(0, alg, steps, prob, q0, mesh=mesh, log_every=steps)
        out[name] = leaves(q) + [torch.tensor(infos[-1]["elbo"])]
    return out


# the scenarios held against the JAX package: its data and draws on "mc"
JAX_N, JAX_ROWS, JAX_FEATURES = 16, 64, 6


def jax_data(seed=3):
    """Numpy data (X, y) of the logistic regression and the full-rank
    family's (location, factor), shared with the JAX package."""
    rng = np.random.default_rng(seed)
    X = (0.5 * rng.standard_normal((JAX_ROWS, JAX_FEATURES))).astype(np.float32)
    y = (rng.random(JAX_ROWS) < 0.5).astype(np.float32)
    d = JAX_FEATURES + 1
    loc = (0.1 * rng.standard_normal(d)).astype(np.float32)
    C = (0.3 * np.eye(d) + np.tril(0.05 * rng.standard_normal((d, d)), -1)).astype(np.float32)
    return X, y, loc, C


def jax_scenarios(mesh, axis, inputs):
    """RepGradELBO (STL) and one NGD step on the port's logistic regression
    of ``jax_data``, its rows and the draws over ``axis``, on JAX's draws:
    the gradient leaves and the ELBO; the location, scale and ELBO."""
    from advancedvi_jl_tpu_torch import convert
    from advancedvi_jl_tpu_torch.algorithms.measure_space import KLMinNaturalGradDescent

    X, y, loc, C = jax_data()
    prob = LogReg(torch.from_numpy(X), torch.from_numpy(y), torch.ones(()),
                  data_axis=axis).unconstrained()
    d = prob.dim
    q = convert.fullrank_from_numpy(loc, C, device="cpu")
    obj = avt.RepGradELBO(n_samples=JAX_N, entropy=avt.STL, mc_axis=axis)
    alg = KLMinNaturalGradDescent(stepsize=0.05, n_samples=JAX_N, mc_axis=axis)
    with under(mesh):
        grad, _, info = obj.value_and_grad(q, prob, None, noise=torch.from_numpy(inputs["repgrad"]))
        st = alg.init(0, avt.FullRankGaussian(torch.zeros(d), 0.1 * torch.eye(d)), prob)
        st, step_info = alg.step(st, noise=torch.from_numpy(inputs["ngd"]))
    return {"repgrad": leaves(grad) + [info["elbo"].detach().clone()],
            "ngd": [st.q.location, st.q.scale, step_info["elbo"]]}


SCENARIOS = {"objectives": objectives, "measure_space": measure_space,
             "optimize": optimize_runs}


# ---------------------------------------------------------------------------
# The rank's program
# ---------------------------------------------------------------------------


def rank_main(rank: int, world: int, port: int, outdir: str) -> None:
    import torch.distributed as dist

    from advancedvi_jl_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    with np.load(os.path.join(outdir, "inputs", "jax.npz")) as f:
        inputs = dict(f)
    distributed.initialize(f"localhost:{port}", world, rank, backend="gloo")
    results = {}
    for shape in MESHES:
        mesh = avt.make_vi_mesh(n_mc=shape[1], n_data=shape[0])
        for name, fn in SCENARIOS.items():
            results[(name, shape)] = fn(mesh, AXIS[shape])
        results[("jax", shape)] = jax_scenarios(mesh, AXIS[shape], inputs)
    torch.save(results, os.path.join(outdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

JAX_KEY = 17


def _jax_problem():
    """The JAX package's (target with its rows over "mc", family, NGD and
    its initial state) on ``jax_data``."""
    import jax
    import jax.numpy as jnp

    import advancedvi_jl_tpu as javt
    from advancedvi_jl_tpu.algorithms.measure_space import KLMinNaturalGradDescent
    from advancedvi_jl_tpu.models.logreg import LogReg as JaxLogReg

    X, y, loc, C = jax_data()
    prob = JaxLogReg(jnp.asarray(X), jnp.asarray(y), jnp.ones(()), data_axis="mc").unconstrained()
    d = JAX_FEATURES + 1
    q = javt.FullRankGaussian(jnp.asarray(loc), jnp.asarray(C))
    alg = KLMinNaturalGradDescent(stepsize=0.05, n_samples=JAX_N, mc_axis="mc")
    state = alg.init(jax.random.key(5), javt.FullRankGaussian(jnp.zeros(d), 0.1 * jnp.eye(d)),
                     prob)
    return prob, q, alg, state


def write_jax_inputs(outdir):
    """JAX's base draws for its RepGradELBO (``JAX_KEY``) and for its NGD
    step (its own key schedule), to OUTDIR/inputs/jax.npz (one device: with
    partitionable threefry they are the sharded draws too)."""
    import jax
    import jax.numpy as jnp

    _, q, alg, state = _jax_problem()
    key = jax.random.fold_in(state.key, state.iteration)
    out = {"repgrad": np.asarray(q.sample_with_base(jax.random.key(JAX_KEY), JAX_N)[1]),
           "ngd": np.asarray(state.q.base.sample(key, (JAX_N, state.q.dim), jnp.float32))}
    os.makedirs(os.path.join(outdir, "inputs"))
    np.savez(os.path.join(outdir, "inputs", "jax.npz"), **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks once; their results, in rank order, and the
    inputs they read."""
    outdir = str(tmp_path_factory.mktemp("torch_same_axis"))
    write_jax_inputs(outdir)
    results = run_ranks(__file__, WORLD, outdir, TIMEOUT)
    with np.load(os.path.join(outdir, "inputs", "jax.npz")) as f:
        inputs = dict(f)
    return results, inputs


@pytest.fixture(scope="module")
def reference():
    """Every scenario in this process, without a mesh."""
    return {name: fn(None, MC) for name, fn in SCENARIOS.items()}


def test_every_rank_returns_the_same_bits(ranks):
    """Replicated outputs: each rank's results equal rank 0's exactly."""
    results, _ = ranks
    for r in range(1, WORLD):
        equal(results[r], results[0])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", OBJECTIVE_CASES)
def test_objective_on_its_data_axis_equals_one_process(ranks, reference, shape, case):
    """The gradient and the ELBO (IW bound) with the draws (a mixture's
    components) and the target's rows on one axis equal the one-process
    estimate (JAX: rtol 1e-5, atol 1e-6)."""
    close(ranks[0][0][("objectives", shape)][case], reference["objectives"][case],
          rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", MEASURE_CASES)
def test_measure_space_step_on_its_data_axis_equals_one_process(ranks, reference, shape, case):
    """One measure-space step with the draws and the target's rows on one
    axis: the location, the scale and the ELBO of the one-process step (a
    sum over that axis of the ranks' likelihoods would add up different
    draws' likelihoods)."""
    close(ranks[0][0][("measure_space", shape)][case], reference["measure_space"][case],
          rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", ["advi", "ngd"])
def test_optimize_on_its_data_axis_equals_one_process(ranks, reference, shape, case):
    """``optimize(mesh=)`` with the draws and the target's rows on one axis:
    the family and the last ELBO of the one-process run."""
    close(ranks[0][0][("optimize", shape)][case], reference["optimize"][case],
          rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A mesh of one gloo rank in this process (a group of one on a free
    localhost port), taken down afterwards."""
    import torch.distributed as dist

    from advancedvi_jl_tpu_torch.parallel import distributed

    made = not dist.is_initialized()
    distributed.initialize(backend="gloo")
    yield avt.make_vi_mesh()
    if made:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_one_rank_mesh_is_bitwise_no_mesh(one_rank_mesh, reference, name):
    """Every scenario on a (1 x 1) mesh, its data and terms on "mc": bit for
    bit the run without a mesh."""
    equal(SCENARIOS[name](one_rank_mesh, MC), reference[name])


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's RepGradELBO and NGD step with the target's rows and
    the draws on "mc" of its 8-device mesh: the gradient leaves and ELBO;
    the location, scale and ELBO."""
    import jax

    from advancedvi_jl_tpu.parallel.mesh import make_vi_mesh as jax_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    import advancedvi_jl_tpu as javt

    prob, q, alg, state = _jax_problem()
    obj = javt.RepGradELBO(n_samples=JAX_N, entropy="stl", mc_axis="mc")
    key = jax.random.key(JAX_KEY)
    with jax.set_mesh(jax_mesh(n_mc=8)):
        grad, _, info = jax.jit(lambda q: obj.value_and_grad(q, prob, key))(q)
        st, step_info = jax.jit(alg.step)(state)
    return {"repgrad": [np.asarray(g) for g in jax.tree.leaves(grad)]
            + [np.asarray(info["elbo"])],
            "ngd": [np.asarray(st.q.location), np.asarray(st.q.scale),
                    np.asarray(step_info["elbo"])]}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", ["repgrad", "ngd"])
def test_same_axis_matches_jax(ranks, jax_sharded, shape, case):
    """The port's 4 ranks with the target's rows and the draws on one axis
    against the JAX package's ``LogReg(data_axis="mc")`` with its draws on
    "mc" of its 8-device mesh, on the same data, family and draws: rtol
    1e-5, atol 1e-5."""
    got = ranks[0][0][("jax", shape)][case]
    want = jax_sharded[case]
    if case == "ngd":  # the port keeps the factor's upper triangle at zero as JAX's tril
        got = [got[0], torch.tril(got[1]), got[2]]
        want = [want[0], np.tril(want[1]), want[2]]
    close(got, want, rtol=1e-5, atol=1e-5)
