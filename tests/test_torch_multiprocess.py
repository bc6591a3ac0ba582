"""The port's device mesh over several processes (parallel/mesh.py,
parallel/distributed.py): four gloo CPU ranks run every scenario below on
the meshes (data x mc) = (1, 4), (2, 2) and (4, 1), and the tests hold each
rank's results against the same scenario run here in one process without a
mesh, at the tolerances of the JAX package's tests/test_parallel.py.  Two
scenarios are held against the JAX package on its 8-device CPU mesh: the
logistic regression's log density and gradient, sharded over "data"
(``make_logreg(data_axis="data")``), and RepGradELBO, ScoreGradELBO and
IWELBO (with and without DReG) with their draws over "mc", on JAX's draws
(written by the fixture to ``inputs/jax.npz`` and injected as ``noise``);
and a family's parameters over a mesh axis (the full-rank factor's rows
over ``tp_axis``, also in bfloat16 and composed with ``mc_axis``, the
block-diagonal family's blocks over ``block_axis``, a mixture's components
over ``MixtureELBO(ep_axis=)``), where each rank also records the share its
products formed (``shares<R>.pt``).

The ranks are this file run as a script (``__main__`` below), launched once
by a module-scoped fixture through ``torch_ranks.run_ranks``:
``python tests/test_torch_multiprocess.py RANK WORLD PORT OUTDIR``.  A rank reads OUTDIR/inputs/jax.npz, writes
``rank<R>.pt`` (its results), and rank 0 alone writes ``ckpt.npz`` (after
``sync_hosts``).
"""

import os
import sys

import numpy as np
import pytest
import torch

import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu_torch.models.logreg import LogReg, make_logreg
from advancedvi_jl_tpu_torch.models.normal import normal_fullrank
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import PhiloxKey
from torch_ranks import close, equal, leaves, run_ranks, under

WORLD = 4
MESHES = ((1, 4), (2, 2), (4, 1))  # (n_data, n_mc)
MC, DATA = avt.MC_AXIS, avt.DATA_AXIS
CHAINS = 32
TIMEOUT = 300


# ---------------------------------------------------------------------------
# Scenarios: every rank runs them under a mesh, the tests without one
# ---------------------------------------------------------------------------


def objectives(mesh):
    """One gradient estimate of each objective with ``mc_axis``: its
    gradient leaves, then the ELBO (or the IW bound)."""
    target, _, _ = normal_fullrank(3, 5, device="cpu")
    qf = avt.FullRankGaussian(torch.zeros(5))
    qm = avt.MeanFieldGaussian(torch.zeros(5), torch.ones(5))
    key = PhiloxKey((7, 11), 3)
    cases = {
        "repgrad": (avt.RepGradELBO(n_samples=64, entropy=avt.STL, mc_axis=MC), qf),
        # 10 draws over 4 ranks: 3, 3, 2, 2 rows
        "repgrad_uneven": (avt.RepGradELBO(n_samples=10, entropy=avt.STL, mc_axis=MC), qm),
        # a rank's mirrored rows come from base rows another rank draws too
        "repgrad_antithetic": (avt.RepGradELBO(n_samples=12, entropy=avt.STL, antithetic=True,
                                               mc_axis=MC), qf),
        "scoregrad": (avt.ScoreGradELBO(n_samples=64, mc_axis=MC), qm),
        "iwelbo_dreg": (avt.IWELBO(n_samples=64, mc_axis=MC), qm),
        "iwelbo_plain": (avt.IWELBO(n_samples=64, dreg=False, mc_axis=MC), qm),
    }
    out = {}
    with under(mesh):
        for name, (obj, q) in cases.items():
            grad, _, info = obj.value_and_grad(q, target, key)
            out[name] = leaves(grad) + [info["elbo"].detach().clone()]
    return out


# the objectives held against the JAX package's sharded ones: (objective
# keyword arguments, family) on JAX's draws
JAX_OBJECTIVES = {"repgrad": ("RepGradELBO", {"entropy": "stl"}, "fullrank"),
                  "scoregrad": ("ScoreGradELBO", {}, "meanfield"),
                  "iwelbo_dreg": ("IWELBO", {}, "meanfield"),
                  "iwelbo_plain": ("IWELBO", {"dreg": False}, "meanfield")}
JAX_D, JAX_N = 5, 64


def jax_pairs(seed=2):
    """Numpy location, scale diagonal and scale factor of the families
    that both packages build for the JAX comparison."""
    rng = np.random.default_rng(seed)
    loc = (0.3 + 0.2 * rng.standard_normal(JAX_D)).astype(np.float32)
    sd = (0.7 + 0.5 * rng.random(JAX_D)).astype(np.float32)
    C = (np.tril(0.2 * rng.standard_normal((JAX_D, JAX_D)), -1)
         + np.diag(0.7 + 0.5 * rng.random(JAX_D))).astype(np.float32)
    return loc, sd, C


def jax_objectives(mesh, inputs):
    """Each of JAX_OBJECTIVES with ``mc_axis`` on the target and the draws
    of ``inputs`` (inputs/jax.npz: mu, L and each case's base draws): its
    gradient leaves, then the ELBO (or the IW bound)."""
    from advancedvi_jl_tpu_torch import convert

    loc, sd, C = jax_pairs()
    target = convert.normal_target_from_numpy(inputs["mu"], inputs["L"], device="cpu")
    family = {"meanfield": convert.meanfield_from_numpy(loc, sd, device="cpu"),
              "fullrank": convert.fullrank_from_numpy(loc, C, device="cpu")}
    out = {}
    with under(mesh):
        for name, (cls, kw, fam) in JAX_OBJECTIVES.items():
            obj = getattr(avt, cls)(n_samples=JAX_N, mc_axis=MC, **kw)
            grad, _, info = obj.value_and_grad(family[fam], target, None,
                                               noise=torch.from_numpy(inputs[name]))
            out[name] = leaves(grad) + [info["elbo"].detach().clone()]
    return out


def measure_space(mesh):
    """One NGD step and one BaM step with ``mc_axis``."""
    from advancedvi_jl_tpu_torch.algorithms.measure_space import (
        FisherMinBatchMatch,
        KLMinNaturalGradDescent,
    )

    out = {}
    logreg = make_logreg(11, n_data=40, n_features=4, data_axis=DATA,
                         device="cpu").unconstrained()
    for name, alg, seed in (
            ("ngd", KLMinNaturalGradDescent(stepsize=0.05, n_samples=64, mc_axis=MC), 3),
            ("bam", FisherMinBatchMatch(n_samples=32, mc_axis=MC), 7),
            # exact Hessians (double backward through the data axis's sum)
            ("ngd_logreg", KLMinNaturalGradDescent(stepsize=0.05, n_samples=16, mc_axis=MC),
             None),
            ("bam_logreg", FisherMinBatchMatch(n_samples=16, mc_axis=MC), None)):
        target = logreg if seed is None else normal_fullrank(seed, 5, device="cpu")[0]
        d = target.dim
        with under(mesh):
            st = alg.init(0, avt.FullRankGaussian(torch.zeros(d), 0.1 * torch.eye(d)), target)
            st, info = alg.step(st)
        extra = [info["covweighted_fisher"]] if name.startswith("bam") else []
        out[name] = [st.q.location, st.q.scale, info["elbo"]] + extra
    return out


def optimize_runs(mesh, long_run=True):
    """Full-rank ADVI through ``optimize(mesh=)``: 50 steps (16 draws) and,
    with ``long_run``, 500 steps (8 draws) at d = 5; the state of the
    50-step run."""
    target, mu, _ = normal_fullrank(3, 5, device="cpu")
    q0 = avt.FullRankGaussian(torch.zeros(5))
    out = {"mu": mu}
    for steps, n in ((50, 16), (500, 8))[:2 if long_run else 1]:
        alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=n, operator=avt.ClipScale(),
                                      mc_axis=MC)
        q, infos, state = avt.optimize(0, alg, steps, target, q0, mesh=mesh, log_every=steps)
        out[steps] = [q.location, torch.tril(q.scale), torch.tensor(infos[-1]["elbo"])]
        if steps == 50:
            out["state"] = state
    return out


def subsampled_logreg(mesh):
    """Subsampled logistic regression with the rows over "data" and the
    draws over "mc", 200 steps (JAX's test_data_axis_sharded_logreg)."""
    target = make_logreg(11, n_data=64, n_features=7, data_axis=DATA,
                         device="cpu").unconstrained()
    q0 = avt.MeanFieldGaussian(torch.zeros(9), 0.1 * torch.ones(9))
    alg = avt.KLMinRepGradDescent(
        entropy=avt.STL, n_samples=8, operator=avt.ClipScale(),
        subsampling=avt.ReshufflingBatchSubsampling(n_data=64, batchsize=16), mc_axis=MC)
    q, infos, _ = avt.optimize(0, alg, 200, target, q0, mesh=mesh, log_every=200)
    return [q.location, q.scale_diag, torch.tensor(infos[-1]["elbo"]),
            torch.tensor(infos[-1]["epoch"])]


def chains_engine(n_chains=CHAINS, **kw):
    prob = make_logreg(5, n_data=24, n_features=5, device="cpu")
    return avt.FusedChainsADVI(avt.logreg_spec(prob.X, prob.y), n_chains=n_chains, **kw)


def chains(mesh):
    """32 chains of the fused chains engine (its plain version here) with a
    per-chain lr sweep, 20 steps traced every 5: ``run_sharded`` over "mc"
    under a mesh, ``run_chunk_traced`` without."""
    eng = chains_engine(lr=np.linspace(1e-3, 8e-3, CHAINS))
    g = torch.Generator().manual_seed(0)
    st = eng.init(0.5 * torch.randn(CHAINS, eng.dim, generator=g),
                  0.1 * torch.ones(CHAINS, eng.dim))
    if mesh is None:
        new, trace = eng.run_chunk_traced(st, 5, 20, 5)
    else:
        new, trace = eng.run_sharded(st, 5, 20, mesh, log_every=5)
    return [new.stacked(), new.elbo, trace, torch.tensor(new.iteration)]


def logreg_data(seed=0):
    """Numpy data of a 64 x 8 logistic regression and three parameter
    values [beta, sigma] (sigma > 0), shared with the JAX package."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((64, 8)).astype(np.float32)
    y = (rng.random(64) < 0.5).astype(np.float32)
    theta = rng.standard_normal((3, 9)).astype(np.float32)
    theta[:, -1] = np.abs(theta[:, -1]) + 0.5
    return X, y, theta


def logreg_density(mesh):
    """The log density and gradient at fixed theta with the rows over "data"
    (the gradient averaged over the mesh: ``reduce_shares``' rule): the
    logistic regression, then the BNN on 30 rows (8, 8, 7, 7 a rank)."""
    import dataclasses

    from advancedvi_jl_tpu_torch.core.problem import log_density_and_grad
    from advancedvi_jl_tpu_torch.parallel.mesh import reduce_shares

    X, y, theta = logreg_data()
    prob = LogReg(torch.from_numpy(X), torch.from_numpy(y), torch.ones(()), data_axis=DATA)
    bnn = dataclasses.replace(avt.make_bnn(2, n_data=30, in_dim=3, hidden=4, device="cpu"),
                              data_axis=DATA)
    w = torch.randn(2, bnn.dim, generator=torch.Generator().manual_seed(2))
    out = []
    with under(mesh):
        for target, th in ((prob, torch.from_numpy(theta)), (bnn, w)):
            value, grad = log_density_and_grad(target, th)
            out += [value] + reduce_shares([grad], None)
    return out


def _ppl_logreg(data):
    from advancedvi_jl_tpu_torch import ppl

    X = data["X"]
    sigma = ppl.sample("sigma", ppl.LogNormal(0.0, 3.0))
    beta = ppl.sample("beta", ppl.Normal(X.new_zeros(X.shape[1]), sigma))
    with ppl.plate("obs", X.shape[0]):
        ppl.sample("y", ppl.Bernoulli(logits=X @ beta), obs=data["y"])


def _ppl_local(data):
    from advancedvi_jl_tpu_torch import ppl

    mu = ppl.sample("mu", ppl.Normal(0.0, 2.0))
    with ppl.plate("obs", data["y"].shape[0]):
        z = ppl.sample("z", ppl.Normal(mu, 1.0))
        ppl.sample("y", ppl.Normal(z, 0.5), obs=data["y"])


def ppl_density(mesh):
    """Ingested models with ``data_axis``: the logistic regression and a
    local-latent model (18 rows: 5, 5, 4, 4 a rank, each with its rows'
    latents); the log density and gradient at fixed theta, the gradient
    averaged over the mesh."""
    from advancedvi_jl_tpu_torch import ppl
    from advancedvi_jl_tpu_torch.core.problem import log_density_and_grad
    from advancedvi_jl_tpu_torch.parallel.mesh import reduce_shares

    X, y, _ = logreg_data()
    cases = {"logreg": (_ppl_logreg, {"X": torch.from_numpy(X), "y": torch.from_numpy(y)}),
             "local": (_ppl_local, {"y": torch.linspace(-1.0, 2.0, 18)})}
    out = {}
    for name, (model, data) in cases.items():
        m = ppl.ingest(model, data=data, data_axis=DATA, device="cpu")
        theta = torch.randn(3, m.target.dim, generator=torch.Generator().manual_seed(1))
        with under(mesh):
            value, grad = log_density_and_grad(m.target, theta)
            (grad,) = reduce_shares([grad], None)
        out[name] = [value, grad]
    return out


# ---------------------------------------------------------------------------
# A family's parameters over a mesh axis, on JAX's draws
# ---------------------------------------------------------------------------

# the axis of each mesh that a family splits: the larger one ("mc" on (2, 2))
FAMILY_AXIS = {(1, 4): MC, (2, 2): MC, (4, 1): DATA}
FA_N, FA_MIX_N, FA_MIX_D = 32, 8, 3
# case: (family, width, the objective's mc_axis ("family": the family's own
# axis; "mc"), the family's axis ("mesh": FAMILY_AXIS; or a name),
# compute_dtype, target: "normal" (replicated) or "logreg" (its rows over
# "data")).  Width: d (full rank), blocks of 2 (block-diagonal; the uneven
# case blocks of 3), components (mixtures).
FAMILY_CASES = {
    "tp": ("fullrank", 64, None, "mesh", None, "normal"),
    "tp_uneven": ("fullrank", 37, None, "mesh", None, "normal"),
    "tp_bf16": ("fullrank", 64, None, "mesh", "bfloat16", "normal"),
    "tp_on_mc": ("fullrank", 64, "family", "mesh", None, "normal"),
    "tp_composed": ("fullrank", 64, MC, DATA, None, "normal"),
    # the family's axis is the target's data axis: each rank's upstream
    # gradient holds its own data block's terms
    "tp_on_data": ("fullrank", 9, MC, DATA, None, "logreg"),
    "block": ("blockdiag", 8, None, "mesh", None, "normal"),
    "block_uneven": ("blockdiag", 6, None, "mesh", None, "normal"),
    "block_on_data": ("blockdiag", 8, MC, DATA, None, "logreg"),
    "ep": ("mixture_meanfield", 8, None, "mesh", None, "normal"),
    "ep_uneven": ("mixture_meanfield", 6, None, "mesh", None, "normal"),
    "ep_fullrank": ("mixture_fullrank", 6, None, "mesh", None, "normal"),
}
FA_ROWS = 64  # the "logreg" target's data rows


def family_logreg(d):
    """Numpy data (X, y) of a logistic regression of dimension d (d - 1
    features, FA_ROWS rows), shared with the JAX package."""
    rng = np.random.default_rng(100 + d)
    X = (0.5 * rng.standard_normal((FA_ROWS, d - 1))).astype(np.float32)
    return X, (rng.random(FA_ROWS) < 0.5).astype(np.float32)


def port_logreg(d):
    """The port's unconstrained logistic regression on ``family_logreg(d)``
    with its rows over "data"."""
    X, y = family_logreg(d)
    return LogReg(torch.from_numpy(X), torch.from_numpy(y), torch.ones(()),
                  data_axis=DATA).unconstrained()


def family_arrays(case):
    """Numpy parameters of the case's family and its NormalTarget's (mu, L),
    shared with the JAX package."""
    fam, width = FAMILY_CASES[case][:2]
    rng = np.random.default_rng(width)
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    if fam == "fullrank":
        d = width
        arr = {"loc": f32(0.1 * rng.standard_normal(d)),
               "C": f32(np.eye(d) + np.tril(0.01 * rng.standard_normal((d, d))))}
    elif fam == "blockdiag":
        k = 2 if width == 8 else 3
        d = width * k
        arr = {"loc": f32(0.1 * rng.standard_normal(d)),
               "scales": f32(np.eye(k) + np.tril(0.1 * rng.standard_normal((width, k, k)), -1))}
    else:
        d = FA_MIX_D
        arr = {"logits": f32(0.3 * rng.standard_normal(width)),
               "locations": f32(rng.standard_normal((width, d))),
               "scales": f32(0.5 + rng.random((width, d)))}
        if fam == "mixture_fullrank":
            arr["scales"] = f32(np.eye(d) * arr["scales"][:, None, :]
                                + np.tril(0.1 * rng.standard_normal((width, d, d)), -1))
    arr["mu"] = f32(np.linspace(-1.0, 1.0, d))
    arr["L"] = f32(np.eye(d) + np.tril(0.05 * rng.standard_normal((d, d)), -1))
    return arr


def family_axes(case, axis):
    """The case's axis names: (the family's, the objective's mc_axis)."""
    _, _, mc, fam_axis = FAMILY_CASES[case][:4]
    fam_axis = axis if fam_axis == "mesh" else fam_axis
    return fam_axis, (fam_axis if mc == "family" else mc)


def port_family_case(case, fam_axis, mc_axis):
    """(objective, family, target) of the case in the port, on the CPU."""
    from advancedvi_jl_tpu_torch import convert

    fam, _, _, _, cdt, kind = FAMILY_CASES[case]
    a = family_arrays(case)
    target = (convert.normal_target_from_numpy(a["mu"], a["L"], device="cpu")
              if kind == "normal" else port_logreg(a["mu"].shape[0]))
    if fam == "fullrank":
        q = convert.fullrank_from_numpy(a["loc"], a["C"], device="cpu", tp_axis=fam_axis,
                                        compute_dtype=cdt)
        return avt.RepGradELBO(n_samples=FA_N, entropy=avt.STL, mc_axis=mc_axis), q, target
    if fam == "blockdiag":
        q = convert.blockdiag_from_numpy(a["loc"], a["scales"], device="cpu",
                                         block_axis=fam_axis)
        return avt.RepGradELBO(n_samples=FA_N, entropy=avt.STL, mc_axis=mc_axis), q, target
    load = (convert.mixture_meanfield_from_numpy if fam == "mixture_meanfield"
            else convert.mixture_fullrank_from_numpy)
    q = load(a["logits"], a["locations"], a["scales"], device="cpu")
    return avt.MixtureELBO(n_samples=FA_MIX_N, ep_axis=fam_axis), q, target


def ep_on_data(mesh):
    """MixtureELBO with ``ep_axis="data"`` on a target whose rows are over
    "data" too (each rank evaluates its components' draws on every row):
    the gradient leaves and the ELBO."""
    from advancedvi_jl_tpu_torch import convert

    a = family_arrays("ep")
    q = convert.mixture_meanfield_from_numpy(a["logits"], a["locations"], a["scales"],
                                             device="cpu")
    u = torch.randn(q.n_components, FA_MIX_N, q.dim, generator=torch.Generator().manual_seed(4))
    with under(mesh):
        grad, _, info = avt.MixtureELBO(n_samples=FA_MIX_N, ep_axis=DATA).value_and_grad(
            q, port_logreg(q.dim), None, noise=u)
    return leaves(grad) + [info["elbo"].detach().clone()]


class _CountingTarget:
    """A target that records the rows of every batch it evaluates."""

    def __init__(self, prob, seen):
        self.prob, self.seen, self.dim = prob, seen, prob.dim

    def log_density(self, z):
        self.seen.append(z.shape[0])
        return self.prob.log_density(z)


def _recording(seen):
    """Patches that record, into ``seen``, the output columns of each plain
    full-rank product (float32 and bfloat16) and the blocks of each
    block-diagonal einsum; returns the undo list."""
    from advancedvi_jl_tpu_torch.families import location_scale as ls
    from advancedvi_jl_tpu_torch.ops.cuda import location_scale_kernels as lsk

    undo = []

    def wrap(mod, name, count):
        raw = getattr(mod, name)

        def rec(*a, **k):
            out = raw(*a, **k)
            seen.append(count(out, *a))
            return out

        setattr(mod, name, rec)
        undo.append((mod, name, raw))

    wrap(ls, "fullrank_affine_reference", lambda z, *a: z.shape[1])
    wrap(lsk, "fullrank_bf16_reference", lambda z, *a: z.shape[1])
    wrap(torch, "einsum", lambda z, eq, *ops: ops[0].shape[0] if eq == "bij,nbj->nbi" else None)
    return undo


def family_shares(mesh, inputs, shape):
    """Each FAMILY_CASES case's gradient leaves and ELBO on JAX's draws
    (``inputs``), and the shares this rank's products formed: for each case,
    the columns, blocks or target rows it recorded."""
    out, shares = {}, {}
    for case in FAMILY_CASES:
        fam_axis, mc_axis = family_axes(case, FAMILY_AXIS[shape])
        obj, q, target = port_family_case(case, fam_axis, mc_axis)
        seen = []
        if isinstance(obj, avt.MixtureELBO):
            target = _CountingTarget(target, seen)
        undo = _recording(seen)
        try:
            with under(mesh):
                grad, _, info = obj.value_and_grad(q, target, None,
                                                   noise=torch.from_numpy(inputs[f"fa_{case}"]))
        finally:
            for mod, name, raw in undo:
                setattr(mod, name, raw)
        out[case] = leaves(grad) + [info["elbo"].detach().clone()]
        shares[case] = [s for s in seen if s is not None]
    return out, shares


SCENARIOS = {"objectives": objectives, "measure_space": measure_space,
             "optimize": optimize_runs, "subsampled_logreg": subsampled_logreg,
             "chains": chains, "logreg_density": logreg_density, "ppl_density": ppl_density,
             "ep_on_data": ep_on_data}


# ---------------------------------------------------------------------------
# The rank's program
# ---------------------------------------------------------------------------


def _refusals(mesh):
    """JAX's three run_sharded refusals, as messages."""
    st = None
    cases = (chains_engine(optimizer=["adam"] * CHAINS), chains_engine(n_chains=20),
             chains_engine(n_chains=16))
    out = []
    for eng in cases:
        try:
            eng.run_sharded(st, 0, 1, mesh)
        except ValueError as e:
            out.append(str(e))
    return out


def rank_main(rank: int, world: int, port: int, outdir: str) -> None:
    import torch.distributed as dist

    from advancedvi_jl_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    with np.load(os.path.join(outdir, "inputs", "jax.npz")) as f:
        inputs = dict(f)
    address = f"localhost:{port}"
    distributed.initialize(address, world, rank, backend="gloo")
    group = dist.group.WORLD
    distributed.initialize(address, world, rank, backend="gloo")  # a no-op
    results = {"second_initialize_kept_the_group": dist.group.WORLD is group,
               "multi_host": distributed.is_multi_host()}
    shares = {}
    for shape in MESHES:
        mesh = avt.make_vi_mesh(n_mc=shape[1], n_data=shape[0])
        for name, fn in SCENARIOS.items():
            if name == "logreg_density" and shape != (4, 1):
                continue
            # the 500-step run on one mesh, as JAX's test_mesh_optimize_end_to_end
            res = fn(mesh, shape == (2, 2)) if name == "optimize" else fn(mesh)
            if name == "optimize":
                state = res.pop("state")
                res["state_leaves"] = [state.q.location, state.q.scale]
                if shape == (2, 2):  # everyone syncs, one rank writes
                    distributed.sync_hosts("pre_checkpoint")
                    if rank == 0:
                        avt.save_state(os.path.join(outdir, "ckpt.npz"), state)
                    distributed.sync_hosts("post_checkpoint")
            results[(name, shape)] = res
        results[("jax_objectives", shape)] = jax_objectives(mesh, inputs)
        results[("family_axes", shape)], shares[shape] = family_shares(mesh, inputs, shape)
    results["refusals"] = _refusals(avt.make_vi_mesh())
    torch.save(results, os.path.join(outdir, f"rank{rank}.pt"))
    torch.save(shares, os.path.join(outdir, f"shares{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


def _jax_family(fam):
    import jax.numpy as jnp

    import advancedvi_jl_tpu as javt

    loc, sd, C = jax_pairs()
    if fam == "meanfield":
        return javt.MeanFieldGaussian(jnp.asarray(loc), jnp.asarray(sd))
    return javt.FullRankGaussian(jnp.asarray(loc), jnp.asarray(C))


def _jax_target():
    import jax

    from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank

    return jax_normal_fullrank(jax.random.key(3), JAX_D)


JAX_KEY = 17


def jax_family_case(case, fam_axis, mc_axis):
    """(objective, family, target) of the case in the JAX package."""
    import jax.numpy as jnp

    import advancedvi_jl_tpu as javt
    from advancedvi_jl_tpu.models.logreg import LogReg as JaxLogReg
    from advancedvi_jl_tpu.models.normal import NormalTarget

    fam, _, _, _, cdt, kind = FAMILY_CASES[case]
    a = {k: jnp.asarray(v) for k, v in family_arrays(case).items()}
    if kind == "normal":
        target = NormalTarget(a["mu"], a["L"])
    else:
        X, y = family_logreg(a["mu"].shape[0])
        target = JaxLogReg(jnp.asarray(X), jnp.asarray(y), jnp.ones(()),
                           data_axis="data").unconstrained()
    if fam == "fullrank":
        q = javt.FullRankLocationScale(a["loc"], jnp.tril(a["C"]), tp_axis=fam_axis,
                                       compute_dtype=cdt)
        return javt.RepGradELBO(n_samples=FA_N, entropy="stl", mc_axis=mc_axis), q, target
    if fam == "blockdiag":
        q = javt.BlockDiagLocationScale(a["loc"], a["scales"], block_axis=fam_axis)
        return javt.RepGradELBO(n_samples=FA_N, entropy="stl", mc_axis=mc_axis), q, target
    cls = javt.MixtureMeanField if fam == "mixture_meanfield" else javt.MixtureFullRank
    q = cls(a["logits"], a["locations"], a["scales"])
    return javt.MixtureELBO(n_samples=FA_MIX_N, ep_axis=fam_axis), q, target


def jax_family_draws(case):
    """The JAX package's base draws of the case's family for JAX_KEY: what
    its objective draws (one device: with partitionable threefry they are
    the sharded draws too)."""
    import jax

    obj, q, _ = jax_family_case(case, None, None)
    key = jax.random.key(JAX_KEY)
    if FAMILY_CASES[case][0].startswith("mixture"):
        return np.asarray(jax.random.normal(key, (q.n_components, FA_MIX_N, q.dim)))
    return np.asarray(q.sample_with_base(key, FA_N)[1])


def write_jax_inputs(outdir):
    """The JAX package's target (mu, L) and, for each of JAX_OBJECTIVES,
    its family's base draws for JAX_KEY (one device: with partitionable
    threefry they are the sharded draws too), to OUTDIR/inputs/jax.npz."""
    import jax

    _, mu, L = _jax_target()
    out = {"mu": np.asarray(mu), "L": np.asarray(L)}
    os.makedirs(os.path.join(outdir, "inputs"))
    for name, (_, _, fam) in JAX_OBJECTIVES.items():
        u = _jax_family(fam).sample_with_base(jax.random.key(JAX_KEY), JAX_N)[1]
        out[name] = np.asarray(u)
    for case in FAMILY_CASES:
        out[f"fa_{case}"] = jax_family_draws(case)
    np.savez(os.path.join(outdir, "inputs", "jax.npz"), **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks once; their results, in rank order, and the
    output directory."""
    outdir = str(tmp_path_factory.mktemp("torch_multiprocess"))
    write_jax_inputs(outdir)
    return run_ranks(__file__, WORLD, outdir, TIMEOUT), outdir


@pytest.fixture(scope="module")
def reference():
    """Every scenario in this process, without a mesh."""
    out = {}
    for name, fn in SCENARIOS.items():
        out[name] = fn(None)
    return out


def test_every_rank_returns_the_same_bits(ranks):
    """Replicated outputs: each rank's results equal rank 0's exactly."""
    results, _ = ranks
    for r in range(1, WORLD):
        equal(results[r], results[0])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", ["repgrad", "repgrad_uneven", "repgrad_antithetic",
                                  "scoregrad", "iwelbo_dreg", "iwelbo_plain"])
def test_sharded_objective_equals_one_process(ranks, reference, shape, case):
    """The gradient and the ELBO (IW bound) with the draws over "mc" equal
    the one-process estimate (JAX: rtol 1e-5, atol 1e-6)."""
    got = ranks[0][0][("objectives", shape)][case]
    want = reference["objectives"][case]
    close(got[:-1], want[:-1], rtol=1e-5, atol=1e-6)
    close(got[-1:], want[-1:], rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_measure_space_steps_equal_one_process(ranks, reference, shape):
    """One NGD step at rtol 1e-5 and one BaM step at 5e-4 (its thin SVDs;
    the covariance-weighted Fisher at 1e-4), as JAX's; on the Gaussian and
    on the logistic regression with its rows over "data"."""
    got = ranks[0][0][("measure_space", shape)]
    want = reference["measure_space"]
    close(got["ngd"][:2], want["ngd"][:2], rtol=1e-5, atol=1e-6)
    close(got["ngd"][2:], want["ngd"][2:], rtol=1e-5)
    close(got["bam"][:2], want["bam"][:2], rtol=5e-4, atol=5e-5)
    close(got["bam"][3:], want["bam"][3:], rtol=1e-4)
    # the logistic regression's rows over "data" too
    close(got["ngd_logreg"][:2], want["ngd_logreg"][:2], rtol=1e-5, atol=1e-6)
    close(got["bam_logreg"][:2], want["bam_logreg"][:2], rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_optimize_under_a_mesh_equals_one_process(ranks, reference, shape):
    """50 steps of full-rank ADVI through ``optimize(mesh=)`` at rtol 1e-5;
    on (2, 2) also 500 steps, within 0.1 of the target's mean."""
    got = ranks[0][0][("optimize", shape)]
    want = reference["optimize"]
    close(got[50][:2], want[50][:2], rtol=1e-5, atol=1e-6)
    close(got[50][2:], want[50][2:], rtol=1e-5, atol=1e-5)
    if shape == (2, 2):
        assert float(torch.linalg.norm(got[500][0] - want["mu"])) < 0.1
        assert np.isfinite(float(got[500][2]))


@pytest.mark.parametrize("shape", MESHES)
def test_subsampled_logreg_over_the_data_axis(ranks, reference, shape):
    """Rows over "data", draws over "mc", a minibatch of 16 of 64 rows: 200
    steps, 50 epochs, the one-process run's parameters at rtol 1e-5."""
    got = ranks[0][0][("subsampled_logreg", shape)]
    want = reference["subsampled_logreg"]
    assert np.isfinite(float(got[2])) and int(got[3]) >= 40
    close(got[:2], want[:2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES)
def test_run_sharded_is_run_chunk_bit_for_bit(ranks, reference, shape):
    """The chain blocks over "mc" (8 chains a rank on (1, 4)), gathered in
    chain order, with the per-chain ELBO trace: the one-rank run bit for
    bit."""
    got = ranks[0][0][("chains", shape)]
    equal(got, reference["chains"])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", ["logreg", "local"])
def test_ingested_models_over_the_data_axis(ranks, reference, shape, case):
    """``ppl.ingest(..., data_axis="data")``: the log density (the blocks'
    likelihoods summed) and its gradient equal the one-process target's."""
    got = ranks[0][0][("ppl_density", shape)][case]
    close(got, reference["ppl_density"][case], rtol=1e-5, atol=1e-5)


def test_run_sharded_refuses_as_the_jax_engine(ranks):
    results, _ = ranks
    mixed, ragged, small = results[0]["refusals"]
    assert "mixed per-chain rule sweeps" in mixed
    assert "n_chains (= 20) to be a multiple of 8 and of the 'mc' axis size 4" in ragged
    assert "per-device chain block 4 must be a multiple of 8" in small


def test_process_zero_checkpoint_restores_bit_for_bit(ranks):
    """One checkpoint, written by rank 0 between two ``sync_hosts``; it
    restores onto a one-process template as the ranks' state."""
    results, outdir = ranks
    assert sorted(f for f in os.listdir(outdir) if f.endswith(".npz")) == ["ckpt.npz"]
    target, _, _ = normal_fullrank(3, 5, device="cpu")
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=16, operator=avt.ClipScale(),
                                  mc_axis=MC)
    template = alg.init(0, avt.FullRankGaussian(torch.zeros(5)), target)
    restored = avt.restore_state(os.path.join(outdir, "ckpt.npz"), template)
    loc, scale = results[0][("optimize", (2, 2))]["state_leaves"]
    assert torch.equal(restored.q.location, loc) and torch.equal(restored.q.scale, scale)
    assert restored.iteration == 50


def test_initialize_twice_is_a_no_op(ranks):
    results, _ = ranks
    assert results[0]["second_initialize_kept_the_group"] and results[0]["multi_host"]


def test_logreg_over_the_data_axis_matches_jax(ranks):
    """The log density and its gradient at fixed theta on the same numpy
    data, rows over "data": the port's 4 ranks against the JAX package's
    ``LogReg(data_axis="data")`` on its 8-device mesh, rtol 1e-5."""
    import jax
    import jax.numpy as jnp

    from advancedvi_jl_tpu.models.logreg import LogReg as JaxLogReg
    from advancedvi_jl_tpu.parallel.mesh import make_vi_mesh as jax_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    X, y, theta = logreg_data()
    prob = JaxLogReg(jnp.asarray(X), jnp.asarray(y), jnp.ones(()), data_axis="data")
    with jax.set_mesh(jax_mesh(n_mc=1, n_data=8)):
        value, grad = jax.jit(jax.vmap(jax.value_and_grad(prob.log_density)))(
            jnp.asarray(theta))
    got = ranks[0][0][("logreg_density", (4, 1))]
    close(got[:2], [np.asarray(value), np.asarray(grad)], rtol=1e-5, atol=1e-5)


def test_bnn_over_the_data_axis_equals_one_process(ranks, reference):
    """The BNN's log density and gradient with its rows over "data" equal
    the one-process target's."""
    close(ranks[0][0][("logreg_density", (4, 1))][2:], reference["logreg_density"][2:],
           rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_sharded():
    """Each of JAX_OBJECTIVES in the JAX package with ``mc_axis="mc"`` under
    its 8-device mesh, for JAX_KEY: its gradient leaves, then the ELBO."""
    import jax

    import advancedvi_jl_tpu as javt
    from advancedvi_jl_tpu.parallel.mesh import make_vi_mesh as jax_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    target, _, _ = _jax_target()
    key = jax.random.key(JAX_KEY)
    out = {}
    with jax.set_mesh(jax_mesh(n_mc=8)):
        for name, (cls, kw, fam) in JAX_OBJECTIVES.items():
            obj = getattr(javt, cls)(n_samples=JAX_N, mc_axis="mc", **kw)
            grad, _, info = jax.jit(lambda q: obj.value_and_grad(q, target, key))(
                _jax_family(fam))
            out[name] = [np.asarray(g) for g in jax.tree.leaves(grad)] + [
                np.asarray(info["elbo"])]
    return out


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", list(JAX_OBJECTIVES))
def test_sharded_objective_matches_jax(ranks, jax_sharded, shape, case):
    """The gradient and the ELBO (IW bound) with the draws over "mc" on the
    port's 4 ranks against the JAX package's objective over "mc" on its
    8-device mesh, on the same target, family and draws (rtol 1e-5, atol
    1e-6 for the gradient)."""
    got = ranks[0][0][("jax_objectives", shape)][case]
    want = jax_sharded[case]
    assert len(got) == len(want)
    close(got[:-1], want[:-1], rtol=1e-5, atol=1e-6)
    close(got[-1:], want[-1:], rtol=1e-5)


# JAX's mesh refuses 6 blocks or components over its 8 devices ("dim_size=2
# is not divisible by axis_size=8"): those cases run on 2 of them
JAX_TWO_DEVICES = ("block_uneven", "ep_uneven", "ep_fullrank")


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.fixture(scope="module")
def jax_family_axes():
    """Each FAMILY_CASES case in the JAX package under its 8-device mesh
    (JAX_TWO_DEVICES on 2), the family's axis "mc" (the composed case:
    "data" on a (2 x 4) mesh, the objective's draws over "mc"), for JAX_KEY:
    its gradient leaves, then the ELBO."""
    import jax

    from advancedvi_jl_tpu.parallel.mesh import make_vi_mesh as jax_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    out = {}
    for case in FAMILY_CASES:
        fam_axis, mc_axis = family_axes(case, MC)
        obj, q, target = jax_family_case(case, fam_axis, mc_axis)
        if fam_axis == DATA:
            mesh = jax_mesh(n_mc=4, n_data=2)
        elif case in JAX_TWO_DEVICES:
            mesh = jax_mesh(n_mc=2, devices=jax.devices()[:2])
        else:
            mesh = jax_mesh(n_mc=8)
        key = jax.random.key(JAX_KEY)
        with jax.set_mesh(mesh):
            grad, _, info = jax.jit(lambda q: obj.value_and_grad(q, target, key))(q)
        out[case] = [np.asarray(g) for g in jax.tree.leaves(grad)] + [np.asarray(info["elbo"])]
    return out


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_family_axis_matches_jax(ranks, jax_family_axes, shape, case):
    """A family's parameters over a mesh axis (tp_axis, block_axis, ep_axis;
    bfloat16 with tp; tp on the objective's own "mc"; tp over "data" with the
    draws over "mc"; tp and blocks over "data" on a logistic regression whose
    rows are over "data" too) on the port's 4 ranks, each rank forming its share,
    against the JAX package's on its 8-device mesh, on JAX's draws: the
    gradient at rtol 1e-5, atol 1e-6 and the ELBO at rtol 1e-5 (JAX's own
    tests: 1e-4 / 1e-5 for tp and blocks, 1e-5 / 1e-6 for the mixture).  In
    bfloat16 the factor's gradient is a float32 sum rounded to bfloat16, so
    an entry whose sum lies near a rounding boundary may land one bf16 ulp
    away when the sum runs in another order (JAX's own sharded and
    one-device runs differ so, by 4.9e-4): within one ulp."""
    got = ranks[0][0][("family_axes", shape)][case]
    want = jax_family_axes[case]
    assert len(got) == len(want)
    if FAMILY_CASES[case][4] == "bfloat16":  # (location, scale) gradients
        close(got[:1], want[:1], rtol=1e-5, atol=1e-6)
        diff = np.abs(np.asarray(got[1]) - want[1])
        assert (diff <= _bf16_ulp(want[1])).all(), diff.max()
    else:
        close(got[:-1], want[:-1], rtol=1e-5, atol=1e-6)
    close(got[-1:], want[-1:], rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_each_rank_forms_only_its_share(ranks, shape, case):
    """What each rank's plain products formed: the output columns of its
    full-rank product (its block of d over the family's axis), the blocks of
    its einsum, the rows its target evaluated (its components' draws): never
    the whole, wherever the axis has more than one rank."""
    from advancedvi_jl_tpu_torch.parallel.mesh import block

    _, outdir = ranks
    fam, width = FAMILY_CASES[case][:2]
    fam_axis, mc_axis = family_axes(case, FAMILY_AXIS[shape])
    for r in range(WORLD):
        seen = torch.load(os.path.join(outdir, f"shares{r}.pt"), weights_only=False)[shape][case]
        index = {DATA: r // shape[1], MC: r % shape[1]}
        parts = shape[0] if fam_axis == DATA else shape[1]
        if fam_axis == mc_axis:  # the draws' rows split the product: every column
            want = [width]
        elif fam.startswith("mixture"):
            want = [block(width, parts, index[fam_axis])[1] * FA_MIX_N]
        else:
            want = [block(width, parts, index[fam_axis])[1]]
        assert seen == want, (r, seen, want)


@pytest.mark.parametrize("shape", MESHES)
def test_mixture_over_the_data_axis_of_its_target(ranks, reference, shape):
    """``MixtureELBO(ep_axis="data")`` on a target whose rows are over
    "data": where that axis has more than one rank its ranks hold different
    components' draws, and each evaluates its own on every row; on every
    mesh the one-process estimate (JAX: rtol 1e-5, atol 1e-6)."""
    got = ranks[0][0][("ep_on_data", shape)]
    assert not isinstance(got, str), got
    close(got, reference["ep_on_data"], rtol=1e-5, atol=1e-6)
