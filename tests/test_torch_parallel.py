"""The port's device mesh in one process (parallel/mesh.py): the samplers'
row offset (each rank of "mc" draws its rows of the one-process draw bit for
bit), ``make_vi_mesh``'s errors against the JAX package's, objects
configured with a mesh axis evaluating outside a mesh (JAX's
test_mc_axis_objects_evaluate_outside_mesh), and a mesh of one gloo rank
that leaves every result bit for bit as it is without a mesh.  The meshes of
several ranks are tests/test_torch_multiprocess.py."""

import numpy as np
import pytest
import torch

import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu_torch.models.logreg import make_logreg
from advancedvi_jl_tpu_torch.models.normal import normal_fullrank
from advancedvi_jl_tpu_torch.objectives.repgradelbo import antithetic_spans
from advancedvi_jl_tpu_torch.ops.cuda import location_scale_kernels as lsk
from advancedvi_jl_tpu_torch.parallel import mesh as pm

SEED = (0x1234, 0xBEEF)


@pytest.mark.parametrize("n,d", [(10, 62), (13, 5), (64, 9), (7, 1)])
@pytest.mark.parametrize("parts", [2, 3, 4])
def test_row_offset_draws_are_the_global_draws_rows(n, d, parts):
    """K7a's, K7b's and K7c's plain versions at (row0, rows) of each block
    draw those rows of the whole draw: u (and u2) bit for bit, K7a's z too;
    K7b's and K7c's z are a product over fewer rows (another BLAS blocking
    and summation order), within 1e-5 at |z| up to about 20."""
    g = torch.Generator().manual_seed(n * d)
    loc, sd = torch.randn(d, generator=g), 0.5 + torch.rand(d, generator=g)
    C = torch.tril(torch.randn(d, d, generator=g))
    U = torch.randn(d, 3, generator=g)
    z_mf, u_mf = lsk.meanfield_sample_reference(SEED, 9, loc, sd, n)
    z_fr, u_fr = lsk.fullrank_sample_reference(SEED, 9, loc, C, n)
    z_lr, u1_lr, u2_lr = lsk.lowrank_sample_reference(SEED, 9, loc, sd, U, n)
    for i in range(parts):
        row0, k = pm.block(n, parts, i)
        rows = slice(row0, row0 + k)
        z, u = lsk.meanfield_sample_reference(SEED, 9, loc, sd, k, row0=row0)
        assert torch.equal(z, z_mf[rows]) and torch.equal(u, u_mf[rows])
        z, u = lsk.meanfield_sample(SEED, 9, loc, sd, k, row0)  # the autograd wrapper
        assert torch.equal(z, z_mf[rows]) and torch.equal(u, u_mf[rows])
        z, u = lsk.fullrank_sample_reference(SEED, 9, loc, C, k, row0)
        assert torch.equal(u, u_fr[rows])
        torch.testing.assert_close(z, z_fr[rows], rtol=1e-5, atol=1e-5)
        z, u1, u2 = lsk.lowrank_sample_reference(SEED, 9, loc, sd, U, k, row0)
        assert torch.equal(u1, u1_lr[rows]) and torch.equal(u2, u2_lr[rows])
        torch.testing.assert_close(z, z_lr[rows], rtol=1e-5, atol=1e-5)


def test_families_draw_their_rows():
    """``sample_with_base(key, n, rows)`` of each location-scale family is
    those rows of the n-row draw: at a row offset on the kernels' route, the
    whole block's rows on ops/base_draws.py's (Student-t, float64); u bit
    for bit, z within 1e-6 where a product over the rows forms it."""
    key = lsk.PhiloxKey(SEED, 4)
    d, n = 6, 11
    fams = [avt.MeanFieldGaussian(torch.zeros(d), torch.ones(d)),
            avt.FullRankGaussian(torch.zeros(d), torch.eye(d) + 0.1),
            avt.LowRankGaussian(torch.zeros(d), torch.ones(d), torch.ones(d, 2)),
            avt.MeanFieldLocationScale(torch.zeros(d), torch.ones(d), base=avt.StudentT(5.0)),
            avt.FullRankGaussian(torch.zeros(d, dtype=torch.float64))]
    for q in fams:
        z_all, u_all = q.sample_with_base(key, n)
        for rows in ((0, 4), (4, 4), (8, 3)):
            z, u = q.sample_with_base(key, n, rows)
            sl = slice(rows[0], rows[0] + rows[1])
            assert torch.equal(u, u_all[sl]), type(q).__name__
            torch.testing.assert_close(z, z_all[sl], rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(q.sample(key, n, rows), z_all[sl], rtol=1e-6, atol=1e-6)


def test_row_offset_must_fit_the_counter():
    with pytest.raises(ValueError, match="32-bit counter row"):
        lsk.philox_normals_reference(SEED, 0, 2, 4, row0=2**32 - 1)


@pytest.mark.parametrize("n", [2, 4, 10, 12])
@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_antithetic_spans_cover_the_mirrored_draw(n, parts):
    """The base rows a rank's block of an antithetic n-row draw needs: the
    blocks' rows, base rows drawn as they are and mirrored, make the whole
    [0 .. n/2) + mirror [0 .. n/2) in order."""
    if n < parts:
        return
    order = []
    for i in range(parts):
        plain, mirrored = antithetic_spans(n, pm.block(n, parts, i))
        order += [("plain", r) for r in range(plain[0], plain[0] + plain[1])]
        order += [("mirror", r) for r in range(mirrored[0], mirrored[0] + mirrored[1])]
    half = n // 2
    assert order == [("plain", r) for r in range(half)] + [("mirror", r) for r in range(half)]


@pytest.mark.parametrize("n,parts", [(10, 4), (64, 8), (3, 3), (7, 2)])
def test_blocks_are_tensor_splits(n, parts):
    x = torch.arange(n)
    for i, piece in enumerate(torch.tensor_split(x, parts)):
        row0, k = pm.block(n, parts, i)
        assert torch.equal(x[row0:row0 + k], piece)


@pytest.mark.parametrize("kw", [dict(n_data=3), dict(n_mc=3, n_data=2), dict(n_mc=5)])
def test_make_vi_mesh_raises_as_the_jax_package(kw):
    """The same counts give the JAX package's two ValueErrors, word for word
    (8 devices: JAX's virtual CPU devices, the port's ranks)."""
    import jax

    from advancedvi_jl_tpu.parallel.mesh import make_vi_mesh as jax_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    with pytest.raises(ValueError) as want:
        jax_mesh(devices=jax.devices()[:8], **kw)
    with pytest.raises(ValueError) as got:
        avt.make_vi_mesh(devices=range(8), **kw)
    assert str(got.value) == str(want.value)


def test_make_vi_mesh_needs_a_process_group(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="initialize"):
        avt.make_vi_mesh()


def test_mc_axis_objects_evaluate_outside_mesh():
    """Objects configured with a mesh axis evaluate without a mesh (the
    helpers are no-ops), JAX's test of the same name."""
    from advancedvi_jl_tpu_torch.algorithms.measure_space import (
        FisherMinBatchMatch,
        KLMinNaturalGradDescent,
    )

    target, _, _ = normal_fullrank(3, 4, device="cpu")
    qf = avt.FullRankGaussian(torch.zeros(4))
    qm = avt.MeanFieldGaussian(torch.zeros(4), torch.ones(4))
    key = lsk.PhiloxKey(SEED, 0)
    values = [
        avt.ScoreGradELBO(n_samples=8, mc_axis="mc").estimate_objective(key, qm, target),
        KLMinNaturalGradDescent(stepsize=0.05, n_samples=8, mc_axis="mc").estimate_objective(
            key, qf, target),
        FisherMinBatchMatch(n_samples=8, mc_axis="mc").estimate_objective(key, qf, target),
        avt.RepGradELBO(n_samples=8, mc_axis="mc").estimate_objective(key, qm, target),
        avt.IWELBO(n_samples=8, mc_axis="mc").estimate_objective(key, qm, target),
    ]
    assert all(np.isfinite(float(v)) for v in values)
    alg = KLMinNaturalGradDescent(stepsize=0.05, n_samples=8, mc_axis="mc")
    st, info = alg.step(alg.init(0, qf, target))
    assert np.isfinite(float(info["elbo"]))
    # a target with a data axis is the whole-data target outside a mesh
    whole = make_logreg(11, n_data=40, n_features=3, device="cpu")
    split = make_logreg(11, n_data=40, n_features=3, data_axis="data", device="cpu")
    theta = torch.randn(5, 5).abs()
    assert torch.equal(whole.log_density(theta), split.log_density(theta))


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


def _flagship(n_samples=10, **kw):
    return avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=n_samples,
                                   optimizer=avt.adam(1e-3), operator=avt.ClipScale(), **kw)


def test_one_rank_mesh_is_bitwise_no_mesh(one_rank_mesh):
    """The flagship with ``mc_axis`` and ``data_axis`` through
    ``optimize(mesh=)`` on a (1 x 1) mesh: every collective runs on one rank,
    and the state is bit for bit the run without a mesh."""
    from advancedvi_jl_tpu_torch.utils.checkpoint import state_leaves

    q0 = avt.MeanFieldGaussian(torch.zeros(62), 0.1 * torch.ones(62))
    plain = make_logreg(11, device="cpu").unconstrained()
    split = make_logreg(11, data_axis="data", device="cpu").unconstrained()
    q1, rows1, st1 = avt.optimize(0, _flagship(), 100, plain, q0, log_every=10)
    q2, rows2, st2 = avt.optimize(0, _flagship(mc_axis="mc"), 100, split, q0, log_every=10,
                                  mesh=one_rank_mesh)
    assert rows1 == rows2
    leaves1, leaves2 = state_leaves(st1), state_leaves(st2)
    assert len(leaves1) == len(leaves2)
    for a, b in zip(leaves1, leaves2):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert torch.equal(q1.location, q2.location)


def test_one_rank_run_sharded_is_run_chunk(one_rank_mesh):
    prob = make_logreg(5, n_data=24, n_features=5, device="cpu")
    eng = avt.FusedChainsADVI(avt.logreg_spec(prob.X, prob.y), n_chains=8)
    st = eng.init(torch.zeros(8, eng.dim), 0.1 * torch.ones(8, eng.dim))
    a = eng.run_chunk(st, 3, 10)
    b = eng.run_sharded(st, 3, 10, one_rank_mesh)
    assert torch.equal(a.stacked(), b.stacked()) and torch.equal(a.elbo, b.elbo)
    assert b.iteration == 10


def test_replicate_state_keeps_every_leaf(one_rank_mesh):
    """The broadcast state has every tensor of the state (bool and int
    tensors too), equal, and the host fields as they were."""
    target = make_logreg(11, n_data=16, n_features=3, device="cpu").unconstrained()
    q0 = avt.MeanFieldGaussian(torch.zeros(5), torch.ones(5))
    alg = avt.KLMinRepGradDescent(subsampling=avt.ReshufflingBatchSubsampling(16, 4))
    st = alg.init(7, q0, target)
    st2 = pm.replicate_state(st, one_rank_mesh)
    from advancedvi_jl_tpu_torch.utils.checkpoint import state_leaves

    for a, b in zip(state_leaves(st), state_leaves(st2)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    flag = pm.replicate_state({"f": torch.tensor([True, False])}, one_rank_mesh)["f"]
    assert flag.dtype == torch.bool and flag.tolist() == [True, False]
