"""Port parity: the full-rank Gaussian family (advancedvi_jl_tpu_torch
.families.location_scale), its sampler (K7b) and triangular solve (K8), the
analytic Gaussian targets, and the general ADVI path on the full-rank
family, against the JAX package.  Here every kernel wrapper runs its plain
PyTorch version (CPU tensors); the JAX Pallas kernels run in interpret mode,
as the JAX package's own tests run them.  The kernels themselves are held to
their plain versions on a card (tests/test_torch_kernels.py)."""

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
from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank
from advancedvi_jl_tpu.ops.pallas import location_scale_kernels as jlsk
from advancedvi_jl_tpu.ops.pallas import trisolve_kernels as jtri
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.models import normal as tnormal
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    PhiloxKey,
    fullrank_sample,
    fullrank_sample_cuda,
    fullrank_sample_raw,
    fullrank_sample_reference,
    meanfield_sample_reference,
    seed_words,
)
from advancedvi_jl_tpu_torch.ops.cuda.trisolve_kernels import (
    solve_right,
    solve_right_cuda,
    solve_right_reference,
    vdiv_c,
    vdiv_ct,
)

torch.set_num_threads(1)

N = 10


def _factor(rng, d, diag=1.5):
    """A lower-triangular factor with unit-norm rows off the diagonal (the
    JAX trisolve tests' ``_factor``), as float32 numpy."""
    A = rng.standard_normal((d, d)).astype(np.float32) * np.float32(0.3 / d**0.5)
    return (np.tril(A, -1) + diag * np.eye(d, dtype=np.float32)).astype(np.float32)


# -- K7b: the full-rank sampler ---------------------------------------------


def test_fullrank_sampler_plain_version_is_u_times_tril_c():
    """z = u tril(C)^T + m, and u is the mean-field sampler's u."""
    rng = np.random.default_rng(0)
    d = 37
    loc = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32))
    z, u = fullrank_sample_reference(seed_words(5), 3, loc, C, N)
    _, u_mf = meanfield_sample_reference(seed_words(5), 3, loc, torch.ones(d), N)
    assert torch.equal(u, u_mf)
    # the upper triangle of C is never read (float64 product as the check)
    want = u.double() @ torch.tril(C).double().T + loc.double()
    assert_allclose(z.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    z2, u2 = fullrank_sample_raw(seed_words(5), 3, loc, torch.tril(C), N)
    assert torch.equal(u2, u) and torch.equal(z2, z)
    with pytest.raises(ValueError, match="GPU"):
        fullrank_sample_cuda(seed_words(5), 3, loc, C, N)
    with pytest.raises(ValueError, match="device"):
        fullrank_sample_raw(seed_words(5), 3, loc.to("meta"), C.to("meta"), N)


def test_fullrank_sampler_backward_matches_jax_fr_bwd():
    """The autograd.Function backward against JAX's ``_fr_bwd`` on the same
    (u, ct_z); both are one product and one sum (rtol 1e-5 for their order)."""
    rng = np.random.default_rng(1)
    d = 24
    loc = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).requires_grad_(True)
    C = torch.from_numpy(_factor(rng, d)).requires_grad_(True)
    ct = rng.standard_normal((N, d)).astype(np.float32)
    z, u = fullrank_sample(seed_words(2), 0, loc, C, N)
    assert not u.requires_grad
    gl, gC = torch.autograd.grad((z * torch.from_numpy(ct)).sum(), (loc, C))
    _, jgl, jgC = jlsk._fr_bwd(N, 256, True, (jnp.asarray(u.numpy()), (2,)),
                               (jnp.asarray(ct), None))
    assert_allclose(gl.numpy(), np.asarray(jgl), rtol=1e-5, atol=1e-6)
    assert_allclose(gC.numpy(), np.asarray(jgC), rtol=1e-5, atol=1e-6)


# -- K8: the triangular solve -----------------------------------------------


@pytest.mark.parametrize("mode", ["C", "CT"])
@pytest.mark.parametrize("d,n", [(128, 8), (256, 24), (100, 6)])
def test_solve_right_matches_jax(mode, d, n):
    """The plain solve against JAX ``solve_right`` in interpret mode (d a
    multiple of 128) or its XLA fallback (d = 100), at the JAX tests'
    tolerances (tests/test_pallas_trisolve.py: rtol 2e-4, atol 2e-5)."""
    rng = np.random.default_rng(d + n)
    C = _factor(rng, d)
    V = rng.standard_normal((n, d)).astype(np.float32)
    want = jtri.solve_right(jnp.asarray(C), jnp.asarray(V), mode=mode, interpret=True)
    got = solve_right(torch.from_numpy(C), torch.from_numpy(V), mode)
    assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_solve_right_reads_the_lower_triangle_and_routes_by_device():
    rng = np.random.default_rng(3)
    C = torch.from_numpy(_factor(rng, 16))
    V = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    full = C + torch.triu(torch.ones(16, 16), 1)
    for mode in ("C", "CT"):
        assert torch.equal(solve_right(full, V, mode), solve_right_reference(C, V, mode))
    with pytest.raises(ValueError, match="mode"):
        solve_right(C, V, "T")
    with pytest.raises(ValueError, match="CUDA"):
        solve_right_cuda(C, V, "C")
    with pytest.raises(ValueError, match="device"):
        solve_right(C.to("meta"), V.to("meta"), "C")


@pytest.mark.parametrize("name", ["vdiv_c", "vdiv_ct"])
def test_vdiv_gradients_match_jax_custom_vjps(name):
    """Gradients in (C, V) against JAX's custom VJPs (interpret mode), the
    lower triangle of C only (tests/test_pallas_trisolve.py:61-80)."""
    d, n = 256, 24
    rng = np.random.default_rng(4)
    C = _factor(rng, d)
    V = rng.standard_normal((n, d)).astype(np.float32)
    ct = rng.standard_normal((n, d)).astype(np.float32)
    jf = getattr(jtri, name)
    jgC, jgV = jax.grad(lambda C, V: jnp.sum(jf(C, V) * ct), argnums=(0, 1))(
        jnp.asarray(C), jnp.asarray(V))
    f = {"vdiv_c": vdiv_c, "vdiv_ct": vdiv_ct}[name]
    tC = torch.from_numpy(C).requires_grad_(True)
    tV = torch.from_numpy(V).requires_grad_(True)
    gC, gV = torch.autograd.grad((f(tC, tV) * torch.from_numpy(ct)).sum(), (tC, tV))
    assert_allclose(np.tril(gC.numpy()), np.tril(np.asarray(jgC)), rtol=1e-4, atol=2e-5)
    assert_allclose(gV.numpy(), np.asarray(jgV), rtol=1e-4, atol=2e-5)


# -- the family -------------------------------------------------------------


@pytest.fixture(scope="module")
def wide_pair():
    rng = np.random.default_rng(5)
    d = 200
    loc = rng.standard_normal(d).astype(np.float32)
    C = _factor(rng, d, diag=1.3)
    return d, loc, C


@pytest.mark.parametrize("solve_mode", ["solve", "pallas"])
def test_family_matches_jax(wide_pair, solve_mode):
    """log_prob, entropy and apply_inv_scale_T at d = 200 (the JAX family's
    pallas mode falls back to the XLA solve there; the port's runs K8's plain
    version), at tests/test_pallas_trisolve.py's family tolerances."""
    d, loc, C = wide_pair
    jq = javt.FullRankGaussian(jnp.asarray(loc), jnp.asarray(C), solve_mode=solve_mode)
    tq = convert.fullrank_from_numpy(loc, C, solve_mode=solve_mode, device="cpu")
    z = np.random.default_rng(6).standard_normal((16, d)).astype(np.float32)
    assert_allclose(tq.log_prob(torch.from_numpy(z)).numpy(),
                    np.asarray(jq.log_prob(jnp.asarray(z))), rtol=2e-4, atol=2e-3)
    # a 1-D point takes the plain solve in both packages
    assert_allclose(float(tq.log_prob(torch.from_numpy(z[0]))),
                    float(jq.log_prob(jnp.asarray(z[0]))), rtol=1e-5)
    assert_allclose(float(tq.entropy()), float(jq.entropy()), rtol=1e-6)
    assert_allclose(float(tq.log_det_scale()), float(jq.log_det_scale()), rtol=1e-6)
    V = np.random.default_rng(7).standard_normal((16, d)).astype(np.float32)
    assert_allclose(tq.apply_inv_scale_T(torch.from_numpy(V)).numpy(),
                    np.asarray(jq.apply_inv_scale_T(jnp.asarray(V))), rtol=2e-3, atol=2e-3)
    for name in ("mean", "var", "cov", "scale_matrix"):
        assert_allclose(getattr(tq, name)().numpy(), np.asarray(getattr(jq, name)()),
                        rtol=1e-5, atol=1e-6, err_msg=name)
    u = np.random.default_rng(8).standard_normal((N, d)).astype(np.float32)
    zj = jq.scale_matrix() @ jnp.asarray(u).T
    assert_allclose(tq.from_base(torch.from_numpy(u)).numpy(),
                    np.asarray(zj.T + jq.location), rtol=1e-5, atol=1e-5)


def test_family_constructor_scale_diag_and_clip():
    q = avt.FullRankGaussian(torch.zeros(3), torch.ones(3, 3))
    assert isinstance(q, avt.FullRankLocationScale)
    assert torch.equal(q.scale, torch.tril(torch.ones(3, 3)))
    assert torch.equal(avt.FullRankGaussian(torch.zeros(2)).scale, torch.eye(2))
    assert q.dim == 3
    from advancedvi_jl_tpu_torch.families.location_scale import is_location_scale
    assert is_location_scale(q) and is_location_scale(avt.MeanFieldGaussian(torch.zeros(2)))
    # ClipScale clamps the diagonal only, exactly to epsilon, and keeps the
    # off-diagonal as stored (the JAX operator's contract)
    raw = avt.FullRankLocationScale(torch.zeros(3), torch.tensor(
        [[1e-7, 5.0, 0.0], [0.3, -2.0, 0.0], [0.1, 0.2, 0.5]]))
    jraw = javt.FullRankLocationScale(jnp.zeros(3), jnp.asarray(raw.scale.numpy()))
    clipped = avt.ClipScale().apply(raw, None)
    assert_allclose(clipped.scale.numpy(), np.asarray(javt.ClipScale().apply(jraw, None).scale),
                    rtol=0, atol=0)
    assert clipped.scale[0, 1] == 5.0
    # solve_mode="inverse", layout="packed" and compute_dtype are ported
    # (ops/trinv.py, ops/packing.py, csrc/fullrank_bf16.cu)
    assert avt.FullRankGaussian(torch.zeros(2), solve_mode="inverse").solve_mode == "inverse"
    assert avt.FullRankGaussian(torch.zeros(2), layout="packed").scale.shape == (1, 128, 128)
    with pytest.raises(ValueError, match="layout"):
        avt.FullRankGaussian(torch.zeros(2), layout="sparse")
    assert avt.FullRankGaussian(torch.zeros(2), compute_dtype="bfloat16").compute_dtype == \
        "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        avt.FullRankGaussian(torch.zeros(2), compute_dtype="float16")
    with pytest.raises(ValueError, match="solve_mode"):
        avt.FullRankGaussian(torch.zeros(2), solve_mode="typo")
    with pytest.raises(ValueError, match="float32"):
        avt.FullRankGaussian(torch.zeros(2, dtype=torch.float64), solve_mode="pallas")


def test_fullrank_draw_and_entropy_estimators_match_jax(wide_pair):
    """Value and gradient in (location, scale) of each entropy estimator at
    the same base draw, through the solve-free path, pallas solve mode."""
    from advancedvi_jl_tpu.objectives import entropy as jent
    from advancedvi_jl_tpu_torch.core.pytree import tree_stop_gradient
    from advancedvi_jl_tpu_torch.objectives import entropy as tent

    d, loc, C = 64, *wide_pair[1:]
    loc, C = loc[:d], C[:d, :d]
    u = np.random.default_rng(9).standard_normal((N, d)).astype(np.float32)
    for estimator in ("closed_form", "monte_carlo", "stl"):
        def jfn(q):
            z = jnp.asarray(u) @ q.tril_scale().T + q.location
            return jent.estimate_entropy_from_draw(
                estimator, z, jnp.asarray(u), q, jax.lax.stop_gradient(q))

        jq = javt.FullRankGaussian(jnp.asarray(loc), jnp.asarray(C))
        jval, jgrad = jax.value_and_grad(jfn)(jq)
        tl = torch.from_numpy(loc).requires_grad_(True)
        tC = torch.from_numpy(C).requires_grad_(True)
        q = avt.FullRankLocationScale(tl, tC, solve_mode="pallas")
        ut = torch.from_numpy(u)
        val = tent.estimate_entropy_from_draw(estimator, q.from_base(ut), ut, q,
                                              tree_stop_gradient(q))
        gl, gC = torch.autograd.grad(val, (tl, tC), allow_unused=True,
                                     materialize_grads=True)
        assert_allclose(float(val.detach()), float(jval), rtol=1e-6, err_msg=estimator)
        assert_allclose(gl.numpy(), np.asarray(jgrad.location), rtol=1e-5, atol=1e-6)
        assert_allclose(gC.numpy(), np.asarray(jnp.tril(jgrad.scale)), rtol=1e-5, atol=1e-6)


# -- the analytic targets ---------------------------------------------------


def test_normal_targets_match_jax():
    jt, jmu, jL = jax_normal_fullrank(jax.random.key(3), 12)
    tt = convert.normal_target_from_numpy(jmu, jL, device="cpu")
    th = np.random.default_rng(10).standard_normal((5, 12)).astype(np.float32)
    want = np.asarray(jax.vmap(jt.log_density)(jnp.asarray(th)))
    assert_allclose(tt.log_density(torch.from_numpy(th)).numpy(), want, rtol=1e-5)
    assert_allclose(tt.solve_free().log_density(torch.from_numpy(th)).numpy(),
                    np.asarray(jax.vmap(jt.solve_free().log_density)(jnp.asarray(th))),
                    rtol=1e-5)
    assert_allclose(float(tt.log_density(torch.from_numpy(th[0]))), want[0], rtol=1e-5)
    for make in (tnormal.normal_fullrank, tnormal.normal_fullrank_wellcond,
                 tnormal.normal_meanfield):
        target, mu, L = make(4, 7, device="cpu")
        assert target.dim == 7 and torch.equal(L, torch.tril(L))
        assert bool((torch.diagonal(L) > 0).all())
        again, _, _ = make(torch.Generator().manual_seed(4), 7, device="cpu")
        assert torch.equal(again.mu, mu) and torch.equal(again.scale_tril, L)


# -- the general path on the full-rank family -------------------------------


def _jax_run(jtarget, jq0, steps):
    alg = javt.KLMinRepGradDescent(entropy=javt.STL, n_samples=N,
                                   optimizer=optax.adam(1e-3), operator=javt.ClipScale())
    state = alg.init(jax.random.key(0), jq0, jtarget)
    step = jax.jit(alg.step)
    draws, infos = [], []
    for _ in range(steps):
        step_key = jax.random.fold_in(state.key, state.iteration)
        _, u = state.q.sample_with_base(step_key, N)
        draws.append(np.asarray(u))
        state, info = step(state)
        infos.append(info)
    return alg, state, draws, infos


def _port_run(ttarget, tq0, draws):
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N,
                                  optimizer=avt.adam(1e-3), operator=avt.ClipScale())
    state = alg.init(0, tq0, ttarget)
    infos = []
    for u in draws:
        state, info = alg.step(state, noise=convert.to_tensor(u, device="cpu"))
        infos.append(info)
    return alg, state, infos


@pytest.mark.parametrize("case", ["normal_fullrank_d10", "logreg_d62"])
def test_general_fullrank_path_matches_jax(case):
    """JAX's base draws injected through ``noise``: after T steps the state,
    Adam moments, averaged parameters and ELBOs match KLMinRepGradDescent on
    FullRankGaussian (the tolerances of tests/test_fused_advi.py: 1e-5 on
    the parameters and moments, 1e-4 on the ELBO)."""
    if case == "logreg_d62":
        jprob = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
        jtarget = jprob.unconstrained()
        ttarget = convert.logreg_from_numpy(jprob.X, jprob.y, jprob.likeadj,
                                            jprob.prior_scale, device="cpu").unconstrained()
        d, steps = jprob.dim, 3
        C0 = 0.1 * np.eye(d, dtype=np.float32)
        loc0 = np.zeros(d, np.float32)
    else:
        jtarget, mu, L = jax_normal_fullrank(jax.random.key(3), 10)
        ttarget = convert.normal_target_from_numpy(mu, L, device="cpu")
        d, steps = 10, 5
        rng = np.random.default_rng(11)
        C0 = (0.2 * np.eye(d) + 0.05 * np.tril(rng.standard_normal((d, d)), -1)).astype(np.float32)
        loc0 = np.full(d, 0.3, np.float32)
    jq0 = javt.FullRankGaussian(jnp.asarray(loc0), jnp.asarray(C0))
    tq0 = convert.fullrank_from_numpy(loc0, C0, solve_mode="pallas", device="cpu")
    jalg, js, draws, jinfos = _jax_run(jtarget, jq0, steps)
    talg, ts, tinfos = _port_run(ttarget, tq0, draws)

    tol = dict(rtol=1e-5, atol=1e-6)
    assert_allclose(ts.q.location.numpy(), js.q.location, **tol)
    assert_allclose(ts.q.scale.numpy(), np.tril(np.asarray(js.q.scale)), **tol)
    jout, tout = jalg.output(js), talg.output(ts)
    assert_allclose(tout.location.numpy(), jout.location, **tol)
    assert_allclose(tout.scale.numpy(), np.tril(np.asarray(jout.scale)), **tol)
    jadam = js.opt_state[0]
    assert_allclose(ts.opt_state.mu.location.numpy(), jadam.mu.location, rtol=1e-5, atol=1e-6)
    assert_allclose(ts.opt_state.mu.scale.numpy(), np.tril(np.asarray(jadam.mu.scale)),
                    rtol=1e-5, atol=1e-6)
    assert_allclose(ts.opt_state.nu.scale.numpy(), np.tril(np.asarray(jadam.nu.scale)),
                    rtol=5e-5, atol=1e-9)
    # the strict upper triangle stays inert: zero moments, zero scale
    for t in (ts.q.scale, ts.opt_state.mu.scale, ts.opt_state.nu.scale, tout.scale):
        assert torch.equal(torch.triu(t, 1), torch.zeros_like(t))
    for ti, ji in zip(tinfos, jinfos):
        assert_allclose(float(ti["elbo"]), float(ji["elbo"]), rtol=1e-4, atol=1e-4)


def test_general_fullrank_optimize_on_philox_draws():
    """Without noise the family draws through K7b's plain version: a run of
    ``optimize`` equals stepping by hand, and a resumed run repeats it."""
    target, mu, L = tnormal.normal_fullrank_wellcond(1, 16, device="cpu")
    q0 = avt.FullRankGaussian(torch.zeros(16), solve_mode="pallas")
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=N,
                                  optimizer=avt.adam(1e-2), operator=avt.ClipScale())
    q, infos, st = avt.optimize(4, alg, 12, target.solve_free(), q0, log_every=4)
    _, _, s1 = avt.optimize(4, alg, 5, target.solve_free(), q0)
    q2, _, s2 = avt.optimize(None, alg, 7, None, None, state=s1)
    assert torch.equal(q.location, q2.location) and torch.equal(st.q.scale, s2.q.scale)
    s = alg.init(4, q0, target.solve_free())
    z, _ = q0.sample_with_base(PhiloxKey(s.seed, 0), N)
    want = fullrank_sample_reference(s.seed, 0, q0.location, q0.scale, N)[0]
    assert torch.equal(z, want)
    assert [r["iteration"] for r in infos] == [4, 8, 12]
