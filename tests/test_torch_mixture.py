"""Port parity: the Gaussian mixtures (``MixtureMeanField``,
``MixtureFullRank``, ``mixture_meanfield``, ``mixture_fullrank``) and the
stratified ``MixtureELBO`` against the JAX package on the same numpy
parameters and JAX's own (K, n, d) base draws injected, and the cases of
tests/test_mixture.py on the port's Philox draws.

Tolerances: rtol 1e-5 on densities and moments; after 20 injected-noise
steps rtol 1e-5 on the parameters, Adam moments and averaged parameters
(atol 1e-6), 1e-4 on each step's ELBO.  The stratified draw is one K7a
launch over the flat (n, K d) width, held bit for bit to the sampler's
plain version.  The bimodal fits run 1,000 steps (JAX's 3,000) and hold
JAX's bars.
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
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    PhiloxKey,
    meanfield_sample_reference,
)

torch.set_num_threads(1)
CPU = "cpu"
K, D = 3, 4


def _params(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(K).astype(np.float32)
    locs = (1.5 * rng.standard_normal((K, D))).astype(np.float32)
    sds = (0.5 + rng.random((K, D))).astype(np.float32)
    scales = (np.tril(0.3 * rng.standard_normal((K, D, D))) + np.eye(D)).astype(np.float32)
    return logits, locs, sds, scales


def _pair(kind):
    logits, locs, sds, scales = _params()
    if kind == "meanfield":
        return (javt.MixtureMeanField(jnp.asarray(logits), jnp.asarray(locs), jnp.asarray(sds)),
                convert.mixture_meanfield_from_numpy(logits, locs, sds, device=CPU))
    return (javt.MixtureFullRank(jnp.asarray(logits), jnp.asarray(locs), jnp.asarray(scales)),
            convert.mixture_fullrank_from_numpy(logits, locs, scales, device=CPU))


@pytest.mark.parametrize("kind", ["meanfield", "fullrank"])
def test_family_matches_jax_on_injected_draws(kind):
    jq, tq = _pair(kind)
    key = jax.random.key(4)
    u = jax.random.normal(key, (K, 7, D))
    z = jq.sample_stratified(key, 7)
    tz = tq.stratified_from_base(torch.from_numpy(np.array(u)))
    assert_allclose(tz.numpy(), np.asarray(z), rtol=1e-5, atol=1e-6)
    zt = torch.from_numpy(np.array(z))
    assert_allclose(tq.log_prob(zt).numpy(), np.asarray(jq.log_prob(z)), rtol=1e-5)
    assert_allclose(float(tq.log_prob(zt[0, 0])), float(jq.log_prob(z[0, 0])), rtol=1e-5)
    for name in ("weights", "mean", "var", "cov"):
        assert_allclose(getattr(tq, name)().numpy(), np.asarray(getattr(jq, name)()),
                        rtol=1e-5, atol=1e-6)
    assert (tq.dim, tq.n_components) == (D, K)


@pytest.mark.parametrize("kind", ["meanfield", "fullrank"])
def test_stratified_draw_is_one_k7a_launch(kind):
    """Row i, columns [k d, (k + 1) d) of one sampler launch over (n, K d)
    are component k's draw i: the mean-field mixture's z is the kernel's z
    on the flattened locations and scales, the full-rank mixture's u the
    kernel's u at zero location and unit scale; bit for bit."""
    _, tq = _pair(kind)
    z, u = tq.sample_stratified_with_base(PhiloxKey((3, 4), 7), 5)
    if kind == "meanfield":
        kz, ku = meanfield_sample_reference((3, 4), 7, tq.locations.reshape(-1),
                                            tq.scale_diags.reshape(-1), 5)
        assert torch.equal(z, kz.reshape(5, K, D).permute(1, 0, 2))
    else:
        _, ku = meanfield_sample_reference((3, 4), 7, torch.zeros(K * D), torch.ones(K * D), 5)
        assert torch.equal(z, tq.stratified_from_base(u))
    assert torch.equal(u, ku.reshape(5, K, D).permute(1, 0, 2))
    assert torch.equal(tq.sample_stratified(PhiloxKey((3, 4), 7), 5), z)


def _assert_tree_close(t, j, **tol):
    jl, tl = jax.tree.leaves(j), tree_leaves(t)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("entropy", ["stl", "monte_carlo"])
@pytest.mark.parametrize("kind", ["meanfield", "fullrank"])
def test_twenty_steps_match_jax(kind, entropy):
    """MixtureELBO (n = 6 a component), Adam(1e-2), ClipScale, polynomial
    averaging on a d = 4 Gaussian: 20 steps on JAX's injected draws."""
    jt, mu, L = jax_normal_fullrank(jax.random.key(9), D)
    tt = convert.normal_target_from_numpy(mu, L, device=CPU)
    jq0, tq0 = _pair(kind)
    jalg = JParamSpaceSGD(objective=javt.MixtureELBO(n_samples=6, entropy=entropy),
                          optimizer=optax.adam(1e-2), averager=javt.PolynomialAveraging(),
                          operator=javt.ClipScale())
    talg = avt.ParamSpaceSGD(objective=avt.MixtureELBO(n_samples=6, entropy=entropy),
                             optimizer=avt.adam(1e-2), averager=avt.PolynomialAveraging(),
                             operator=avt.ClipScale())
    js, ts = jalg.init(jax.random.key(0), jq0, jt), talg.init(0, tq0, tt)
    step = jax.jit(jalg.step)
    for _ in range(20):
        u = jax.random.normal(jax.random.fold_in(js.key, js.iteration), (K, 6, D))
        js, jinfo = step(js)
        ts, tinfo = talg.step(ts, noise=torch.from_numpy(np.array(u)))
        assert_allclose(float(tinfo["elbo"]), float(jinfo["elbo"]), rtol=1e-4, atol=1e-4)
    tol = dict(rtol=1e-5, atol=1e-6)
    _assert_tree_close(ts.q, js.q, **tol)
    _assert_tree_close(talg.output(ts), jalg.output(js), **tol)
    _assert_tree_close(ts.opt_state.mu, js.opt_state[0].mu, **tol)
    _assert_tree_close(ts.opt_state.nu, js.opt_state[0].nu, rtol=5e-5, atol=1e-9)
    with pytest.raises(ValueError, match=r"noise must have shape \(3, 6, 4\)"):
        talg.step(ts, noise=torch.zeros(6, D))


def _bimodal_target(sep=3.0, w0=0.5):
    """w0 N(-sep, 0.5^2 I) + (1 - w0) N(+sep, 0.5^2 I) in 2-d."""
    mu = torch.tensor([[-sep, 0.0], [sep, 0.0]])
    s = 0.5
    logw = torch.log(torch.tensor([w0, 1.0 - w0]))

    def logd(z, _):
        diff = (z[..., None, :] - mu) / s
        comp = -0.5 * torch.sum(diff * diff, dim=-1) - 2 * math.log(s) - math.log(2 * math.pi)
        return torch.logsumexp(comp + logw, dim=-1)

    return avt.fn_target(logd, dim=2), mu, s


def test_log_prob_matches_numpy():
    q = avt.mixture_meanfield(0, dim=3, n_components=4, spread=2.0, device=CPU)
    z = q.sample(1, 50)
    w = q.weights().double().numpy()
    locs, sds, zz = q.locations.double().numpy(), q.scale_diags.double().numpy(), \
        z.double().numpy()
    dens = np.zeros(len(zz))
    for k in range(4):
        quad = np.sum(((zz - locs[k]) / sds[k]) ** 2, axis=1)
        dens += w[k] * np.exp(-0.5 * quad) / (np.prod(sds[k]) * (2 * np.pi) ** 1.5)
    assert_allclose(q.log_prob(z).numpy(), np.log(dens), rtol=1e-4)


def test_moments_of_the_ancestral_draws():
    q = avt.mixture_meanfield(0, dim=3, n_components=3, spread=1.5, device=CPU)
    z = q.sample(2, 200_000).numpy()
    assert_allclose(z.mean(0), q.mean().numpy(), atol=0.02)
    assert_allclose(z.var(0), q.var().numpy(), rtol=0.05)
    assert_allclose(np.cov(z.T), q.cov().numpy(), atol=0.05)
    # the ancestral draw of a step is a function of its key alone
    assert torch.equal(q.sample(PhiloxKey((1, 2), 3), 9), q.sample(PhiloxKey((1, 2), 3), 9))


def test_elbo_near_zero_at_representable_optimum():
    target, mu, s = _bimodal_target(w0=0.3)
    qstar = avt.MixtureMeanField(logits=torch.log(torch.tensor([0.3, 0.7])), locations=mu,
                                 scale_diags=torch.full((2, 2), s))
    val = avt.MixtureELBO(n_samples=20_000, entropy="monte_carlo").estimate_objective(
        0, qstar, target)
    assert abs(float(val)) < 1e-2


@pytest.mark.parametrize("entropy", ["monte_carlo", "stl"])
def test_fits_a_bimodal_target(entropy):
    """Both modes and the asymmetric weights; a single mean-field Gaussian
    pays about -log(0.75) nats more."""
    target, mu, s = _bimodal_target(w0=0.25)
    q0 = avt.MixtureMeanField(logits=torch.zeros(2),
                              locations=torch.tensor([[-2.0, 0.0], [2.0, 0.0]]),
                              scale_diags=torch.ones(2, 2))
    alg = avt.ParamSpaceSGD(objective=avt.MixtureELBO(n_samples=16, entropy=entropy),
                            optimizer=avt.adam(3e-2), averager=avt.NoAveraging(),
                            operator=avt.ClipScale())
    out, infos, _ = avt.optimize(0, alg, 1000, target, q0, log_every=500)
    nelbo = float(avt.MixtureELBO(n_samples=20_000).estimate_objective(5, out, target))
    assert abs(nelbo) < 0.05, nelbo
    order = torch.argsort(out.locations[:, 0])
    assert_allclose(out.locations[order].numpy(), mu.numpy(), atol=0.3)
    assert_allclose(out.weights()[order].numpy(), [0.25, 0.75], atol=0.05)
    qg = avt.MeanFieldGaussian(torch.zeros(2), torch.ones(2))
    algg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=16, optimizer=avt.adam(3e-2),
                                   operator=avt.ClipScale())
    outg, _, _ = avt.optimize(0, algg, 1000, target, qg, log_every=500)
    nelbo_g = float(avt.estimate_objective(5, algg, outg, target, n_samples=20_000))
    assert nelbo_g > abs(nelbo) + 0.25, (nelbo, nelbo_g)


def test_determinism():
    target, _, _ = _bimodal_target()
    q0 = avt.mixture_meanfield(1, dim=2, n_components=2, device=CPU)
    alg = avt.ParamSpaceSGD(objective=avt.MixtureELBO(n_samples=8), optimizer=avt.adam(1e-2),
                            averager=avt.PolynomialAveraging(), operator=avt.ClipScale())
    out1, _, _ = avt.optimize(0, alg, 50, target, q0)
    out2, _, _ = avt.optimize(0, alg, 50, target, q0)
    assert torch.equal(out1.locations, out2.locations) and torch.equal(out1.logits, out2.logits)


def test_ep_axis_and_entropy_refusals():
    target, _, _ = _bimodal_target()
    q0 = avt.mixture_meanfield(1, dim=2, n_components=2, device=CPU)
    # ep_axis is taken, and outside a mesh with that axis it changes no bit
    ep = avt.MixtureELBO(n_samples=8, ep_axis="mc")
    assert ep.ep_axis == "mc"
    g1, _, i1 = ep.value_and_grad(q0, target, 3)
    g0, _, i0 = avt.MixtureELBO(n_samples=8).value_and_grad(q0, target, 3)
    assert torch.equal(i1["elbo"], i0["elbo"]) and torch.equal(g1.locations, g0.locations)
    assert torch.equal(ep.estimate_objective(3, q0, target),
                       avt.MixtureELBO(n_samples=8).estimate_objective(3, q0, target))
    with pytest.raises(ValueError, match="unknown mixture entropy"):
        avt.MixtureELBO(entropy="closed_form").loss(q0, target, 0)
    with pytest.raises(TypeError, match="ClipScale is not defined"):
        avt.ClipScale().apply(avt.planar_flow(0, 2, device=CPU), None)


def test_composes_with_subsampling():
    n = 64
    ys = torch.from_numpy(np.random.default_rng(0).normal(-1.0, 0.5, n).astype(np.float32))
    target = avt.factorized_target(
        logprior_fn=lambda th: torch.sum(-0.5 * (th / 5.0) ** 2, dim=-1),
        loglike_fn=lambda th, y: torch.sum(-0.5 * (y - th[..., :1]) ** 2, dim=-1),
        data=ys, dim=1)
    obj = avt.SubsampledObjective(objective=avt.MixtureELBO(n_samples=8),
                                  subsampling=avt.ReshufflingBatchSubsampling(n_data=n,
                                                                               batchsize=16))
    alg = avt.ParamSpaceSGD(objective=obj, optimizer=avt.adam(2e-2), averager=avt.NoAveraging(),
                            operator=avt.ClipScale())
    q0 = avt.mixture_meanfield(1, dim=1, n_components=2, device=CPU)
    out, infos, _ = avt.optimize(0, alg, 400, target, q0, log_every=100)
    assert "epoch" in infos[-1]
    post_mean = float(ys.sum() / (n + 1.0 / 25.0))
    assert_allclose(float(out.mean()[0]), post_mean, atol=0.1)


def test_fullrank_log_prob_and_fit():
    q = avt.mixture_fullrank(4, dim=3, n_components=2, spread=1.0, device=CPU)
    tri = 0.2 * torch.randn(2, 3, 3, generator=torch.Generator().manual_seed(5))
    q = avt.MixtureFullRank(q.logits, q.locations, torch.tril(q.scales + tri))
    z = q.sample(6, 40)
    w = q.weights().double().numpy()
    dens = np.zeros(len(z))
    for k in range(2):
        C = np.tril(q.scales[k].double().numpy())
        cov = C @ C.T
        diff = z.double().numpy() - q.locations[k].double().numpy()
        quad = np.einsum("nd,dk,nk->n", diff, np.linalg.inv(cov), diff)
        dens += w[k] * np.exp(-0.5 * (quad + np.linalg.slogdet(cov)[1] + 3 * np.log(2 * np.pi)))
    assert_allclose(q.log_prob(z).numpy(), np.log(dens), rtol=1e-4)

    rho = 0.8
    Ls = torch.linalg.cholesky(torch.tensor([[[1.0, rho], [rho, 1.0]],
                                             [[1.0, -rho], [-rho, 1.0]]]))
    mus = torch.tensor([[-3.0, 0.0], [3.0, 0.0]])

    def logd(zz, _):
        diff = (zz[..., None, :] - mus)[..., None]  # (..., 2, 2, 1)
        v = torch.linalg.solve_triangular(Ls, diff, upper=False)[..., 0]
        lps = (-0.5 * torch.sum(v * v, dim=-1) - torch.log(torch.diagonal(Ls, dim1=-2, dim2=-1))
               .sum(-1) - math.log(2 * math.pi))
        return torch.logsumexp(lps + math.log(0.5), dim=-1)

    target = avt.fn_target(logd, dim=2)
    q0 = avt.MixtureFullRank(logits=torch.zeros(2),
                             locations=torch.tensor([[-2.0, 0.0], [2.0, 0.0]]),
                             scales=torch.eye(2).expand(2, 2, 2).clone())
    alg = avt.ParamSpaceSGD(objective=avt.MixtureELBO(n_samples=16, entropy="stl"),
                            optimizer=avt.adam(2e-2), averager=avt.NoAveraging(),
                            operator=avt.ClipScale())
    out, infos, _ = avt.optimize(0, alg, 3000, target, q0, log_every=1000)
    nelbo = float(avt.MixtureELBO(n_samples=20_000).estimate_objective(5, out, target))
    assert abs(nelbo) < 0.05, nelbo
    C = torch.tril(out.scales)
    covs = torch.einsum("kde,kfe->kdf", C, C).numpy()
    order = torch.argsort(out.locations[:, 0]).numpy()
    assert covs[order[0]][0, 1] > 0.5 and covs[order[1]][0, 1] < -0.5
