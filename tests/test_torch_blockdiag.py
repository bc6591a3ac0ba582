"""Port parity: the block-diagonal Gaussian family (``BlockDiagGaussian``,
``BlockDiagLocationScale``) against the JAX package on the same numpy
parameters and JAX's own base draws injected, and the cases of
tests/test_blockdiag.py on the port's Philox draws.

Tolerances: rtol 1e-5 on densities, entropies and moments; after 20
injected-noise ADVI steps rtol 1e-5 on the parameters, Adam moments and
averaged parameters (atol 1e-6; the gradient's sums run in another order),
1e-4 on each step's ELBO.  The draw's u is K7a's plain version at zero
location and unit scale, bit for bit.
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
from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.core.pytree import tree_leaves
from advancedvi_jl_tpu_torch.models.normal import NormalTarget, normal_fullrank
from advancedvi_jl_tpu_torch.objectives.repgradelbo import _use_fast
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    PhiloxKey,
    meanfield_sample_reference,
)

torch.set_num_threads(1)
CPU = "cpu"


def _params(B=3, k=2, seed=0):
    rng = np.random.default_rng(seed)
    scales = (np.tril(0.3 * rng.standard_normal((B, k, k))) + np.eye(k)).astype(np.float32)
    loc = rng.standard_normal(B * k).astype(np.float32)
    return loc, scales


def _pair(B=3, k=2):
    loc, scales = _params(B, k)
    return (javt.BlockDiagGaussian(jnp.asarray(loc), jnp.asarray(scales)),
            convert.blockdiag_from_numpy(loc, scales, device=CPU))


def test_family_matches_jax_on_injected_draws():
    """from_base on JAX's u, log_prob (batched and one point), entropy and
    the moments, rtol 1e-5."""
    jq, tq = _pair()
    z, u = jq.sample_with_base(jax.random.key(3), 40)
    tz = tq.from_base(torch.from_numpy(np.array(u)))
    assert_allclose(tz.numpy(), np.asarray(z), rtol=1e-5, atol=1e-6)
    zt = torch.from_numpy(np.array(z))
    assert_allclose(tq.log_prob(zt).numpy(), np.asarray(jq.log_prob(z)), rtol=1e-5)
    assert_allclose(float(tq.log_prob(zt[0])), float(jq.log_prob(z[0])), rtol=1e-5)
    assert_allclose(float(tq.entropy()), float(jq.entropy()), rtol=1e-5)
    for name in ("mean", "var", "cov", "scale_matrix"):
        assert_allclose(getattr(tq, name)().numpy(), np.asarray(getattr(jq, name)()),
                        rtol=1e-5, atol=1e-7)
    assert (tq.n_blocks, tq.block_dim, tq.dim, tq.base_dim) == (3, 2, 6, 6)
    assert not _use_fast(tq)  # no apply_inv_scale_T: the general entropy path, as in JAX


def test_draw_is_k7a_at_unit_scale():
    """u is the mean-field sampler's u for the key at zero location and unit
    scale (its plain version here), bit for bit; z its batched product."""
    _, tq = _pair()
    z, u = tq.sample_with_base(PhiloxKey((5, 6), 9), 12)
    _, want = meanfield_sample_reference((5, 6), 9, torch.zeros(6), torch.ones(6), 12)
    assert torch.equal(u, want)
    assert torch.equal(z, tq.from_base(u))
    assert torch.equal(tq.sample(PhiloxKey((5, 6), 9), 12), z)


def _assert_tree_close(t, j, **tol):
    jl = jax.tree.leaves(j)
    tl = tree_leaves(t)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


def test_twenty_advi_steps_match_jax():
    """KLMinRepGradDescent (STL, Adam(1e-2), ClipScale, polynomial
    averaging) on a d = 6 Gaussian, 20 steps on JAX's injected draws."""
    jt, mu, L = jax_normal_fullrank(jax.random.key(9), 6)
    tt = convert.normal_target_from_numpy(mu, L, device=CPU)
    jq0, tq0 = _pair()
    jalg = javt.KLMinRepGradDescent(entropy=javt.STL, n_samples=8, optimizer=optax.adam(1e-2),
                                    operator=javt.ClipScale())
    talg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=8, optimizer=avt.adam(1e-2),
                                   operator=avt.ClipScale())
    js = jalg.init(jax.random.key(0), jq0, jt)
    ts = talg.init(0, tq0, tt)
    step = jax.jit(jalg.step)
    for _ in range(20):
        _, u = js.q.sample_with_base(jax.random.fold_in(js.key, js.iteration), 8)
        js, jinfo = step(js)
        ts, tinfo = talg.step(ts, noise=torch.from_numpy(np.array(u)))
        assert_allclose(float(tinfo["elbo"]), float(jinfo["elbo"]), rtol=1e-4, atol=1e-4)
    tol = dict(rtol=1e-5, atol=1e-6)
    _assert_tree_close(ts.q, js.q, **tol)
    _assert_tree_close(talg.output(ts), jalg.output(js), **tol)
    _assert_tree_close(ts.opt_state.mu, js.opt_state[0].mu, **tol)
    _assert_tree_close(ts.opt_state.nu, js.opt_state[0].nu, rtol=5e-5, atol=1e-9)


def test_single_block_equals_fullrank():
    d = 4
    C = torch.tril(0.3 * torch.randn(d, d, generator=torch.Generator().manual_seed(2))) \
        + torch.eye(d)
    loc = torch.tensor([0.5, -1.0, 0.0, 2.0])
    q_bd = avt.BlockDiagGaussian(loc, C[None])
    q_fr = avt.FullRankGaussian(loc, C)
    z = q_fr.sample(0, 64)
    assert_allclose(q_bd.log_prob(z).numpy(), q_fr.log_prob(z).numpy(), rtol=1e-5, atol=1e-5)
    assert_allclose(float(q_bd.entropy()), float(q_fr.entropy()), rtol=1e-6)
    assert_allclose(q_bd.var().numpy(), q_fr.var().numpy(), rtol=1e-6)
    assert_allclose(q_bd.cov().numpy(), q_fr.cov().numpy(), rtol=1e-6)


def test_density_matches_dense_construction():
    _, q = _pair()
    dense = avt.FullRankGaussian(q.location, q.scale_matrix())
    z = q.sample(0, 128)
    assert_allclose(q.log_prob(z).numpy(), dense.log_prob(z).numpy(), rtol=1e-5, atol=1e-5)
    assert_allclose(float(q.entropy()), float(dense.entropy()), rtol=1e-6)
    zs = q.sample(1, 200_000)
    assert_allclose(np.cov(zs.numpy().T), q.cov().numpy(), atol=0.03)
    assert_allclose(float(q.log_prob(z[0])), float(dense.log_prob(z[0])), rtol=1e-5)


def test_advi_recovers_block_covariance():
    """ADVI on a block-structured Gaussian recovers each block's covariance
    (which mean-field cannot) and an ELBO near 0."""
    rho = 0.8
    block = torch.tensor([[1.0, 0.0], [rho, (1 - rho ** 2) ** 0.5]])
    L = torch.block_diag(block, 0.5 * block)
    mu = torch.tensor([1.0, -1.0, 0.5, 0.0])
    target = NormalTarget(mu=mu, scale_tril=L)
    q0 = avt.BlockDiagGaussian(torch.zeros(4), n_blocks=2)
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=16, optimizer=avt.adam(1e-2),
                                  operator=avt.ClipScale())
    q, infos, _ = avt.optimize(0, alg, 3000, target, q0, log_every=1000)
    assert_allclose(q.location.numpy(), mu.numpy(), atol=0.02)
    assert_allclose(q.cov().numpy(), (L @ L.T).numpy(), atol=0.03)
    e = float(avt.RepGradELBO(n_samples=20_000, entropy=avt.MONTE_CARLO)
              .estimate_objective(5, q, target))
    assert abs(e) < 0.02, e


def test_constructor_validation_and_block_axis():
    with pytest.raises(ValueError, match="divisible"):
        avt.BlockDiagGaussian(torch.zeros(5), n_blocks=2)
    with pytest.raises(ValueError, match="scales"):
        avt.BlockDiagGaussian(torch.zeros(6), torch.ones((2, 2, 2)))
    with pytest.raises(ValueError, match="n_blocks"):
        avt.BlockDiagGaussian(torch.zeros(6))
    # block_axis is taken, and outside a mesh with that axis it changes no bit
    q = avt.BlockDiagGaussian(torch.arange(4.0), 1.5 * torch.eye(2).expand(2, 2, 2))
    qb = avt.BlockDiagLocationScale(q.location, q.scales, block_axis="mc")
    assert qb.block_axis == "mc"
    assert torch.equal(qb.sample(3, 5), q.sample(3, 5))
    z = q.sample(3, 5)
    assert torch.equal(qb.log_prob(z), q.log_prob(z)) and torch.equal(qb.entropy(), q.entropy())


def test_with_iwelbo_and_clipscale():
    target, mu, L = normal_fullrank(9, 4, device=CPU)
    q0 = avt.BlockDiagGaussian(torch.zeros(4), n_blocks=2)
    alg = avt.KLMinIWRepGradDescent(n_samples=8, optimizer=avt.adam(1e-2),
                                    operator=avt.ClipScale())
    q, infos, _ = avt.optimize(0, alg, 500, target, q0, log_every=100)
    assert np.isfinite(infos[-1]["elbo"])
    assert (torch.diagonal(q.scales, dim1=-2, dim2=-1) >= 1e-5).all()


def test_clipscale_and_prox_match_jax():
    """Both operators move each block's diagonal by a delta * eye add, as
    JAX's: ClipScale to epsilon, the prox by the step size."""
    loc, scales = _params()
    scales[1, 0, 0] = -0.3
    scales[2, 1, 1] = 1e-7
    jq = javt.BlockDiagGaussian(jnp.asarray(loc), jnp.asarray(scales))
    tq = convert.blockdiag_from_numpy(loc, scales, device=CPU)
    jc, tc = javt.ClipScale().apply(jq, None), avt.ClipScale().apply(tq, None)
    assert_allclose(tc.scales.numpy(), np.asarray(jc.scales), rtol=0, atol=0)
    jp = javt.ProximalLocationScaleEntropy().apply(jq, javt.descent(0.1).init(jq))
    tp = avt.ProximalLocationScaleEntropy().apply(tq, avt.descent(0.1).init(tq))
    assert_allclose(tp.scales.numpy(), np.asarray(jp.scales), rtol=1e-6)


def test_proximal_descent():
    target, mu, L = normal_fullrank(9, 4, device=CPU)
    q0 = avt.BlockDiagGaussian(torch.zeros(4), n_blocks=2)
    q, infos, _ = avt.optimize(0, avt.KLMinRepGradProxDescent(n_samples=8), 1500, target, q0,
                               log_every=500)
    assert np.isfinite(infos[-1]["elbo"])
    assert float((q.location - mu).norm()) < 0.1
    assert (torch.diagonal(q.scales, dim1=-2, dim2=-1) > 0).all()
