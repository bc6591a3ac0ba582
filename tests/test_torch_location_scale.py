"""Port parity: the mean-field Gaussian family and its sampler
(advancedvi_jl_tpu_torch.families.location_scale,
ops/cuda/location_scale_kernels.py) against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
from advancedvi_jl_tpu.objectives import entropy as jent
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.core.pytree import tree_stop_gradient
from advancedvi_jl_tpu_torch.families.location_scale import (
    MeanFieldGaussian,
    MeanFieldLocationScale,
    is_location_scale,
)
from advancedvi_jl_tpu_torch.objectives import entropy as tent
from advancedvi_jl_tpu_torch.objectives.repgradelbo import RepGradELBO
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    PhiloxKey,
    meanfield_sample,
    meanfield_sample_cuda,
    meanfield_sample_raw,
    meanfield_sample_reference,
    philox_normals_reference,
    seed_words,
)

torch.set_num_threads(1)

D, N = 62, 10


@pytest.fixture(scope="module")
def families():
    rng = np.random.default_rng(0)
    loc = rng.standard_normal(D).astype(np.float32)
    scale = (0.2 + rng.random(D)).astype(np.float32)
    return javt.MeanFieldGaussian(jnp.asarray(loc), jnp.asarray(scale)), \
        convert.meanfield_from_numpy(loc, scale)


def test_injected_draw_matches_jax(families):
    jq, tq = families
    z_j, u_j = jq.sample_with_base(jax.random.key(3), N)
    z_t, u_t = RepGradELBO(n_samples=N)._draw_with_base(
        tq, None, convert.to_tensor(u_j)
    )
    assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6, atol=1e-7)
    assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=0)


def test_sampler_draw_matches_jax_affine_map(families):
    jq, tq = families
    z, u = tq.sample_with_base(PhiloxKey(seed_words(4), 2), N)
    want = np.asarray(jnp.asarray(u.numpy()) * jq.scale_diag + jq.location)
    assert_allclose(z.numpy(), want, rtol=1e-6, atol=1e-7)
    assert torch.equal(u, philox_normals_reference(seed_words(4), 2, N, D))


def test_log_prob_entropy_and_moments_match_jax(families):
    jq, tq = families
    z = np.random.default_rng(1).standard_normal((N, D)).astype(np.float32)
    assert_allclose(tq.log_prob(torch.from_numpy(z)).numpy(),
                    np.asarray(jq.log_prob(jnp.asarray(z))), rtol=1e-6)
    assert_allclose(float(tq.entropy()), float(jq.entropy()), rtol=1e-6)
    assert_allclose(float(tq.log_det_scale()), float(jq.log_det_scale()), rtol=1e-6)
    for name in ("mean", "var", "cov", "scale_matrix"):
        assert_allclose(getattr(tq, name)().numpy(), np.asarray(getattr(jq, name)()),
                        rtol=1e-6, atol=1e-7, err_msg=name)
    V = np.random.default_rng(2).standard_normal((N, D)).astype(np.float32)
    assert_allclose(tq.apply_inv_scale_T(torch.from_numpy(V)).numpy(),
                    np.asarray(jq.apply_inv_scale_T(jnp.asarray(V))), rtol=1e-6)


def test_sampler_gradient_matches_jax_grad(families):
    """The autograd.Function backward (dm = sum ct, dsigma = sum ct u)
    against jax.grad of sum(w * (u * sigma + m)) at the same u."""
    jq, tq = families
    w = np.random.default_rng(5).standard_normal((N, D)).astype(np.float32)
    loc = tq.location.clone().requires_grad_(True)
    scale = tq.scale_diag.clone().requires_grad_(True)
    z, u = meanfield_sample(seed_words(9), 1, loc, scale, N)
    assert not u.requires_grad
    (torch.from_numpy(w) * z).sum().backward()
    uj, wj = jnp.asarray(u.numpy()), jnp.asarray(w)
    gm, gs = jax.grad(lambda m, s: jnp.sum(wj * (uj * s + m)), argnums=(0, 1))(
        jq.location, jq.scale_diag
    )
    assert_allclose(loc.grad.numpy(), np.asarray(gm), rtol=1e-6, atol=1e-6)
    assert_allclose(scale.grad.numpy(), np.asarray(gs), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("estimator", ["closed_form", "monte_carlo", "stl"])
@pytest.mark.parametrize("from_draw", [False, True], ids=["samples", "draw"])
def test_entropy_estimators_match_jax(families, estimator, from_draw):
    """Value and gradient in (location, scale) of each estimator at the
    same base draw, through the samples path and the solve-free path."""
    jq, tq = families
    u = np.random.default_rng(7).standard_normal((N, D)).astype(np.float32)

    def jfn(q):
        z = jnp.asarray(u) * q.scale_diag + q.location
        qs = jax.lax.stop_gradient(q)
        if from_draw:
            return jent.estimate_entropy_from_draw(estimator, z, jnp.asarray(u), q, qs)
        return jent.estimate_entropy(estimator, z, q, qs)

    jval, jgrad = jax.value_and_grad(jfn)(jq)
    loc = tq.location.clone().requires_grad_(True)
    scale = tq.scale_diag.clone().requires_grad_(True)
    q = MeanFieldGaussian(loc, scale)
    ut = torch.from_numpy(u)
    z = ut * scale + loc
    if from_draw:
        val = tent.estimate_entropy_from_draw(estimator, z, ut, q, tree_stop_gradient(q))
    else:
        val = tent.estimate_entropy(estimator, z, q, tree_stop_gradient(q))
    gl, gs = torch.autograd.grad(val, (loc, scale), allow_unused=True,
                                 materialize_grads=True)
    assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    assert_allclose(gl.numpy(), np.asarray(jgrad.location), rtol=1e-5, atol=1e-6)
    assert_allclose(gs.numpy(), np.asarray(jgrad.scale_diag), rtol=1e-5, atol=1e-6)


def test_constructor_and_checks():
    q = MeanFieldGaussian(torch.zeros(3))
    assert isinstance(q, MeanFieldLocationScale) and is_location_scale(q)
    assert torch.equal(q.scale_diag, torch.ones(3))
    assert q.dim == 3
    assert not is_location_scale(object())
    with pytest.raises(ValueError, match="float32"):
        MeanFieldGaussian(torch.zeros(3, dtype=torch.float64)).sample_with_base(0, 2)


def test_wrapper_routes_by_device_without_fallback():
    """CPU tensors take the plain version; a CUDA-only wrapper refuses CPU
    tensors; any other device raises instead of moving data."""
    seed = seed_words(1)
    loc, scale = torch.zeros(D), torch.ones(D)
    z, u = meanfield_sample_raw(seed, 0, loc, scale, N)
    zr, ur = meanfield_sample_reference(seed, 0, loc, scale, N)
    assert torch.equal(z, zr) and torch.equal(u, ur)
    with pytest.raises(ValueError, match="GPU"):
        meanfield_sample_cuda(seed, 0, loc, scale, N)
    with pytest.raises(ValueError, match="device"):
        meanfield_sample_raw(seed, 0, loc.to("meta"), scale.to("meta"), N)
