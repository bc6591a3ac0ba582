"""Port parity of the transforms (advancedvi_jl_tpu_torch.core.transforms)
against the JAX package's (tests/test_transforms.py's genre): the same
inputs, made by numpy from a seed, through both; the port's batched calls
against JAX's vmap of one vector at a time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.core import transforms as jtf
from advancedvi_jl_tpu_torch.core import transforms as ttf

torch.set_num_threads(1)

# the values are of order 1; atol: a few float32 ulps where lo + width s
# lands near 0, and torch's and XLA's sigmoid differ in their last bit
TOL = dict(rtol=1e-6, atol=1e-6)
BATCH = 5


def _pairs():
    """(name, JAX transform, port transform, unconstrained width)."""
    return [
        ("softplus", javt.Softplus(), avt.Softplus(), 6),
        ("sigmoid", javt.Sigmoid(lo=-2.0, hi=3.0), avt.Sigmoid(lo=-2.0, hi=3.0), 6),
        ("unit_sigmoid", javt.Sigmoid(), avt.Sigmoid(), 4),
        ("simplex", javt.StickBreakingSimplex(), avt.StickBreakingSimplex(), 4),
        ("ordered", javt.Ordered(), avt.Ordered(), 5),
        ("blockwise_simplex",
         jtf.Blockwise(inner=javt.StickBreakingSimplex(), n_blocks=3, block_in=2, block_out=3),
         ttf.Blockwise(inner=avt.StickBreakingSimplex(), n_blocks=3, block_in=2, block_out=3),
         6),
        ("stacked_simplex",
         javt.stacked((javt.Identity(), 2), (javt.StickBreakingSimplex(), 3),
                      (javt.Softplus(), 1)),
         avt.stacked((avt.Identity(), 2), (avt.StickBreakingSimplex(), 3), (avt.Softplus(), 1)),
         6),
    ]


PAIRS = _pairs()
IDS = [p[0] for p in PAIRS]


def _x(d, seed, n=None):
    rng = np.random.default_rng(seed)
    shape = (d,) if n is None else (n, d)
    return (1.3 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("name,jt,tt,d", PAIRS, ids=IDS)
def test_forward_and_ldj_match_jax(name, jt, tt, d):
    x = _x(d, 1)
    jy, jl = jt.forward_and_ldj(jnp.asarray(x))
    ty, tl = tt.forward_and_ldj(torch.from_numpy(x))
    assert ty.shape == jy.shape and tl.shape == ()
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert_allclose(float(tl), float(jl), **TOL)


@pytest.mark.parametrize("name,jt,tt,d", PAIRS, ids=IDS)
def test_batched_rows_are_jax_vmap(name, jt, tt, d):
    """(n, d) in one call: each row's value and its own Jacobian."""
    x = _x(d, 2, BATCH)
    jy, jl = jax.vmap(jt.forward_and_ldj)(jnp.asarray(x))
    ty, tl = tt.forward_and_ldj(torch.from_numpy(x))
    assert tl.shape == (BATCH,)
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("name,jt,tt,d", PAIRS, ids=IDS)
def test_inverse_matches_jax_and_round_trips(name, jt, tt, d):
    x = _x(d, 3)
    y = np.array(jt.forward(jnp.asarray(x)))
    jx = np.asarray(jt.inverse(jnp.asarray(y)))
    tx = tt.inverse(torch.from_numpy(y)).numpy()
    assert_allclose(tx, jx, rtol=1e-6, atol=1e-6)
    assert_allclose(tx, x, rtol=1e-4, atol=1e-5)
    yb = tt.forward(torch.from_numpy(_x(d, 4, BATCH)))
    assert tt.inverse(yb).shape == (BATCH, d)


@pytest.mark.parametrize("name,jt,tt,d", PAIRS, ids=IDS)
def test_ldj_is_the_log_det_of_autograds_jacobian(name, jt, tt, d):
    """In float64, the ldj is log |det J| of the forward map (the free
    coordinates of the simplices: each block's last entry is determined)."""
    x = torch.from_numpy(_x(d, 5)).double()
    keep = {"simplex": lambda y: y[:-1],
            "blockwise_simplex": lambda y: y.reshape(3, 3)[:, :2].reshape(-1),
            "stacked_simplex": lambda y: torch.cat([y[:5], y[6:]])}.get(name, lambda y: y)
    J = torch.autograd.functional.jacobian(lambda v: keep(tt.forward(v)), x)
    _, logdet = torch.linalg.slogdet(J)
    assert_allclose(float(tt.forward_and_ldj(x)[1]), float(logdet), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name,jt,tt,d", PAIRS, ids=IDS)
def test_unconstrained_dim_matches_jax(name, jt, tt, d):
    n_out = int(jt.forward(jnp.zeros(d)).shape[0])
    assert tt.unconstrained_dim(n_out) == jt.unconstrained_dim(n_out) == d


def test_simplex_rows_are_simplices():
    y = avt.StickBreakingSimplex().forward(torch.from_numpy(_x(4, 6, 7)))
    assert y.shape == (7, 5) and bool((y > 0).all())
    assert_allclose(y.sum(-1).numpy(), np.ones(7), rtol=1e-6)


def test_ordered_is_increasing():
    y = avt.Ordered().forward(torch.from_numpy(_x(6, 7, 3)))
    assert bool((torch.diff(y, dim=-1) > 0).all())


def _families(d, seed):
    rng = np.random.default_rng(seed)
    loc = (0.3 * rng.standard_normal(d)).astype(np.float32)
    sd = (0.2 + 0.5 * rng.random(d)).astype(np.float32)
    return (javt.MeanFieldGaussian(jnp.asarray(loc), jnp.asarray(sd)),
            avt.MeanFieldGaussian(torch.from_numpy(loc), torch.from_numpy(sd)))


@pytest.mark.parametrize("name,jt,tt,d", PAIRS, ids=IDS)
def test_transformed_distribution_log_prob_matches_jax(name, jt, tt, d):
    """Constrained density at one point and at a batch (each row its own
    Jacobian, tests/test_integration.py:240's regression)."""
    jq, tq = _families(d, 8)
    jd = javt.TransformedDistribution(base=jq, transform=jt)
    td = avt.TransformedDistribution(base=tq, transform=tt)
    ys = np.array(jax.vmap(jt.forward)(jnp.asarray(_x(d, 9, BATCH))))
    assert_allclose(td.log_prob(torch.from_numpy(ys)).numpy(),
                    np.asarray(jd.log_prob(jnp.asarray(ys))), rtol=1e-5, atol=1e-5)
    assert_allclose(float(td.log_prob(torch.from_numpy(ys[0]))),
                    float(jd.log_prob(jnp.asarray(ys[0]))), rtol=1e-5, atol=1e-5)


def test_transformed_distribution_samples_the_support():
    _, tq = _families(4, 10)
    td = avt.TransformedDistribution(base=tq, transform=avt.Softplus())
    z = td.sample(3, 1000)
    assert z.shape == (1000, 4) and bool((z > 0).all())
    zs = avt.TransformedDistribution(base=_families(3, 11)[1],
                                     transform=avt.StickBreakingSimplex()).sample(3, 100)
    assert zs.shape == (100, 4)
    assert_allclose(zs.sum(-1).numpy(), np.ones(100), rtol=1e-5)
