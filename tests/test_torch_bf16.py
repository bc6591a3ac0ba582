"""Port parity: ``compute_dtype="bfloat16"`` of the full-rank family (the
sampling product of csrc/fullrank_bf16.cu, after K7b's draw launch or on
injected draws) and of the BNN's forward products, against the JAX
package's mixed-precision matmuls.  Here the product runs its plain PyTorch
version (CPU tensors); the kernel is held to it on a card
(tests/test_torch_kernels.py).

The rounding points are the JAX package's: z = bf16(u) bf16(tril C)^T summed
in the parameters' dtype, u unrounded; the gradient of a bf16 operand is a
float32 sum rounded to bfloat16 (so every entry of dC is bf16-representable)
and dm is unrounded.  Two frameworks sum a dot product in different orders,
so a float32 sum lying near a bf16 rounding boundary may round one ulp apart:
the bar for a bf16-rounded gradient is one bf16 ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.models.bnn import make_bnn as jax_make_bnn
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.models.normal import normal_fullrank
from advancedvi_jl_tpu_torch.ops.cuda import location_scale_kernels as lsk

CPU = "cpu"
KEY = 5


def _bf16_ulp(x) -> np.ndarray:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    x = np.abs(np.asarray(x, dtype=np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(x, np.finfo(np.float32).tiny))) - 7)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pair(d, seed=0, dtype=np.float32):
    """Numpy location and lower-triangular scale of a full-rank family."""
    rng = np.random.default_rng(seed)
    loc = (0.5 * rng.standard_normal(d)).astype(dtype)
    C = (np.tril(0.3 * rng.standard_normal((d, d)), -1) + np.diag(0.5 + rng.random(d))
         ).astype(dtype)
    return loc, C


def _families(d, seed=0, **kw):
    loc, C = _pair(d, seed)
    jq = javt.FullRankLocationScale(jnp.asarray(loc), jnp.asarray(C), compute_dtype="bfloat16")
    tq = convert.fullrank_from_numpy(loc, C, device=CPU, compute_dtype="bfloat16", **kw)
    return jq, tq


@pytest.mark.parametrize("d,n", [(16, 64), (62, 10), (100, 33), (257, 7)])
def test_z_matches_jax_compute_dtype_on_the_same_draws(d, n):
    """JAX's draws injected: the port's z against JAX's compute_dtype z at
    rtol 1e-5 norm-wise (the same bf16 products, f32 sums in another
    order); u passes through unrounded."""
    jq, tq = _families(d)
    jz, ju = jq.sample_with_base(jax.random.key(KEY), n)
    z = tq.from_base(torch.from_numpy(np.array(ju)))
    assert z.dtype == torch.float32
    assert _rel(z.numpy(), jz) <= 1e-5
    # and the plain version of the kernel is the same function
    ref = lsk.fullrank_bf16_reference(torch.from_numpy(np.array(ju)), tq.location, tq.scale)
    assert torch.equal(ref, z)


@pytest.mark.parametrize("d,n", [(16, 64), (62, 10)])
def test_kernel_route_draws_unrounded_u_and_the_bf16_product(d, n):
    """On the kernel route (a float32 Normal family) u is K7b's draw, the
    same bits as the float32 family's, and z is JAX's bf16 formula on it."""
    _, tq = _families(d)
    q32 = avt.FullRankLocationScale(tq.location, tq.scale)
    key = lsk.PhiloxKey(lsk.seed_words(3), 7)
    z, u = tq.sample_with_base(key, n)
    _, u32 = q32.sample_with_base(key, n)
    assert torch.equal(u, u32)
    ub = jnp.asarray(u.numpy()).astype(jnp.bfloat16)
    Cb = jnp.tril(jnp.asarray(tq.scale.numpy())).T.astype(jnp.bfloat16)
    want = jnp.matmul(ub, Cb, preferred_element_type=jnp.float32) + jnp.asarray(
        tq.location.numpy())
    assert _rel(z.numpy(), want) <= 1e-5
    # rows at an offset: the whole draw's rows
    zr, ur = tq.sample_with_base(key, n, rows=(2, n - 3))
    assert torch.equal(ur, u[2:n - 1])
    assert_allclose(zr.numpy(), z[2:n - 1].numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("d,n", [(16, 64), (62, 10), (100, 33)])
def test_gradient_is_jax_bf16_rounded_gradient(d, n):
    """d/dC and d/dm of sum(w z) on JAX's draws: dC is a bf16-rounded
    float32 sum (every entry bf16-representable, lower triangular), within
    one bf16 ulp of JAX's; dm, unrounded, at rtol 1e-5."""
    jq, tq = _families(d)
    key = jax.random.key(KEY)
    w = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    jg = jax.grad(lambda q: jnp.sum(jnp.asarray(w) * q.sample_with_base(key, n)[0]))(jq)
    u = torch.from_numpy(np.array(jq.sample_with_base(key, n)[1]))
    loc = tq.location.clone().requires_grad_(True)
    C = tq.scale.clone().requires_grad_(True)
    z = lsk.fullrank_bf16(u, loc, C)
    gm, gC = torch.autograd.grad((torch.from_numpy(w) * z).sum(), [loc, C])
    assert torch.equal(gC, lsk.bf16_round(gC)) and torch.equal(gC, torch.tril(gC))
    diff = np.abs(gC.numpy() - np.asarray(jg.scale))
    assert (diff <= _bf16_ulp(np.asarray(jg.scale))).all(), diff.max()
    # the mismatches are rare: at most a few entries round the other way
    assert int((diff > 0).sum()) <= max(2, d * d // 200)
    assert_allclose(gm.numpy(), np.asarray(jg.location), rtol=1e-5, atol=1e-6)


def test_gradient_through_a_column_range_is_the_whole_gradient():
    """The bf16 product over column ranges: each range's z is the whole
    product's columns (rtol 1e-6: a matmul of another width sums in another
    order), its gradient covers its rows of C and entries of m only, and the
    ranges' gradients make the whole product's (dC within one bf16 ulp)."""
    d, n = 37, 9
    _, tq = _families(d)
    u = torch.randn(n, d, generator=torch.Generator().manual_seed(2))
    w = torch.randn(n, d, generator=torch.Generator().manual_seed(3))
    loc = tq.location.clone().requires_grad_(True)
    C = tq.scale.clone().requires_grad_(True)
    gm, gC = torch.autograd.grad((w * lsk.fullrank_bf16(u, loc, C)).sum(), [loc, C])
    sm, sC = torch.zeros(d), torch.zeros(d, d)
    for c0, nc in ((0, 10), (10, 9), (19, 18)):
        z = lsk.fullrank_bf16(u, loc, C, (c0, nc))
        assert z.shape == (n, nc)
        assert_allclose(z.detach().numpy(), lsk.fullrank_bf16(u, loc, C)[:, c0:c0 + nc]
                        .detach().numpy(), rtol=1e-6, atol=1e-6)
        a, b = torch.autograd.grad((w[:, c0:c0 + nc] * z).sum(), [loc, C])
        assert not b[:c0].any() and not b[c0 + nc:].any()
        sm, sC = sm + a, sC + b
    assert (np.abs(sC.numpy() - gC.numpy()) <= _bf16_ulp(gC.numpy())).all()
    assert_allclose(sm.numpy(), gm.numpy(), rtol=1e-6)


def test_log_prob_and_entropy_are_the_float32_familys():
    """JAX's test_fullrank_compute_dtype_bf16: output float32, u equal to the
    f32 path's, z within bf16 resolution of it (rtol, atol 2e-2), log_prob
    and entropy bit for bit the f32 family's, in every solve mode."""
    d = 16
    rng = np.random.default_rng(0)
    A = (0.3 * rng.standard_normal((d, d))).astype(np.float32)
    C = torch.from_numpy(np.tril(A, -1) + np.eye(d, dtype=np.float32))
    loc = torch.arange(d, dtype=torch.float32)
    for mode in ("solve", "inverse", "pallas"):
        q32 = avt.FullRankGaussian(loc, C, solve_mode=mode)
        qbf = avt.FullRankGaussian(loc, C, compute_dtype="bfloat16", solve_mode=mode)
        z32, u32 = q32.sample_with_base(KEY, 64)
        zbf, ubf = qbf.sample_with_base(KEY, 64)
        assert zbf.dtype == torch.float32 and torch.equal(u32, ubf)
        assert_allclose(zbf.numpy(), z32.numpy(), rtol=2e-2, atol=2e-2)
        assert torch.equal(q32.log_prob(z32), qbf.log_prob(z32))
        assert torch.equal(q32.entropy(), qbf.entropy())
        assert torch.equal(q32.apply_inv_scale_T(z32), qbf.apply_inv_scale_T(z32))


def test_pallas_sampler_ignores_compute_dtype_as_jax():
    """JAX's Pallas sampler draws in float32 whatever compute_dtype says:
    ``sampler="pallas"`` with bfloat16 is the float32 K7b product."""
    loc, C = (torch.from_numpy(a) for a in _pair(20))
    q = avt.FullRankGaussian(loc, C, sampler="pallas", compute_dtype="bfloat16")
    q32 = avt.FullRankGaussian(loc, C, sampler="pallas")
    assert all(torch.equal(a, b) for a, b in zip(q.sample_with_base(KEY, 8),
                                                 q32.sample_with_base(KEY, 8)))


def test_packed_layout_and_other_bases_take_the_bf16_product():
    """A packed factor and a Student-t base (ops/base_draws.py's draws,
    from_base) go through the same bf16 product."""
    loc, C = (torch.from_numpy(a) for a in _pair(20))
    qd = avt.FullRankGaussian(loc, C, compute_dtype="bfloat16")
    qp = avt.FullRankGaussian(loc, C, compute_dtype="bfloat16", layout="packed")
    z, u = qd.sample_with_base(KEY, 6)
    assert torch.equal(qp.from_base(u), z)
    qt = avt.FullRankLocationScale(loc, C, base=avt.StudentT(5.0), compute_dtype="bfloat16")
    zt, ut = qt.sample_with_base(KEY, 6)
    assert torch.equal(zt, lsk.fullrank_bf16_reference(ut, loc, C))


def test_float64_family_sums_in_float64_as_jax():
    """A float64 family: bf16-rounded operands, the sums in float64, against
    JAX's compute_dtype under x64 (rtol 1e-12)."""
    d, n = 30, 12
    loc, C = _pair(d, dtype=np.float64)
    u = np.random.default_rng(4).standard_normal((n, d))
    tq = convert.fullrank_from_numpy(loc, C, device=CPU, dtype=torch.float64,
                                     compute_dtype="bfloat16")
    z = tq.from_base(torch.from_numpy(u))
    assert z.dtype == torch.float64
    with jax.enable_x64(True):
        want = jnp.matmul(jnp.asarray(u).astype(jnp.bfloat16),
                          jnp.asarray(np.tril(C)).T.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float64) + jnp.asarray(loc)
        want = np.asarray(want)
    assert_allclose(z.numpy(), want, rtol=1e-12, atol=1e-12)


def test_advi_runs_on_the_bf16_family():
    """Full-rank ADVI with compute_dtype through ``optimize``: finite ELBO
    rows, the tail near the float32 run's on one key."""
    target, _, _ = normal_fullrank(3, 8, device=CPU)
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=16, optimizer=avt.adam(1e-2),
                                  operator=avt.ClipScale())
    tails = {}
    for cdt in (None, "bfloat16"):
        q0 = avt.FullRankGaussian(torch.zeros(8), compute_dtype=cdt)
        _, rows, _ = avt.optimize(0, alg, 300, target, q0, log_every=10)
        elbos = [r["elbo"] for r in rows]
        assert all(np.isfinite(elbos))
        tails[cdt] = float(np.mean(elbos[-10:]))
    assert abs(tails["bfloat16"] - tails[None]) < 0.5, tails


def _bnns(compute_dtype="bfloat16", n_data=64, in_dim=8, hidden=16):
    jb = jax_make_bnn(jax.random.key(1), n_data=n_data, in_dim=in_dim, hidden=hidden)
    jb = jb.replace(compute_dtype=compute_dtype)
    tb = convert.bnn_from_numpy(np.asarray(jb.X), np.asarray(jb.y), float(jb.likeadj),
                                hidden=hidden, device=CPU, compute_dtype=compute_dtype)
    return jb, tb


def test_bnn_log_density_and_gradient_match_jax_bf16():
    """The BNN's bf16 forward against JAX's: the log density at rtol 1e-5
    (the same bf16 operands, float32 sums in another order).  The gradient
    rounds where JAX's does: the weight matrices' likelihood gradients are
    float32 sums rounded to bf16, the prior's -theta added after in float32;
    so each entry lies within one bf16 ulp of the likelihood part (a sum near
    a boundary may round the other way) plus float32 round-off, and the
    whole within 1e-3 norm-wise (a one-ulp flip is 2^-8 of an entry)."""
    jb, tb = _bnns()
    th = (0.3 * np.random.default_rng(2).standard_normal((4, tb.dim))).astype(np.float32)
    jv, jg = jax.vmap(jax.value_and_grad(jb.log_density))(jnp.asarray(th))
    tv, tg = avt.log_density_and_grad(tb, torch.from_numpy(th))
    assert tv.dtype == torch.float32
    assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)
    jg = np.asarray(jg)
    like = jg + th  # the likelihood's part: the prior's gradient is -theta
    diff = np.abs(tg.numpy() - jg)
    assert (diff <= _bf16_ulp(like) + 1e-5 * np.abs(jg) + 1e-6).all(), diff.max()
    assert _rel(tg.numpy(), jg) <= 1e-3
    # against the float32 model's gradient the bf16 one differs by far more
    _, g32 = avt.log_density_and_grad(tb.replace(compute_dtype=None), torch.from_numpy(th))
    assert _rel(g32.numpy(), jg) > 10 * _rel(tg.numpy(), jg)


def test_bnn_bf16_compute_dtype_bars_of_jax():
    """JAX's test_bnn_bf16_compute_dtype: float32 in and out, the f32
    forward within rtol 2e-2, and subsample() keeps the field."""
    _, tb = _bnns()
    tb32 = tb.replace(compute_dtype=None)
    theta = 0.1 * torch.randn(tb.dim, generator=torch.Generator().manual_seed(0))
    ld32, ld16 = float(tb32.log_density(theta)), float(tb.log_density(theta))
    assert tb.log_density(theta).dtype == torch.float32
    assert_allclose(ld16, ld32, rtol=2e-2)
    sub = tb.subsample(torch.arange(16))
    assert sub.compute_dtype == "bfloat16" and float(sub.likeadj) == 4.0
