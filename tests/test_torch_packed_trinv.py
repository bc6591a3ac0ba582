"""Port parity: the tile-packed scale layout (ops/packing.py,
``layout="packed"``) and the level-parallel triangular inverse
(ops/trinv.py, ``solve_mode="inverse"``) against the JAX package (its
tests/test_packed.py and tests/test_trinv.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.algorithms.measure_space import (
    KLMinNaturalGradDescent as JaxNGD,
)
from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank
from advancedvi_jl_tpu.ops import packing as jpacking
from advancedvi_jl_tpu.ops import trinv as jtrinv
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.models.normal import normal_fullrank
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import PhiloxKey, seed_words
from advancedvi_jl_tpu_torch.ops.packing import (
    default_block,
    n_tiles,
    packed_diag,
    packed_shape,
    packed_with_diag,
    tril_pack,
    tril_unpack,
)
from advancedvi_jl_tpu_torch.ops.trinv import supports_blocked_inverse, tril_inverse

torch.set_num_threads(2)


def _factor(d, diag=1.3, off=None, seed=0):
    off = 0.3 / d**0.5 if off is None else off
    A = np.random.default_rng(seed).standard_normal((d, d)) * off
    return (np.tril(A, -1) + diag * np.eye(d)).astype(np.float32)


@pytest.mark.parametrize("d", [1, 5, 64, 130, 256])
def test_pack_unpack_roundtrip_is_jax_layout(d):
    """Bitwise JAX's packed array; unpack gives the factor back; pack reads
    the lower triangle only."""
    C = _factor(d)
    v = tril_pack(torch.from_numpy(C))
    assert tuple(v.shape) == packed_shape(d) == jpacking.packed_shape(d)
    assert np.array_equal(v.numpy(), np.asarray(jpacking.tril_pack(jnp.asarray(C))))
    assert torch.equal(tril_unpack(v, d), torch.from_numpy(C))
    noise = np.triu(np.random.default_rng(1).standard_normal((d, d)), 1).astype(np.float32)
    assert torch.equal(tril_pack(torch.from_numpy(C + noise)), v)
    assert (default_block(d), n_tiles(d)) == (jpacking.default_block(d), jpacking.n_tiles(d))


@pytest.mark.parametrize("d", [9, 130])
def test_pack_unpack_gradients(d):
    """Autograd through pack and unpack equals the tril mask's adjoint, and
    unpack's gradient equals JAX's (each tile entry reached once: no
    scatter adds duplicates)."""
    C = torch.from_numpy(_factor(d))
    W = torch.from_numpy(np.random.default_rng(2).standard_normal((d, d)).astype(np.float32))

    def grad(fn, x):
        x = x.clone().requires_grad_(True)
        val = fn(x)
        return float(val.detach()), torch.autograd.grad(val, x)[0]

    vp, gp = grad(lambda c: torch.sum(torch.sin(tril_unpack(tril_pack(c), d)) * W), C)
    vt, gt = grad(lambda c: torch.sum(torch.sin(torch.tril(c)) * W), C)
    assert_allclose(vp, vt, rtol=1e-6)
    assert_allclose(gp.numpy(), gt.numpy(), rtol=1e-6, atol=1e-7)
    v = tril_pack(C)
    _, gv = grad(lambda v_: torch.sum(torch.sin(tril_unpack(v_, d)) * W), v)
    jgv = jax.grad(lambda v_: jnp.sum(jnp.sin(jpacking.tril_unpack(v_, d)) * jnp.asarray(
        W.numpy())))(jnp.asarray(v.numpy()))
    assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-6, atol=1e-7)
    assert_allclose(tril_unpack(gv, d).numpy(), gt.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("d", [17, 130])
def test_packed_diag_helpers(d):
    C = _factor(d)
    v = tril_pack(torch.from_numpy(C))
    assert torch.equal(packed_diag(v, d), torch.from_numpy(np.diag(C).copy()))
    new = torch.arange(1.0, d + 1.0)
    v2 = packed_with_diag(v, d, new)
    jv2 = jpacking.packed_with_diag(jnp.asarray(v.numpy()), d, jnp.asarray(new.numpy()))
    assert np.array_equal(v2.numpy(), np.asarray(jv2))
    C2 = tril_unpack(v2, d)
    assert torch.equal(torch.diagonal(C2), new)
    assert torch.equal(torch.tril(C2, -1), torch.from_numpy(np.tril(C, -1)))


@pytest.mark.parametrize("solve_mode", ["solve", "pallas"])
@pytest.mark.parametrize("d", [5, 64])
def test_family_dense_vs_packed(d, solve_mode):
    """The packed family draws the dense one's z bitwise (K7b's plain version
    reads the unpacked factor), and its densities, entropy, solves and
    covariance equal the dense family's and JAX's packed family's; a JAX
    packed scale converts by np.asarray."""
    C = _factor(d)
    loc = np.random.default_rng(3).standard_normal(d).astype(np.float32)
    qd = avt.FullRankGaussian(torch.from_numpy(loc), torch.from_numpy(C), solve_mode=solve_mode)
    qp = avt.FullRankGaussian(torch.from_numpy(loc), torch.from_numpy(C), solve_mode=solve_mode,
                              layout="packed")
    jqp = javt.FullRankGaussian(jnp.asarray(loc), jnp.asarray(C), layout="packed")
    assert tuple(qp.scale.shape) == packed_shape(d)
    qc = convert.fullrank_from_numpy(loc, np.asarray(jqp.scale), solve_mode=solve_mode,
                                     layout="packed", device="cpu")
    assert torch.equal(qc.scale, qp.scale)
    key = PhiloxKey(seed_words(4), 1)
    zd, ud = qd.sample_with_base(key, 8)
    zp, up = qp.sample_with_base(key, 8)
    assert torch.equal(zd, zp) and torch.equal(ud, up)
    zj = jnp.asarray(zd.numpy())
    assert_allclose(qp.log_prob(zd).numpy(), qd.log_prob(zd).numpy(), rtol=1e-6)
    assert_allclose(qp.log_prob(zd).numpy(), np.asarray(jqp.log_prob(zj)), rtol=1e-5)
    assert_allclose(float(qp.entropy()), float(jqp.entropy()), rtol=1e-6)
    V = torch.from_numpy(np.random.default_rng(4).standard_normal((8, d)).astype(np.float32))
    assert_allclose(qp.apply_inv_scale_T(V).numpy(), qd.apply_inv_scale_T(V).numpy(),
                    rtol=1e-5, atol=1e-6)
    assert_allclose(qp.cov().numpy(), np.asarray(jqp.cov()), rtol=1e-6, atol=1e-7)
    assert torch.equal(qp.scale_diag_view(), qd.scale_diag_view())


def _run(layout, alg, steps, d=12, seed=7):
    target, _, _ = normal_fullrank(3, d, device="cpu")
    q0 = avt.FullRankGaussian(torch.zeros(d), layout=layout)
    return avt.optimize(seed, alg, steps, target, q0, log_every=steps)


def test_advi_trajectory_dense_vs_packed():
    """ADVI + STL + ClipScale, 300 steps: the packed run keeps packed Adam
    moments and lands where the dense run does (atol 1e-5, the JAX
    package's bound)."""
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=8, optimizer=avt.adam(1e-2),
                                  operator=avt.ClipScale())
    (qd, id_, _), (qp, ip, sp) = _run("dense", alg, 300), _run("packed", alg, 300)
    assert tuple(sp.opt_state.mu.scale.shape) == packed_shape(12)
    assert_allclose(qp.location.numpy(), qd.location.numpy(), atol=1e-5)
    assert_allclose(qp.tril_scale().numpy(), qd.tril_scale().numpy(), atol=1e-5)
    assert_allclose(ip[-1]["elbo"], id_[-1]["elbo"], atol=1e-4)


def test_proximal_trajectory_dense_vs_packed():
    """Proximal ADVI (DoWG) acts on the diagonal through with_scale_diag on
    both layouts: 200 steps agree (atol 1e-5)."""
    alg = avt.KLMinRepGradProxDescent(n_samples=8, optimizer=avt.dowg(1e-2))
    (qd, _, _), (qp, _, _) = _run("dense", alg, 200, d=8), _run("packed", alg, 200, d=8)
    assert_allclose(qp.location.numpy(), qd.location.numpy(), atol=1e-5)
    assert_allclose(qp.tril_scale().numpy(), qd.tril_scale().numpy(), atol=1e-5)


def test_clipscale_on_a_packed_family():
    C = _factor(6)
    C[2, 2] = 1e-9
    qp = avt.FullRankGaussian(torch.zeros(6), torch.from_numpy(C), layout="packed")
    out = avt.ClipScale(1e-5).apply(qp, None)
    want = C.copy()
    want[2, 2] = 1e-5
    assert torch.equal(out.tril_scale(), torch.from_numpy(want))


def test_packed_refusals_match_jax():
    """Measure space refuses a packed family with JAX's message, word for
    word; an unknown layout raises as in JAX."""
    d = 6
    jt, mu, L = jax_normal_fullrank(jax.random.key(0), d)
    tt = convert.normal_target_from_numpy(mu, L, device="cpu")
    qp = avt.FullRankGaussian(torch.zeros(d), layout="packed")
    jqp = javt.FullRankGaussian(jnp.zeros(d), layout="packed")
    with pytest.raises(ValueError) as jerr:
        JaxNGD(stepsize=1e-3).init(jax.random.key(0), jqp, jt)
    for alg in (avt.KLMinNaturalGradDescent(stepsize=1e-3), avt.KLMinWassFwdBwd(stepsize=1e-3),
                avt.FisherMinBatchMatch()):
        with pytest.raises(ValueError) as terr:
            alg.init(0, qp, tt)
        assert str(terr.value) == str(jerr.value).replace(
            "KLMinNaturalGradDescent", alg.name)
    with pytest.raises(ValueError) as terr:  # the port refuses it at construction
        avt.FullRankLocationScale(torch.zeros(d), qp.scale, layout="sparse")
    with pytest.raises(ValueError) as jerr:
        jqp.replace(layout="sparse").tril_scale()
    assert str(terr.value) == str(jerr.value)


def test_packed_with_tp_axis_refuses_as_jax():
    """A packed factor cannot be row-sharded: ``tril_scale`` (and so the
    draw) raises JAX's ValueError word for word, outside a mesh too (JAX
    tests/test_packed.py:206-209); the dense layout takes ``tp_axis``."""
    import dataclasses

    qp = dataclasses.replace(avt.FullRankGaussian(torch.zeros(6), layout="packed"),
                             tp_axis="mc")
    jqp = javt.FullRankGaussian(jnp.zeros(6), layout="packed").replace(tp_axis="mc")
    with pytest.raises(ValueError) as jerr:
        jqp.tril_scale()
    for call in (qp.tril_scale, lambda: qp.sample(0, 3)):
        with pytest.raises(ValueError) as terr:
            call()
        assert str(terr.value) == str(jerr.value)
    dense = dataclasses.replace(avt.FullRankGaussian(torch.zeros(6)), tp_axis="mc")
    assert torch.equal(dense.tril_scale(), torch.eye(6))


@pytest.mark.parametrize("kw, match", [
    ({"layout": "sparse"}, "layout must be"),
    ({"solve_mode": "typo"}, "solve_mode must be one of"),
    ({"solve_mode": "pallas", "dtype": torch.float64}, "requires float32"),
])
def test_family_refuses_bad_static_fields_at_construction(kw, match):
    """The dataclass itself checks layout and solve_mode, so a family made
    without ``FullRankGaussian`` is refused too, and a valid one stays valid
    through the optimizer's field maps."""
    kw = dict(kw)
    dtype = kw.pop("dtype", torch.float32)
    with pytest.raises(ValueError, match=match):
        avt.FullRankLocationScale(torch.zeros(3, dtype=dtype), torch.eye(3, dtype=dtype), **kw)
    q = avt.FullRankGaussian(torch.zeros(3), solve_mode="pallas", layout="packed")
    state = avt.adam(1e-3).init(q)
    assert state.mu.layout == "packed" and state.mu.solve_mode == "pallas"


def test_cached_layout_serves_every_call():
    """The index tensors and tile mask are made once a (nb, block, device,
    dtype): a repeated unpack, and one in float64, give the same bits as a
    fresh pack's round trip."""
    from advancedvi_jl_tpu_torch.ops import packing

    C = torch.from_numpy(_factor(130))
    v = tril_pack(C)
    first = packing._cached_layout(2, 128, v.device, v.dtype)
    assert packing._cached_layout(2, 128, v.device, v.dtype) is first
    assert torch.equal(tril_unpack(v, 130), C) and torch.equal(tril_unpack(v, 130), C)
    assert torch.equal(tril_unpack(v.double(), 130), C.double())
    assert torch.equal(packed_diag(v, 130), torch.diagonal(C))


@pytest.mark.parametrize("d", [128, 256, 512])
def test_inverse_matches_jax(d):
    """T C = I within JAX's 5e-4; the upper triangle exactly zero; T within
    1e-5 of JAX's inverse."""
    C = _factor(d, diag=1.0)
    T = tril_inverse(torch.from_numpy(C))
    assert supports_blocked_inverse(d)
    assert_allclose((T @ torch.from_numpy(C)).numpy(), np.eye(d), atol=5e-4)
    assert float(torch.triu(T, 1).abs().max()) == 0.0
    assert_allclose(T.numpy(), np.asarray(jtrinv.tril_inverse(jnp.asarray(C))), atol=1e-5)


def test_shape_gate_falls_back():
    for d in (5, 96, 384):
        assert not supports_blocked_inverse(d) and not jtrinv.supports_blocked_inverse(d)
        C = _factor(d, diag=1.0)
        T = tril_inverse(torch.from_numpy(C))
        assert_allclose((T @ torch.from_numpy(C)).numpy(), np.eye(d), atol=5e-4)


def test_inverse_gradients_match_solve():
    d = 256
    C = torch.from_numpy(_factor(d, diag=1.0))
    V = torch.from_numpy(np.random.default_rng(1).standard_normal((8, d)).astype(np.float32))

    def grad(fn):
        c = C.clone().requires_grad_(True)
        val = fn(c)
        return float(val.detach()), torch.autograd.grad(val, c)[0].numpy()

    vi, gi = grad(lambda c: torch.sum(torch.sin(V @ tril_inverse(c))))
    vs, gs = grad(lambda c: torch.sum(torch.sin(torch.linalg.solve_triangular(
        c, V, upper=False, left=False))))
    assert_allclose(vi, vs, rtol=1e-4)
    assert_allclose(gi, gs, rtol=5e-3, atol=1e-4)


@pytest.mark.parametrize("d", [64, 256])
def test_family_inverse_vs_solve(d):
    """log_prob and apply_inv_scale_T agree between the solve modes (JAX's
    tolerances), and with JAX's inverse-mode family."""
    C = _factor(d, diag=1.3)
    loc = np.random.default_rng(2).standard_normal(d).astype(np.float32)
    q_s = avt.FullRankGaussian(torch.from_numpy(loc), torch.from_numpy(C))
    q_i = avt.FullRankGaussian(torch.from_numpy(loc), torch.from_numpy(C), solve_mode="inverse")
    jq_i = javt.FullRankGaussian(jnp.asarray(loc), jnp.asarray(C), solve_mode="inverse")
    z = q_s.sample(PhiloxKey(seed_words(3), 0), 16)
    assert_allclose(q_i.log_prob(z).numpy(), q_s.log_prob(z).numpy(), rtol=2e-4, atol=2e-3)
    assert_allclose(q_i.log_prob(z).numpy(), np.asarray(jq_i.log_prob(jnp.asarray(z.numpy()))),
                    rtol=2e-4, atol=2e-3)
    V = torch.from_numpy(np.random.default_rng(4).standard_normal((16, d)).astype(np.float32))
    assert_allclose(q_i.apply_inv_scale_T(V).numpy(), q_s.apply_inv_scale_T(V).numpy(),
                    rtol=2e-3, atol=2e-3)


def test_stl_trajectory_inverse_vs_solve():
    """ADVI + STL, 400 steps at d = 16: the inverse and solve modes land
    together (JAX's bounds: location 1e-4, ELBO 1e-3)."""
    target, _, _ = normal_fullrank(7, 16, device="cpu")
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=8, optimizer=avt.adam(1e-2),
                                  operator=avt.ClipScale())
    outs = {}
    for mode in ("solve", "inverse"):
        q0 = avt.FullRankGaussian(torch.zeros(16), solve_mode=mode)
        q, infos, _ = avt.optimize(7, alg, 400, target, q0, log_every=400)
        outs[mode] = (q, infos[-1]["elbo"])
    assert_allclose(outs["inverse"][0].location.numpy(), outs["solve"][0].location.numpy(),
                    atol=1e-4)
    assert_allclose(outs["inverse"][1], outs["solve"][1], atol=1e-3)
