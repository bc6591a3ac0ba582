"""The draw route of RepGradELBO and IWELBO: ``q.sample`` unless the family
takes the solve-free entropy from (z, u) (JAX objectives/repgradelbo.py's
``_use_fast``), and the antithetic mirror on the families JAX accepts.

- The location-scale families keep their bits: every loss, gradient and
  step of RepGradELBO (fast entropy on and off) and IWELBO is the one the
  earlier route (``sample_with_base`` for every draw) gives, bit for bit.
- Antithetic draws: JAX's check accepts the block-diagonal and
  per-datapoint families (they have a ``location`` and a symmetric base)
  and refuses the global-local family, the mixtures and the flows with its
  ValueError, whose words the port's match.  The block-diagonal family's
  antithetic loss and gradient match JAX's on JAX's injected draws (rtol
  1e-5).  JAX's mirror 2 m - z broadcasts the per-datapoint family's
  (rows, k) location against the flat (n/2, rows k) draws and raises a
  TypeError; the port mirrors through the flat location, and is held to
  JAX's ELBO formula on the mirrored draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.core.pytree import tree_stop_gradient as jax_stop
from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.core.pytree import tree_leaves
from advancedvi_jl_tpu_torch.models.normal import NormalTarget, normal_fullrank
from advancedvi_jl_tpu_torch.objectives import iwelbo as iwelbo_mod
from advancedvi_jl_tpu_torch.objectives import repgradelbo as rep_mod
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import PhiloxKey

torch.set_num_threads(1)
CPU = "cpu"
D = 6


def _families():
    g = torch.Generator().manual_seed(3)
    loc = 0.3 * torch.randn(D, generator=g)
    sd = 0.5 + torch.rand(D, generator=g)
    C = torch.tril(0.2 * torch.randn(D, D, generator=g)) + torch.eye(D)
    U = 0.1 * torch.randn(D, 2, generator=g)
    return {
        "meanfield": avt.MeanFieldGaussian(loc, sd),
        "studentt": avt.MeanFieldLocationScale(loc, sd, base=avt.StudentT(5.0)),
        "float64": avt.MeanFieldGaussian(loc.double(), sd.double()),
        "fullrank": avt.FullRankGaussian(loc, C),
        "fullrank-pallas": avt.FullRankGaussian(loc, C, solve_mode="pallas"),
        "fullrank-inverse": avt.FullRankGaussian(loc, C, solve_mode="inverse"),
        "lowrank": avt.LowRankGaussian(loc, sd, U),
    }


def _earlier_route(q, key, n, noise=None, rows=None):
    """The draw every objective took before: sample_with_base's z."""
    return rep_mod.draw_with_base(q, key, n, noise, rows)[0]


def _step_bits(obj, q, target):
    grad, _, info = obj.value_and_grad(q, target, PhiloxKey((4, 5), 6))
    return [info["elbo"]] + tree_leaves(grad)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("family", list(_families()))
def test_location_scale_families_keep_their_bits(monkeypatch, family, antithetic, fast):
    q = _families()[family]
    target, _, _ = normal_fullrank(2, D, device=CPU)
    if q.location.dtype == torch.float64:
        target = NormalTarget(mu=target.mu.double(), scale_tril=target.scale_tril.double())
    assert torch.equal(q.sample(PhiloxKey((4, 5), 6), 8),
                       q.sample_with_base(PhiloxKey((4, 5), 6), 8)[0])
    objs = [avt.RepGradELBO(n_samples=8, entropy=e, antithetic=antithetic, fast_entropy=fast)
            for e in ("stl", "monte_carlo", "closed_form")]
    if not antithetic:
        objs += [avt.IWELBO(n_samples=8, dreg=dreg) for dreg in (True, False)]
    new = [_step_bits(o, q, target) for o in objs]
    monkeypatch.setattr(rep_mod, "draw", _earlier_route)
    monkeypatch.setattr(iwelbo_mod, "draw", _earlier_route)
    old = [_step_bits(o, q, target) for o in objs]
    for a_list, b_list in zip(new, old):
        for a, b in zip(a_list, b_list):
            assert torch.equal(a, b)


def test_flagship_steps_keep_their_bits(monkeypatch):
    """Five KLMinRepGradDescent steps (STL, Adam, ClipScale) on the
    mean-field and low-rank families, and five IW steps: the states of the
    two routes are equal bit for bit."""
    target, _, _ = normal_fullrank(2, D, device=CPU)
    fams = _families()
    algs = [avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=8, optimizer=avt.adam(1e-2),
                                    operator=avt.ClipScale(), fast_entropy=fast)
            for fast in (True, False)]
    algs.append(avt.KLMinIWRepGradDescent(n_samples=8, optimizer=avt.adam(1e-2),
                                          operator=avt.ClipScale()))

    def run():
        return [tree_leaves(avt.optimize(0, alg, 5, target, fams[f])[2].q)
                for alg in algs for f in ("meanfield", "lowrank", "fullrank")]

    new = run()
    monkeypatch.setattr(rep_mod, "draw", _earlier_route)
    monkeypatch.setattr(iwelbo_mod, "draw", _earlier_route)
    for a_list, b_list in zip(new, run()):
        for a, b in zip(a_list, b_list):
            assert torch.equal(a, b)


def _jax_target():
    jt, mu, L = jax_normal_fullrank(jax.random.key(9), D)
    return jt, convert.normal_target_from_numpy(mu, L, device=CPU)


def test_antithetic_block_diagonal_matches_jax():
    jt, tt = _jax_target()
    rng = np.random.default_rng(0)
    loc = rng.standard_normal(D).astype(np.float32)
    scales = (np.tril(0.3 * rng.standard_normal((2, 3, 3))) + np.eye(3)).astype(np.float32)
    jq = javt.BlockDiagGaussian(jnp.asarray(loc), jnp.asarray(scales))
    tq = convert.blockdiag_from_numpy(loc, scales, device=CPU)
    key = jax.random.key(5)
    _, u = jq.sample_with_base(key, 4)  # JAX's n/2 antithetic draws
    for entropy in ("stl", "monte_carlo", "closed_form"):
        jobj = javt.RepGradELBO(n_samples=8, entropy=entropy, antithetic=True)
        jloss, jgrad = jax.value_and_grad(lambda q: jobj.loss(q, jt, key))(jq)
        obj = avt.RepGradELBO(n_samples=8, entropy=entropy, antithetic=True)
        grad, _, info = obj.value_and_grad(tq, tt, None, noise=torch.from_numpy(np.array(u)))
        assert_allclose(-float(info["elbo"]), float(jloss), rtol=1e-5, atol=1e-6)
        assert_allclose(grad.location.numpy(), np.asarray(jgrad.location), rtol=1e-4, atol=1e-6)
        assert_allclose(grad.scales.numpy(), np.asarray(jgrad.scales), rtol=1e-4, atol=1e-6)


def test_antithetic_per_datapoint_mirrors_through_the_flat_location():
    jt, tt = _jax_target()
    rng = np.random.default_rng(1)
    loc = rng.standard_normal((3, 2)).astype(np.float32)
    sd = (0.4 + rng.random((3, 2))).astype(np.float32)
    jq = javt.PerDatapointMeanField(jnp.asarray(loc), jnp.asarray(sd))
    tq = convert.per_datapoint_from_numpy(loc, sd, device=CPU)
    key = jax.random.key(2)
    jobj = javt.RepGradELBO(n_samples=8, entropy="stl", antithetic=True)
    with pytest.raises(TypeError, match="broadcast"):
        jobj.loss(jq, jt, key)  # the reference's mirror of a (rows, k) location
    u = jax.random.normal(key, (4, D))

    def jax_loss(q):
        m, s = q.location.reshape(-1), q.scale_diag.reshape(-1)
        z = u * s + m
        z = jnp.concatenate([z, 2.0 * m - z], axis=0)
        energy = jnp.mean(jax.vmap(jt.log_density)(z))
        return -(energy - jnp.mean(jax_stop(q).log_prob(z)))

    jloss, jgrad = jax.value_and_grad(jax_loss)(jq)
    obj = avt.RepGradELBO(n_samples=8, entropy="stl", antithetic=True)
    grad, _, info = obj.value_and_grad(tq, tt, None, noise=torch.from_numpy(np.array(u)))
    assert_allclose(-float(info["elbo"]), float(jloss), rtol=1e-5, atol=1e-6)
    assert_allclose(grad.location.numpy(), np.asarray(jgrad.location), rtol=1e-4, atol=1e-6)
    assert_allclose(grad.scale_diag.numpy(), np.asarray(jgrad.scale_diag), rtol=1e-4, atol=1e-6)
    # on the port's own draws: the second half is the mirror of the first
    z = obj._draw(tq, PhiloxKey((1, 1), 0))
    assert_allclose((z[:4] + z[4:]).numpy(), np.tile(2 * loc.reshape(-1), (4, 1)), rtol=1e-6)


def _refused_families():
    jq0 = javt.GlobalLocalFamily(javt.MeanFieldGaussian(jnp.zeros(1)),
                                 javt.per_datapoint_meanfield(5))
    tq0 = avt.GlobalLocalFamily(avt.MeanFieldGaussian(torch.zeros(1)),
                                avt.per_datapoint_meanfield(5, device=CPU))
    return {
        "global_local": (jq0, tq0),
        "mixture_meanfield": (javt.mixture_meanfield(jax.random.key(0), D, 2),
                              avt.mixture_meanfield(0, D, 2, device=CPU)),
        "mixture_fullrank": (javt.mixture_fullrank(jax.random.key(0), D, 2),
                             avt.mixture_fullrank(0, D, 2, device=CPU)),
        "planar": (javt.planar_flow(jax.random.key(0), D, 2),
                   avt.planar_flow(0, D, 2, device=CPU)),
        "radial": (javt.radial_flow(jax.random.key(0), D, 2),
                   avt.radial_flow(0, D, 2, device=CPU)),
        "coupling": (javt.coupling_flow(jax.random.key(0), D, 2, 4),
                     avt.coupling_flow(0, D, 2, 4, device=CPU)),
    }


@pytest.mark.parametrize("family", list(_refused_families()))
def test_antithetic_refusals_match_jax_word_for_word(family):
    jq, tq = _refused_families()[family]
    jt, tt = _jax_target()
    with pytest.raises(ValueError) as jerr:
        javt.RepGradELBO(n_samples=8, antithetic=True).loss(jq, jt, jax.random.key(0))
    with pytest.raises(ValueError) as terr:
        avt.RepGradELBO(n_samples=8, antithetic=True).loss(tq, tt, 0)
    assert str(terr.value) == str(jerr.value)
    assert "location-scale family" in str(terr.value)
