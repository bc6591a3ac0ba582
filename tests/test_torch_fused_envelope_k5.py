"""Port parity of K5 (``ad_spec``, ``FusedModelSpec.from_log_density``) at
the fused engines' envelope: the bodies whose arrays one block's shared
memory cannot hold (on a card they run the kernels' tiered layouts: the
mean-field and chains kernels' kWide group, csrc/fused_meanfield_body.cuh
``wide_layout_at``, and the full-rank kernel's ``tier_layout``), run here
through the body's plain version (the graph's replay) against the JAX
engines in Pallas interpret mode on the same injected draws, and the edges
of JAX's envelope for K5 and the full-rank family.  The kernels themselves
are held to the plain versions on a card (tests/test_torch_kernels.py,
chip_smoke.py phase (ag)).

Tolerances are tests/test_fused_advi.py's: rtol 1e-5 and atol 1e-6 on the
parameters and their averages, 1e-4 on the ELBO.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.ops.pallas import fused_advi as jfused
from advancedvi_jl_tpu.ops.pallas import fused_chains as jchains
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.ops.cuda import _build
from advancedvi_jl_tpu_torch.ops.cuda import fused_advi as tfused
from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import FusedChainsADVI

torch.set_num_threads(2)

N = 10
PARAMS = ("mu", "sig", "avg_mu", "avg_sig")
TOL = dict(rtol=1e-5, atol=1e-6)


def _quartic_data(d):
    anchor = np.linspace(-1.0, 1.0, d).astype(np.float32)
    w = np.linspace(1.0, 5.0, d).astype(np.float32)
    return ({"anchor": jnp.asarray(anchor), "w": jnp.asarray(w)},
            {"anchor": torch.from_numpy(anchor), "w": torch.from_numpy(w)})


def _jax_quartic(theta, data):
    r = theta - data["anchor"]
    return -jnp.sum(r * r * data["w"]) - 0.1 * jnp.sum(r ** 4)


def _torch_quartic(theta, data):  # the same density, batched over leading dims
    r = theta - data["anchor"]
    return -(r * r * data["w"]).sum(-1) - 0.1 * (r ** 4).sum(-1)


def _quartic(d):
    """(JAX spec, port spec) of the anisotropic quartic well at width d,
    through ``FusedModelSpec.from_log_density``."""
    jdata, tdata = _quartic_data(d)
    return (jfused.FusedModelSpec.from_log_density(_jax_quartic, d, data=jdata),
            tfused.FusedModelSpec.from_log_density(_torch_quartic, d, data=tdata))


def _wide_logreg():
    """An 8,192 x 4 logistic fn_target (the design's
    (10, 8,192) logit block is over one block's shared memory) and the
    same fn_target in JAX."""
    g = torch.Generator().manual_seed(0)
    X = torch.randn(8192, 4, generator=g)
    jt = javt.fn_target(lambda t, dat: -jnp.sum(jnp.log1p(jnp.exp(dat @ t))), 4,
                        data=jnp.asarray(X.numpy()))
    tt = avt.fn_target(lambda t, dat: -torch.log1p(torch.exp(t @ dat.T)).sum(-1), 4, X)
    return jfused.ad_spec(jt), tfused.ad_spec(tt)


def _start(d, family, seed=3):
    rng = np.random.default_rng(seed)
    loc = rng.normal(0, 0.3, d).astype(np.float32)
    sd = rng.uniform(0.3, 0.6, d).astype(np.float32)
    return loc, (sd if family == "meanfield" else np.diag(sd))


def _single(jspec, tspec, steps, n=N, family="meanfield", seed=0):
    """The JAX engine (interpret mode) and the port's FusedADVI on the same
    injected draws; the JAX state comes back in the port's layout."""
    d = tspec.dim
    jeng = jfused.FusedADVI(jspec, family=family, n_samples=n, lr=1e-3, interpret=True)
    teng = tfused.FusedADVI(tspec, family=family, n_samples=n, lr=1e-3)
    loc, scale = _start(d, family)
    noise = np.random.default_rng(seed).standard_normal((steps, n, d)).astype(np.float32)
    js = jeng.run_chunk(jeng.init(jnp.asarray(loc), jnp.asarray(scale)), jax.random.key(1),
                        steps=steps,
                        noise=jnp.asarray(convert.pack_noise(noise, d_pad=jeng.d_pad)))
    ts = teng.run_chunk(teng.init(torch.from_numpy(loc), torch.from_numpy(scale)), 1, steps,
                        noise=torch.from_numpy(noise))
    return convert.fused_state_from_numpy(js, d, device="cpu"), ts, js, teng


def _close(want, got):
    for f in PARAMS:
        assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(), err_msg=f, **TOL)


def _ad_shared_bytes(prog, family, rows):
    return tfused.ad_smem_bytes(family, prog.n, prog.d, prog.scratch, rows)


def test_k5_quartic_d2048_matches_jax():
    """The quartic at d = 2,048, n = 10 (the kWide group's tier 3 on a
    card: u, z and g alone are 245,760 bytes), 3 steps."""
    jspec, tspec = _quartic(2048)
    want, got, js, teng = _single(jspec, tspec, 3)
    assert not teng.ad.staged
    assert _ad_shared_bytes(teng.ad, "meanfield", 8) > _build.SMEM_LIMIT
    _close(want, got)
    assert_allclose(float(got.elbo), float(js.elbo), rtol=1e-4, atol=1e-4)


def test_k5_wide_logreg_matches_jax():
    """The 8,192 x 4 fn_target (its body's scratch alone is over one
    block's shared memory: the kWide group's tier 2 on a card), which the
    port refused before its tiers, 3 steps."""
    jspec, tspec = _wide_logreg()
    want, got, js, teng = _single(jspec, tspec, 3)
    assert 4 * teng.ad.scratch > _build.SMEM_LIMIT
    _close(want, got)
    assert_allclose(float(got.elbo), float(js.elbo), rtol=1e-4, atol=1e-4)


def test_k5_chains_d2048_match_jax():
    """Eight chains of the quartic at d = 2,048 (one chain a block on a
    card, each with its slice of the device workspace), 2 steps."""
    jspec, tspec = _quartic(2048)
    d, C, steps = 2048, 8, 2
    rng = np.random.default_rng(5)
    locs = rng.normal(0, 0.3, (C, d)).astype(np.float32)
    sds = rng.uniform(0.3, 0.6, (C, d)).astype(np.float32)
    draws = rng.standard_normal((steps, C, N, d)).astype(np.float32)
    jeng = jchains.FusedChainsADVI(jspec, n_chains=C, n_samples=N, interpret=True)
    teng = FusedChainsADVI(tspec, n_chains=C, n_samples=N)
    js = jeng.run_chunk(jeng.init(jnp.asarray(locs), jnp.asarray(sds)), jax.random.key(1),
                        steps, noise=jnp.asarray(convert.pack_chains_noise(draws)))
    ts = teng.run_chunk(teng.init(torch.from_numpy(locs), torch.from_numpy(sds)), 1, steps,
                        noise=torch.from_numpy(draws))
    want = convert.chains_state_from_numpy(js, C, d, device="cpu")
    _close(want, ts)
    assert_allclose(ts.elbo.numpy(), want.elbo.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d,n", [(256, 64), (512, 128)])
def test_k5_fullrank_matches_jax(d, n):
    """The full-rank engine on K5's quartic at d = 256, n = 64 (269,200
    bytes with every array in shared memory) and at JAX's caps, d = 512,
    n = 128 (1,062,544): the full-rank kernel's tiered layout on a card,
    2 steps."""
    jspec, tspec = _quartic(d)
    want, got, js, teng = _single(jspec, tspec, 2, n=n, family="fullrank")
    assert _ad_shared_bytes(teng.ad, "fullrank", 4) > _build.SMEM_LIMIT
    _close(want, got)
    assert_allclose(float(got.elbo), float(js.elbo), rtol=1e-4, atol=1e-4)


def test_ad_program_refuses_only_past_the_last_tier():
    """A body is refused only where even the last tier's shared arrays (the
    state rows, the step's gradient, the row sums and the block reduction)
    do not fit one block: never at JAX's caps (14 state rows at d = 2,048
    are 114,688 bytes), and the message names the sizes."""
    _, tspec = _quartic(64)
    for family, rows in (("meanfield", 14), ("fullrank", 7)):
        assert tfused.ad_program(tspec, N, family, rows).d == 64
    with pytest.raises(ValueError, match=r"1000 state rows.*over the 232448-byte limit"):
        tfused.ad_program(tspec, N, "meanfield", 1000)


def _accepts(build) -> bool:
    try:
        build()
    except ValueError:
        return False
    return True


def _builds(engine, d, n, C=8):
    """(JAX build, port build) of ``engine`` ("ad", "ad_fullrank",
    "ad_chains", or "fullrank" on a Gaussian) at width d and n samples:
    each builds the spec and the engine."""
    family = "fullrank" if engine.endswith("fullrank") else "meanfield"
    rng = np.random.default_rng(0)
    mean, sd = rng.standard_normal(d).astype(np.float32), np.ones(d, np.float32)
    jdata, tdata = _quartic_data(d)

    def jax_build():
        if engine.startswith("ad"):
            spec = jfused.FusedModelSpec.from_log_density(_jax_quartic, d, data=jdata)
        else:
            spec = jfused.gaussian_spec(jnp.asarray(mean), jnp.asarray(sd))
        if engine == "ad_chains":
            return jchains.FusedChainsADVI(spec, n_chains=C, n_samples=n, interpret=True)
        return jfused.FusedADVI(spec, family=family, n_samples=n, interpret=True)

    def port_build():
        if engine.startswith("ad"):
            spec = tfused.FusedModelSpec.from_log_density(_torch_quartic, d, data=tdata)
        else:
            spec = tfused.gaussian_spec(torch.from_numpy(mean), torch.from_numpy(sd))
        if engine == "ad_chains":
            return FusedChainsADVI(spec, n_chains=C, n_samples=n)
        return tfused.FusedADVI(spec, family=family, n_samples=n)

    return jax_build, port_build


# (engine, d, n, JAX accepts, the port accepts): each of JAX's envelope edges
# for K5 and the full-rank family, and one step beyond it.  The port refuses
# what JAX refuses for the kernels' layout (mean-field d > 2,048, full-rank
# d > 512); JAX's n <= 128 was a TPU VMEM budget, which the port's tiered
# layouts do not have (tests/test_torch_fused_envelope.py EDGES).
EDGES = [
    ("ad", 2048, N, True, True), ("ad", 2049, N, False, False),
    ("ad", 64, 128, True, True), ("ad", 64, 129, False, True),
    ("ad_chains", 2048, N, True, True), ("ad_chains", 2049, N, False, False),
    ("ad_fullrank", 512, 128, True, True), ("ad_fullrank", 513, N, False, False),
    ("ad_fullrank", 64, 129, False, True),
    ("fullrank", 512, 128, True, True), ("fullrank", 513, N, False, False),
    ("fullrank", 512, 129, False, True),
]


@pytest.mark.parametrize("engine,d,n,jax_ok,port_ok", EDGES,
                         ids=[f"{e[0]}-d{e[1]}-n{e[2]}" for e in EDGES])
def test_k5_and_fullrank_accept_what_jax_accepts_at_its_edges(engine, d, n, jax_ok, port_ok):
    """At every edge of JAX's envelope both accept; one step beyond, the
    port refuses what JAX refuses but for the TPU budget named above."""
    jax_build, port_build = _builds(engine, d, n)
    assert _accepts(jax_build) == jax_ok
    assert _accepts(port_build) == port_ok
