"""The order of the diagonal-Gaussian kernel's sums (the kGauss group of the
mean-field and chains kernels, csrc/fused_gauss_body.cuh), on the CPU.

The kernel forms each step in one column-fused pass: a thread owns whole
4-column groups, and the only sums that cross columns (each row's log pi
and |u|^2, log det sigma, DoWG's and DoG's two global sums) and each
column's sum over the rows run in a fixed order that depends on (n, d)
alone.  This file keeps a torch mirror of that order, slot by slot as the
kernel maps its threads, and holds it to JAX's ``gaussian_spec`` step on
the same seeded numpy inputs: log pi within rtol 1e-5, the step's ELBO
within 1e-4 (the fused engines' ELBO bar), the gradient's and DoWG's sums
within 1e-5 of float64.  The mirror gives the same bits whatever the
chains a block (G), as the kernel's promise that chain c of a G-chain block
is the single-chain kernel needs.  The host-side rule that picks G,
``chains_per_block``, is held here with the kernel's shared-memory count
(mirrored from ``gauss::layout_for``); the card tests hold the count to the
kernel's own (tests/test_torch_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from advancedvi_jl_tpu.ops.pallas import fused_advi as jfused
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.ops.cuda import _build
from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import (
    BLOCK_THREADS,
    MAX_CHAINS_PER_BLOCK,
    chains_per_block,
)

N = 10
THREADS = BLOCK_THREADS  # csrc/fused_meanfield_body.cuh mf::kThreads
L2PI = np.float32(1.8378770664093453)


def split_for(n, d):
    """gauss::split_for: 4-column groups, the lanes of a column slice, the
    slices of a row, and R row blocks of ``rows`` rows."""
    groups = -(-d // 4)
    width = 1
    while width < groups and width < 32:
        width *= 2
    slices = -(-groups // width)
    lanes = slices * width
    blocks = max(1, min(n, THREADS // lanes))
    rows = -(-n // blocks)
    return dict(groups=groups, width=width, slices=slices, lanes=lanes, R=-(-n // rows),
                rows=rows)


def smem_bytes(n, d, n_rows, G):
    """gauss::layout_for's bytes of a block of G chains."""
    S = split_for(n, d)
    wpc = -(-d // 32)
    floats = G * (n_rows * d + 2 * S["R"] * d + 2 * n * S["slices"] + S["slices"] + n
                  + 2 * wpc + 1 + 1 + 1 + 2)
    return 4 * floats


def butterfly(v, width):
    """slice_sum: lane l adds lane l ^ o for o = width / 2, ..., 1 (the last
    axis holds a slice's lanes); every lane ends with the same sum."""
    idx = torch.arange(v.shape[-1])
    o = width // 2
    while o:
        v = v + v[..., idx ^ o]
        o //= 2
    return v[..., 0]


def f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def block_sums(mu, sig, u, mean, iv, G):
    """The kernel's sums for C chains at G chains a block: each chain's
    log pi and |u|^2 rows (n,), log det, and dmu, dsig (d,) (the STL
    gradient), every one in the kernel's order, the slots of a block mapped
    to (chain, row block, column slice, lane) as the kernel maps its
    threads.  mu, sig (C, d); u (C, n, d); mean, iv (d,) float32."""
    C, n, d = u.shape
    S = split_for(n, d)
    W, K, R, rows, groups = S["width"], S["slices"], S["R"], S["rows"], S["groups"]
    P = R * S["lanes"]
    inv_n = f32(1.0 / n)
    lpp = torch.zeros(C, n, K)
    uup = torch.zeros(C, n, K)
    ldp = torch.zeros(C, K)
    part = torch.zeros(C, R, 2, d)
    for c0 in range(0, C, G):
        gc = min(G, C - c0)
        q = torch.arange(gc * P)
        c = q // P
        rem = q - c * P
        r = rem // S["lanes"]
        k = (rem - r * S["lanes"]) // W
        g = k * W + (rem - r * S["lanes"] - k * W)
        cols = 4 * g[:, None] + torch.arange(4)  # (slots, 4)
        ok = (g[:, None] < groups) & (cols < d)
        colc = cols.clamp(max=d - 1)
        ch = c0 + c
        m4 = torch.where(ok, mu[ch[:, None], colc], f32(0.0))
        s4 = torch.where(ok, sig[ch[:, None], colc], f32(1.0))
        mean4 = torch.where(ok, mean[colc], f32(0.0))
        iv4 = torch.where(ok, iv[colc], f32(0.0))
        dmu = torch.zeros(gc * P, 4)
        dsig = torch.zeros(gc * P, 4)
        for t in range(rows):
            i = r * rows + t
            on = ok & (i < n)[:, None]
            u4 = torch.where(on, u[ch[:, None], i.clamp(max=n - 1)[:, None], colc], f32(0.0))
            z = m4 + s4 * u4
            diff = z - mean4
            gz = -inv_n * ((-diff) * iv4 + u4 / s4)
            dmu = torch.where(on, dmu + gz, dmu)
            dsig = torch.where(on, dsig + gz * u4, dsig)
            lp = torch.zeros(gc * P)
            uu = torch.zeros(gc * P)
            for p in range(4):
                lp = torch.where(on[:, p], lp + (diff[:, p] * diff[:, p]) * iv4[:, p], lp)
                uu = torch.where(on[:, p], uu + u4[:, p] * u4[:, p], uu)
            lp = butterfly(lp.reshape(-1, W), W)
            uu = butterfly(uu.reshape(-1, W), W)
            head = q.reshape(-1, W)[:, 0]  # each slice's lane 0
            hc, hi, hk = ch[head], i[head], k[head]
            keep = hi < n
            lpp[hc[keep], hi[keep], hk[keep]] = lp[keep]
            uup[hc[keep], hi[keep], hk[keep]] = uu[keep]
        ld = torch.zeros(gc * P)
        for p in range(4):
            ld = torch.where(ok[:, p], ld + torch.log(s4[:, p]), ld)
        ld = butterfly(ld.reshape(-1, W), W)
        head = q.reshape(-1, W)[:, 0]
        first = r[head] == 0
        ldp[ch[head][first], k[head][first]] = ld[first]
        valid = ok.flatten()
        cc = ch[:, None].expand(-1, 4).flatten()[valid]
        rr = r[:, None].expand(-1, 4).flatten()[valid]
        jj = cols.flatten()[valid]
        part[cc, rr, 0, jj] = dmu.flatten()[valid]
        part[cc, rr, 1, jj] = dsig.flatten()[valid]
    lp2 = torch.zeros(C, n)
    u2 = torch.zeros(C, n)
    ld = torch.zeros(C)
    for kk in range(K):  # the slices in order
        lp2 = lp2 + lpp[:, :, kk]
        u2 = u2 + uup[:, :, kk]
        ld = ld + ldp[:, kk]
    gm, gs = part[:, 0, 0], part[:, 0, 1]
    for rr in range(1, R):  # the row blocks in order
        gm = gm + part[:, rr, 0]
        gs = gs + part[:, rr, 1]
    return lp2, u2, ld, gm, gs


def elbo_of(lp2, u2, ld, lognorm, d):
    """The ELBO thread's sums: log pi_i = -q_i / 2 + lognorm, then each row
    in order in double, the means rounded to float, the STL entropy's value."""
    n = lp2.shape[-1]
    logpi = f32(-0.5) * lp2 + f32(lognorm)
    energy = torch.zeros(lp2.shape[:-1], dtype=torch.float64)
    uu = torch.zeros(lp2.shape[:-1], dtype=torch.float64)
    for i in range(n):
        energy = energy + logpi[..., i].double()
        uu = uu + u2[..., i].double()
    ent_const = f32(0.5 * d) * L2PI
    mean_u2 = (uu / n).float()
    return logpi, (energy / n).float() + (ld + f32(0.5) * mean_u2 + ent_const)


def dist_sums(dmu, dsig, xm, xs):
    """DoWG's and DoG's two sums of one chain, the kernel's order: each
    column's terms, a butterfly over 32 columns, the 32-column warps in
    order."""
    d = dmu.shape[-1]
    wpc = -(-d // 32)
    pad = wpc * 32 - d
    tg = torch.nn.functional.pad(dmu * dmu + dsig * dsig, (0, pad)).reshape(wpc, 32)
    tx = torch.nn.functional.pad(xm * xm + xs * xs, (0, pad)).reshape(wpc, 32)
    wg, wx = butterfly(tg, 32), butterfly(tx, 32)
    sg = sx = f32(0.0)
    for w in range(wpc):
        sg, sx = sg + wg[w], sx + wx[w]
    return sg, sx


def inputs(d, n=N, C=1, seed=0):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(d).astype(np.float32)
    sd = (0.5 + rng.random(d)).astype(np.float32)
    mu = rng.normal(0, 0.3, (C, d)).astype(np.float32)
    sig = rng.uniform(0.3, 0.6, (C, d)).astype(np.float32)
    u = rng.standard_normal((C, n, d)).astype(np.float32)
    return mean, sd, mu, sig, u


def port_consts(mean, sd):
    iv = (1.0 / (f32(sd) * f32(sd))).contiguous()
    lognorm = float(-torch.sum(torch.log(f32(sd))) - 0.5 * mean.shape[0] * float(L2PI))
    return f32(mean), iv, lognorm


@pytest.mark.parametrize("d", [11, 512, 2048])
def test_mirror_log_pi_matches_jax_step(d):
    """Each row's log pi, summed in the kernel's order, against JAX's
    gaussian_spec step factory on the same z."""
    mean, sd, mu, sig, u = inputs(d)
    m, iv, lognorm = port_consts(mean, sd)
    lp2, _, _, _, _ = block_sums(f32(mu), f32(sig), f32(u), m, iv, 1)
    logpi, _ = elbo_of(lp2, torch.zeros_like(lp2), torch.zeros(1), lognorm, d)
    spec = jfused.gaussian_spec(jnp.asarray(mean), jnp.asarray(sd))
    dp = spec.consts[0].shape[1]
    z = np.zeros((N, dp), np.float32)
    z[:, :d] = (f32(mu[0]) + f32(sig[0]) * f32(u[0])).numpy()
    step = jfused._gaussian_step_factory(spec.static_cfg, None, spec.consts, spec.scalars)
    want, _ = step(jnp.asarray(z), 0)
    assert_allclose(logpi[0].numpy(), np.asarray(want)[:, 0], rtol=1e-5)


@pytest.mark.parametrize("d,n", [(11, N), (512, N), (2048, N), (512, 128)])
def test_mirror_elbo_matches_jax_engine(d, n):
    """The ELBO of one step (log pi, |u|^2 and log det in the kernel's
    order) against JAX's FusedADVI (interpret mode) on the same draw."""
    mean, sd, mu, sig, u = inputs(d, n, seed=1)
    m, iv, lognorm = port_consts(mean, sd)
    lp2, u2, ld, _, _ = block_sums(f32(mu), f32(sig), f32(u), m, iv, 1)
    _, elbo = elbo_of(lp2, u2, ld, lognorm, d)
    spec = jfused.gaussian_spec(jnp.asarray(mean), jnp.asarray(sd))
    eng = jfused.FusedADVI(spec, n_samples=n, lr=1e-3, interpret=True)
    st = eng.run_chunk(eng.init(jnp.asarray(mu[0]), jnp.asarray(sig[0])), jax.random.key(1),
                       steps=1, noise=jnp.asarray(convert.pack_noise(u[:, :, :], d_pad=eng.d_pad)))
    assert_allclose(float(elbo[0]), float(st.elbo), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d,n", [(11, N), (62, N), (512, N), (512, 128), (2048, N)])
def test_mirror_gradient_and_dowg_sums_match_float64(d, n):
    """dmu and dsig (each column's rows in row blocks, the blocks in order)
    and DoWG's two sums (32-column warps in order) within 1e-5 of float64."""
    mean, sd, mu, sig, u = inputs(d, n, seed=2)
    m, iv, _ = port_consts(mean, sd)
    _, _, _, gm, gs = block_sums(f32(mu), f32(sig), f32(u), m, iv, 1)
    z = mu[0].astype(np.float64) + sig[0].astype(np.float64) * u[0]
    g = -(z - mean) * iv.double().numpy()
    gz = -(g + u[0] / sig[0].astype(np.float64)) / n
    want_m, want_s = gz.sum(0), (gz * u[0]).sum(0)
    scale = np.abs(gz).sum(0).max()
    assert np.abs(gm[0].numpy() - want_m).max() <= 1e-5 * scale
    assert np.abs(gs[0].numpy() - want_s).max() <= 1e-5 * np.abs(gz * u[0]).sum(0).max()
    x0m, x0s = mu[0] - 0.05, sig[0] * 0.9
    xm, xs = f32(mu[0]) - f32(x0m), f32(sig[0]) - f32(x0s)
    sg, sx = dist_sums(gm[0], gs[0], xm, xs)
    gm64, gs64 = gm[0].double(), gs[0].double()
    assert_allclose(float(sg), float((gm64 * gm64 + gs64 * gs64).sum()), rtol=1e-5)
    assert_allclose(float(sx), float((xm.double() ** 2 + xs.double() ** 2).sum()), rtol=1e-5)


@pytest.mark.parametrize("d,n,C,G", [(11, N, 70, 32), (62, N, 9, 4), (512, N, 6, 3),
                                     (512, 128, 5, 2), (2048, N, 3, 2)])
def test_mirror_is_bitwise_the_same_at_any_chains_a_block(d, n, C, G):
    """Each chain's sums at G chains a block (the last block ragged) equal
    its sums alone, bit for bit."""
    mean, sd, mu, sig, u = inputs(d, n, C, seed=3)
    m, iv, _ = port_consts(mean, sd)
    many = block_sums(f32(mu), f32(sig), f32(u), m, iv, G)
    for c in range(C):
        one = block_sums(f32(mu[c:c + 1]), f32(sig[c:c + 1]), f32(u[c:c + 1]), m, iv, 1)
        for a, b in zip(many, one):
            assert torch.equal(a[c], b[0]), c


@pytest.mark.parametrize("n,d,R,rows", [(10, 11, 10, 1), (10, 62, 10, 1), (10, 512, 4, 3),
                                        (128, 512, 4, 32), (10, 1024, 2, 5), (10, 1025, 1, 10),
                                        (128, 2048, 1, 128), (1, 5, 1, 1), (100, 11, 100, 1)])
def test_rows_split_only_where_one_row_block_leaves_threads_idle(n, d, R, rows):
    """R row blocks where a chain's slices leave threads idle; one (each
    thread a column's whole loop over the rows) above d = 1,024."""
    S = split_for(n, d)
    assert (S["R"], S["rows"]) == (R, rows)
    assert S["R"] * S["lanes"] <= THREADS and (S["R"] - 1) * S["rows"] < n <= S["R"] * S["rows"]


@pytest.mark.parametrize("model,C,d,n,n_rows,want", [
    ("gaussian", 4224, 11, N, 8, 32), ("gaussian", 1024, 11, N, 8, 8),
    ("gaussian", 1024, 512, N, 8, 4), ("gaussian", 1024, 2048, N, 8, 2),
    ("gaussian", 100, 2048, N, 8, 1), ("logreg", 1024, 600, N, 8, 1),
    ("gaussian", 4224, 2048, 128, 14, 1)])
def test_chains_per_block_takes_the_gaussian_block(model, C, d, n, n_rows, want):
    """The rule on the kGauss block's bytes at 132 SMs: the fewest waves,
    any d for the Gaussian (d > 512 keeps one chain a block elsewhere), one
    chain a block while the chains do not outnumber the SMs, and one where
    two chains' state does not fit."""
    G = chains_per_block(model, C, 132, d, lambda g: smem_bytes(n, d, n_rows, g))
    assert G == want
    assert G <= MAX_CHAINS_PER_BLOCK and smem_bytes(n, d, n_rows, G) <= _build.SMEM_LIMIT


def test_every_gaussian_jax_takes_fits_one_block():
    """d <= 2,048, n <= 128 and COCOB's 14 state rows: one chain's block in
    shared memory, no workspace."""
    assert smem_bytes(128, 2048, 14, 1) <= _build.SMEM_LIMIT
    assert smem_bytes(128, 2048, 14, 1) == 4 * (14 * 2048 + 2 * 2048 + 2 * 128 * 16 + 16 + 128
                                                + 2 * 64 + 5)
