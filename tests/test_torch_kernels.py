"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device (marker ``cuda``) and skips without one.
The module imports no JAX, so on a machine with a card and without JAX it
runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
"""

import ctypes

import pytest
import torch

from advancedvi_jl_tpu_torch.models.logreg import make_logreg
from advancedvi_jl_tpu_torch.models.normal import normal_fullrank_wellcond
from advancedvi_jl_tpu_torch.models.normallognormal import make_normallognormal
from advancedvi_jl_tpu_torch.ops.cuda import _build
from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
    FusedADVI,
    FusedBranch,
    FusedHyper,
    FusedLogRegADVI,
    MODEL_CODES,
    fused_fullrank_run_chunk_cuda,
    fused_fullrank_run_chunk_reference,
    fused_run_chunk_cuda,
    fused_run_chunk_reference,
    gaussian_spec,
    logreg_spec,
    mvnormal_spec,
    normallognormal_spec,
)
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    fullrank_sample,
    fullrank_sample_cuda,
    fullrank_sample_reference,
    meanfield_sample,
    meanfield_sample_cuda,
    meanfield_sample_reference,
    seed_words,
)
from advancedvi_jl_tpu_torch.ops.cuda.trisolve_kernels import (
    solve_right_cuda,
    solve_right_reference,
    vdiv_c,
    vdiv_ct,
)

pytestmark = pytest.mark.cuda

N = 10


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _rows(d, dev):
    mu, sig, zero = torch.zeros(d), 0.1 * torch.ones(d), torch.zeros(d)
    return torch.stack([mu, sig, zero, zero, zero, zero, mu, sig]).to(dev)


@pytest.mark.parametrize("n,d", [(10, 62), (1000, 128), (33, 5)])
def test_sampler_kernel_matches_plain_version(dev, n, d):
    g = torch.Generator().manual_seed(n)
    loc = torch.randn(d, generator=g).to(dev)
    scale = torch.rand(d, generator=g).to(dev) + 0.5
    before = meanfield_sample_cuda.launches
    z, u = meanfield_sample_cuda(seed_words(3), 4, loc, scale, n)
    zr, ur = meanfield_sample_reference(seed_words(3), 4, loc, scale, n)
    torch.cuda.synchronize()
    assert meanfield_sample_cuda.launches == before + 1
    # logf/cosf of the kernel and torch's CUDA log/cos: equal on the H100,
    # within 1e-6 wherever they round differently
    assert (u - ur).abs().max() <= 1e-6
    assert torch.allclose(z, zr, rtol=1e-6, atol=1e-6)


def test_sampler_autograd_on_the_card(dev):
    loc = torch.zeros(62, device=dev, requires_grad=True)
    scale = torch.ones(62, device=dev, requires_grad=True)
    z, u = meanfield_sample(seed_words(1), 0, loc, scale, N)
    (z * z).sum().backward()
    assert torch.allclose(loc.grad, (2 * z).sum(0).detach(), rtol=1e-6, atol=1e-5)
    assert torch.allclose(scale.grad, (2 * z * u).sum(0).detach(), rtol=1e-6, atol=1e-5)


# n above the 65535 x 4 rows of the largest grid: the rows past it come round again
BIG_N = 65535 * 8 + 9


@pytest.mark.parametrize("n,d,K,it0", [(10, 62, 8, 1000), (10, 62, 1, 7), (10, 62, 50, 3),
                                       (10, 62, 6, 2**32 - 3), (BIG_N, 8, 2, 2**32 - 1),
                                       (33, 5, 8, 2**32 - 4), (17, 33, 8, 0)],
                         ids=["K8", "K1", "K50", "wrap", "big-n", "d5", "d33"])
def test_sampler_device_word_graph_is_the_host_int_launches(dev, n, d, K, it0):
    """K launches at offsets 0 .. K-1 from a device word, captured in one
    CUDA graph with the word's advance by K, draw at each replay what K
    host-int launches draw at the next K iterations (mod 2^32), bit for
    bit."""
    g = torch.Generator().manual_seed(d)
    loc = torch.randn(d, generator=g).to(dev)
    scale = (0.5 + torch.rand(d, generator=g)).to(dev)
    seed = seed_words(5)
    word = torch.tensor([it0], dtype=torch.int64, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # builds and loads the kernel outside the capture
        meanfield_sample_cuda(seed, 0, loc, scale, n, it_word=word)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [meanfield_sample_cuda(seed, k, loc, scale, n, it_word=word) for k in range(K)]
        word.add_(K)
    for rep in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for k, (z, u) in enumerate(outs):
            zh, uh = meanfield_sample_cuda(seed, it0 + rep * K + k, loc, scale, n)
            torch.cuda.synchronize()
            assert torch.equal(u, uh) and torch.equal(z, zh), (rep, k)
    assert int(word) == it0 + 2 * K


def test_sampler_reads_what_the_kernel_ahead_wrote(dev):
    """m, sigma and the iteration word that the kernel just ahead in the
    stream wrote are what each launch reads: each sees the values just
    filled."""
    d, n, seed = 62, N, seed_words(2)
    loc, scale = torch.zeros(d, device=dev), torch.ones(d, device=dev)
    word = torch.zeros(1, dtype=torch.int64, device=dev)
    outs = []
    for i in range(200):
        loc.fill_(float(i))
        scale.fill_(1.0 + i / 64)
        word.fill_(3 * i)
        outs.append(meanfield_sample_cuda(seed, i % 2, loc, scale, n, it_word=word))
    torch.cuda.synchronize()
    one = torch.ones(d, device=dev)
    for i, (z, u) in enumerate(outs):
        _, uh = meanfield_sample_cuda(seed, 3 * i + i % 2, loc, one, n)
        torch.cuda.synchronize()
        assert torch.equal(u, uh), i
        assert torch.equal(z, u * (1.0 + i / 64) + float(i)), i


@pytest.mark.parametrize("injected", [True, False], ids=["noise", "philox"])
def test_fused_kernel_matches_plain_version(dev, injected):
    prob = make_logreg(11, device=dev)
    d = prob.dim
    noise = torch.randn((20, N, d), generator=torch.Generator().manual_seed(2)).to(dev)
    args = ("logreg", (prob.X, prob.y), (1.0, 3.0), _rows(d, dev), seed_words(0), 0, 20, N,
            FusedHyper(), noise if injected else None)
    k_rows, k_elbo, k_tr = fused_run_chunk_cuda(*args, log_every=5)
    r_rows, r_elbo, r_tr = fused_run_chunk_reference(*args, log_every=5)
    torch.cuda.synchronize()
    # norm-wise: sums over 208 data are taken in another order by the kernel
    for a, b in zip(k_rows, r_rows):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert torch.allclose(k_elbo, r_elbo, rtol=1e-5)
    assert torch.allclose(k_tr, r_tr, rtol=1e-5)


def test_fused_kernel_without_the_aligned_layout(dev):
    """A design too large for the aligned copy of the betas and the padded
    logits (771 rows: it fitted before block_mm, and the aligned layout
    does not) runs on the plain layout: the same sums, within the plain
    version's tolerance, and the kernel takes no more shared memory than
    before."""
    prob = make_logreg(11, n_data=771, device=dev)
    d = prob.dim
    smem = _build.function("fused_advi_meanfield", "fused_advi_meanfield_smem_bytes",
                           [ctypes.c_int] * 7, restype=ctypes.c_size_t)(0, 771, 61, 0, N, d, 8)
    assert smem == 4 * (72 * 771 + 3 * N * d + 10 * d + 7 * N + 1 + 33) <= _build.SMEM_LIMIT
    noise = torch.randn((20, N, d), generator=torch.Generator().manual_seed(2)).to(dev)
    args = ("logreg", (prob.X, prob.y), (1.0, 3.0), _rows(d, dev), seed_words(0), 0, 20, N,
            FusedHyper(), noise)
    k_rows, k_elbo, _ = fused_run_chunk_cuda(*args)
    r_rows, r_elbo, _ = fused_run_chunk_reference(*args)
    torch.cuda.synchronize()
    for a, b in zip(k_rows, r_rows):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert torch.allclose(k_elbo, r_elbo, rtol=1e-5)


def test_fused_kernel_chunks_and_traces_bitwise(dev):
    prob = make_logreg(11, device=dev)
    eng = FusedLogRegADVI(prob.X, prob.y)
    s0 = eng.init(torch.zeros(prob.dim), 0.1 * torch.ones(prob.dim))
    whole = eng.run_chunk(s0, 7, 300)
    split = eng.run_chunk(eng.run_chunk(s0, 7, 100), 7, 200)
    traced, trace = eng.run_chunk_traced(s0, 7, 300, log_every=50)
    for f in ("mu", "sig", "m_mu", "v_mu", "m_sig", "v_sig", "avg_mu", "avg_sig"):
        assert torch.equal(getattr(whole, f), getattr(split, f)), f
        assert torch.equal(getattr(whole, f), getattr(traced, f)), f
    assert torch.equal(trace[-1], whole.elbo) and trace.shape == (6,)


def test_fused_kernel_refuses_oversized_shared_memory(dev):
    """A design beyond one block's shared memory (4,096 x 61, which JAX's
    engine takes) runs on the kWide layout, the design read in device memory
    and the logits in the workspace, within the plain version's tolerance;
    what even that layout keeps in shared memory (the state rows and the
    per-sample row sums) is refused past the limit: 8,400 samples."""
    prob = make_logreg(11, n_data=4096, device=dev)
    noise = torch.randn((20, N, 62), generator=torch.Generator().manual_seed(2)).to(dev)
    args = ("logreg", (prob.X, prob.y), (1.0, 3.0), _rows(62, dev), (0, 0), 0, 20, N,
            FusedHyper(), noise)
    k_rows, k_elbo, _ = fused_run_chunk_cuda(*args)
    r_rows, r_elbo, _ = fused_run_chunk_reference(*args)
    torch.cuda.synchronize()
    _norm_close(k_rows, r_rows, 1e-5)
    assert torch.allclose(k_elbo, r_elbo, rtol=1e-5)
    with pytest.raises(ValueError, match="shared"):
        fused_run_chunk_cuda("logreg", (prob.X, prob.y), (1.0, 3.0), _rows(62, dev), (0, 0), 0,
                             1, 8400, FusedHyper())


def _rel(a, b) -> float:
    """Norm-wise relative difference ||a - b||_F / ||b||_F."""
    return float((a.double() - b.double()).norm() / b.double().norm())


# the main path's shape, the fused comparison's, then ragged ones: n and d
# off every tile and step multiple, and bench_large's second shape
FR_SAMPLE_SHAPES = [(256, 1024), (10, 62), (33, 5)] + [
    (n, d) for n in (1, 3, 7, 33, 300) for d in (1, 5, 33, 62, 100, 1000)
    if (n, d) != (33, 5)] + [(128, 2048)]


@pytest.mark.parametrize("n,d", FR_SAMPLE_SHAPES)
def test_fullrank_sampler_kernel_matches_plain_version(dev, n, d):
    _, _, L = normal_fullrank_wellcond(n, d, device="cpu")
    loc = torch.randn(d, generator=torch.Generator().manual_seed(d)).to(dev)
    # NaN above the diagonal: a read of the upper triangle would show in z
    C = (L + torch.triu(torch.full((d, d), float("nan")), 1)).to(dev)
    before = fullrank_sample_cuda.launches
    z, u = fullrank_sample_cuda(seed_words(3), 4, loc, C, n)
    z2, u2 = fullrank_sample_cuda(seed_words(3), 4, loc, C, n)
    zr, ur = fullrank_sample_reference(seed_words(3), 4, loc, C, n)
    _, umf = meanfield_sample_cuda(seed_words(3), 4, loc, torch.ones_like(loc), n)
    torch.cuda.synchronize()
    assert fullrank_sample_cuda.launches == before + 2
    assert torch.equal(u, umf) and torch.equal(u, ur) and torch.equal(u2, u)
    # the same bits on every call: a split tile's pieces meet in piece order
    assert torch.isfinite(z).all() and torch.equal(z2, z)
    # sums over d in another order than the plain product
    assert _rel(z, zr) <= 1e-6


def _cut_ranges(d):
    """Column ranges of a width-d product: halves, a ragged third, the last
    column, all but the first."""
    out = [(0, d // 2), (d // 2, d - d // 2), (d // 3, d // 3 + 1), (d - 1, 1), (1, d - 1)]
    return [(c0, nc) for c0, nc in out if nc > 0 and c0 + nc <= d]


@pytest.mark.parametrize("n,d", FR_SAMPLE_SHAPES)
def test_fullrank_sampler_column_range_matches_plain_version(dev, n, d):
    """K7b over a column range (one rank's share under tp_axis): u the whole
    draw's bits, z the plain version's columns within 1e-6, C's NaN above
    the diagonal never read; the draws-only launch draws the same u."""
    _, _, L = normal_fullrank_wellcond(n, d, device="cpu")
    loc = torch.randn(d, generator=torch.Generator().manual_seed(d)).to(dev)
    C = (L + torch.triu(torch.full((d, d), float("nan")), 1)).to(dev)
    _, u = fullrank_sample_cuda(seed_words(3), 4, loc, C, n)
    assert fullrank_sample_cuda(seed_words(3), 4, loc, C, n, product=False)[0] is None
    assert torch.equal(fullrank_sample_cuda(seed_words(3), 4, loc, C, n, product=False)[1], u)
    for cols in _cut_ranges(d):
        z, uc = fullrank_sample_cuda(seed_words(3), 4, loc, C, n, cols=cols)
        zr, _ = fullrank_sample_reference(seed_words(3), 4, loc, C, n, cols=cols)
        torch.cuda.synchronize()
        assert z.shape == (n, cols[1]) and torch.equal(uc, u)
        assert torch.isfinite(z).all() and _rel(z, zr) <= 1e-6, cols


@pytest.mark.parametrize("n,d", FR_SAMPLE_SHAPES)
def test_bf16_product_matches_plain_version(dev, n, d):
    """The bfloat16 product (csrc/fullrank_bf16.cu) against its plain
    version, the whole width and column ranges, NaN above C's diagonal:
    within 1e-6 norm-wise (the same bf16 products summed in another order;
    each step's tensor-core sums added in round-to-nearest float32);
    float64 parameters summed in double, within 1e-12."""
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
        fullrank_bf16_cuda, fullrank_bf16_reference,
    )

    _, _, L = normal_fullrank_wellcond(n, d, device="cpu")
    loc = torch.randn(d, generator=torch.Generator().manual_seed(d)).to(dev)
    C = (L + torch.triu(torch.full((d, d), float("nan")), 1)).to(dev)
    u = torch.randn(n, d, generator=torch.Generator().manual_seed(n)).to(dev)
    before = fullrank_bf16_cuda.launches
    for cols in [None] + _cut_ranges(d):
        z = fullrank_bf16_cuda(u, loc, C, cols)
        zr = fullrank_bf16_reference(u, loc, C, cols)
        torch.cuda.synchronize()
        assert torch.isfinite(z).all() and _rel(z, zr) <= 1e-6, cols
    assert fullrank_bf16_cuda.launches == before + 1 + len(_cut_ranges(d))
    z64 = fullrank_bf16_cuda(u.double(), loc.double(), C.double())
    assert _rel(z64, fullrank_bf16_reference(u.double(), loc.double(), C.double())) <= 1e-12


def _bf16_case(n, d, dev):
    """u, m and C (NaN above the diagonal) of a bf16 product at (n, d)."""
    _, _, L = normal_fullrank_wellcond(n, d, device="cpu")
    loc = torch.randn(d, generator=torch.Generator().manual_seed(d)).to(dev)
    C = (L + torch.triu(torch.full((d, d), float("nan")), 1)).to(dev)
    u = torch.randn(n, d, generator=torch.Generator().manual_seed(n))
    return u.to(dev), loc, C


# each route of the float32 product (bf16_route): TMA where d % 4 == 0, the
# warpgroups' own loads where it is not; the main path's shapes and a few cut
# ones
BF16_BITWISE_SHAPES = [(256, 1024), (128, 2048), (300, 1000), (33, 100), (33, 62), (300, 5)]


@pytest.mark.parametrize("n,d", BF16_BITWISE_SHAPES)
def test_bf16_product_gives_the_same_bits_on_every_call(dev, n, d):
    """Two calls of one shape and range give bitwise equal z: a tile cut over
    blocks adds its pieces in piece order, whichever block ends first."""
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import fullrank_bf16_cuda

    u, loc, C = _bf16_case(n, d, dev)
    for cols in [None] + _cut_ranges(d):
        z = fullrank_bf16_cuda(u, loc, C, cols)
        z2 = fullrank_bf16_cuda(u, loc, C, cols)
        torch.cuda.synchronize()
        assert torch.isfinite(z).all() and torch.equal(z2, z), cols


@pytest.mark.parametrize("n,d", [(256, 1024), (128, 2048), (33, 62)])
def test_bf16_product_leaves_its_flags_at_zero(dev, n, d):
    """The workspace's flags need no memset: a call on injected draws right
    after a K7b launch (whose draw launch zeroes K7b's own counters, not
    these), and two calls back to back inside one CUDA graph, replayed
    twice, equal a fresh call bit for bit, and every flag reads zero after
    them."""
    from advancedvi_jl_tpu_torch.ops.cuda import location_scale_kernels as lsk

    u, loc, C = _bf16_case(n, d, dev)
    u2 = torch.randn(n, d, generator=torch.Generator().manual_seed(n + 1)).to(dev)
    fresh = lsk.fullrank_bf16_cuda(u, loc, C)
    fresh2 = lsk.fullrank_bf16_cuda(u2, loc, C)
    lsk.fullrank_sample_cuda(seed_words(3), 4, loc, C, n)
    after = lsk.fullrank_bf16_cuda(u, loc, C)
    torch.cuda.synchronize()
    assert torch.equal(after, fresh)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        lsk.fullrank_bf16_cuda(u, loc, C)  # the plan and workspace exist before the capture
        stream.synchronize()
        # relaxed: the wrapper sets the kernel's shared-memory attribute on every call
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
            za = lsk.fullrank_bf16_cuda(u, loc, C)
            zb = lsk.fullrank_bf16_cuda(u2, loc, C)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(2):
        za.zero_()
        zb.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(za, fresh) and torch.equal(zb, fresh2)
    assert int(lsk._card_plan(n, d, dev, bf16=True).flags.abs().sum()) == 0


@pytest.mark.parametrize("n,d", [(256, 1024), (128, 2048), (33, 100), (33, 62)])
def test_bf16_product_reads_the_factor_the_launch_before_wrote(dev, n, d):
    """The product starts while the launch before it ends (Programmatic
    Dependent Launch) but reads C only after it: behind a copy that writes
    C over NaN, behind the packed layout's unpacking of C (the family's
    sample: draws, unpacking, product) and behind a scatter into the
    scale's diagonal (``from_base`` after ``with_scale_diag``), z equals
    the product of a C written long before, bit for bit."""
    import advancedvi_jl_tpu_torch as avt
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import fullrank_bf16_cuda

    u, loc, C = _bf16_case(n, d, dev)
    L = torch.tril(C)
    want = fullrank_bf16_cuda(u, loc, L)
    written = torch.full((d, d), float("nan"), device=dev)
    written.copy_(L)
    z = fullrank_bf16_cuda(u, loc, written)
    torch.cuda.synchronize()
    assert torch.equal(z, want)
    qd = avt.FullRankGaussian(loc, L, compute_dtype="bfloat16")
    qp = avt.FullRankGaussian(loc, L, compute_dtype="bfloat16", layout="packed")
    zd, ud = qd.sample_with_base(7, n)
    zp, up = qp.sample_with_base(7, n)
    torch.cuda.synchronize()
    assert torch.equal(up, ud) and torch.equal(zp, zd) and torch.isfinite(zp).all()
    diag = 0.5 + torch.rand(d, generator=torch.Generator().manual_seed(d)).to(dev)
    want = fullrank_bf16_cuda(u, loc, torch.diagonal_scatter(L, diag))
    torch.cuda.synchronize()
    zs = qd.with_scale_diag(diag).from_base(u)
    torch.cuda.synchronize()
    assert torch.equal(zs, want)


@pytest.mark.parametrize("n,d,offset,route", [(256, 1024, 0, "tma"), (300, 100, 0, "tma"),
                                              (33, 62, 0, "loads"), (7, 33, 0, "loads"),
                                              (33, 100, 1, "loads")])
def test_bf16_product_routes_by_shape(dev, n, d, offset, route):
    """The float32 product takes bf16_route's route (a u that does not start
    on 16 bytes goes by the loads though d % 4 == 0), counted per route,
    and either route meets the plain version within 1e-6 norm-wise."""
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
        bf16_route, fullrank_bf16_cuda, fullrank_bf16_reference,
    )

    u, loc, C = _bf16_case(n, d, dev)
    if offset:  # the same u one float past an aligned start: contiguous, not 16-byte aligned
        buf = torch.empty(n * d + offset, device=dev)
        buf[offset:] = u.reshape(-1)
        u = buf[offset:].view(n, d)
    assert bf16_route(n, d, u.data_ptr() % 16 == 0 and C.data_ptr() % 16 == 0) == route
    before = dict(fullrank_bf16_cuda.route_launches)
    for cols in [None] + _cut_ranges(d):
        z = fullrank_bf16_cuda(u, loc, C, cols)
        zr = fullrank_bf16_reference(u, loc, C, cols)
        torch.cuda.synchronize()
        assert torch.isfinite(z).all() and _rel(z, zr) <= 1e-6, cols
    assert fullrank_bf16_cuda.route_launches[route] == before[route] + 1 + len(_cut_ranges(d))


def test_fullrank_sampler_autograd_on_the_card(dev):
    d = 62
    loc = torch.zeros(d, device=dev, requires_grad=True)
    C = torch.eye(d, device=dev).requires_grad_(True)
    z, u = fullrank_sample(seed_words(1), 0, loc, C, N)
    (z * z).sum().backward()
    assert torch.allclose(loc.grad, (2 * z).sum(0).detach(), rtol=1e-6, atol=1e-5)
    want = torch.tril((2 * z).detach().T @ u)
    assert torch.allclose(C.grad, want, rtol=1e-5, atol=1e-5)


# the main path's shapes, then ragged ones: n not a multiple of a block's
# rows, d not a multiple of a panel's 32 columns
TRI_SHAPES = [(256, 1024), (10, 512), (10, 62), (7, 100)] + [
    (n, d) for n in (1, 3, 7, 256, 300) for d in (1, 5, 33, 62, 100, 512, 1000, 1024)
    if (n, d) not in ((256, 1024), (7, 100))]


@pytest.mark.parametrize("mode", ["C", "CT"])
@pytest.mark.parametrize("n,d", TRI_SHAPES)
def test_trisolve_kernel_meets_its_residual_bound(dev, mode, n, d):
    _, _, L = normal_fullrank_wellcond(d, d, device="cpu")
    C = (L + torch.triu(torch.ones(d, d), 1)).to(dev)  # the upper triangle is ignored
    V = torch.randn(n, d, generator=torch.Generator().manual_seed(n)).to(dev)
    before = solve_right_cuda.launches
    W = solve_right_cuda(C, V, mode)
    torch.cuda.synchronize()
    assert solve_right_cuda.launches == before + 1
    Ld = L.to(dev).double()
    op = Ld if mode == "C" else Ld.T
    resid = float((W.double() @ op - V.double()).norm() / V.double().norm())
    assert resid <= 1e-5, resid
    assert _rel(W, solve_right_reference(C, V, mode)) <= 1e-5


@pytest.mark.parametrize("mode", ["C", "CT"])
def test_trisolve_rows_a_block_give_the_same_bits(dev, mode):
    """Each sum runs over a panel's 32 columns in one order whatever rows a
    block owns, so every choice of rows gives the same bits."""
    from advancedvi_jl_tpu_torch.ops.cuda.trisolve_kernels import ROWS_PER_BLOCK

    n, d = 300, 1000
    _, _, L = normal_fullrank_wellcond(d, d, device="cpu")
    C, V = L.to(dev), torch.randn(n, d, generator=torch.Generator().manual_seed(1)).to(dev)
    W = solve_right_cuda(C, V, mode)
    for rows in ROWS_PER_BLOCK:
        assert torch.equal(W, solve_right_cuda(C, V, mode, rows)), rows
    with pytest.raises(ValueError, match="rows"):
        solve_right_cuda(C, V, mode, 3)


def test_vdiv_backward_launches_the_other_mode(dev):
    d, n = 256, 24
    _, _, L = normal_fullrank_wellcond(0, d, device="cpu")
    C = L.to(dev).requires_grad_(True)
    V = torch.randn(n, d, device=dev, requires_grad=True)
    ct = torch.randn(n, d, device=dev)
    for f, mode in ((vdiv_c, "C"), (vdiv_ct, "CT")):
        before = solve_right_cuda.launches
        gC, gV = torch.autograd.grad((f(C, V) * ct).sum(), (C, V))
        assert solve_right_cuda.launches == before + 2
        Cd, Vd = C.detach().double().requires_grad_(True), V.detach().double().requires_grad_(True)
        op = Cd if mode == "C" else Cd.T
        W = torch.linalg.solve_triangular(op, Vd, upper=mode == "CT", left=False)
        rC, rV = torch.autograd.grad((W * ct.double()).sum(), (Cd, Vd))
        assert _rel(torch.tril(gC), torch.tril(rC)) <= 1e-5
        assert _rel(gV, rV) <= 1e-5


def _fullrank_case(model, dev, d=512):
    """The flagship logreg (d = 62), or the dense Gaussian at d."""
    if model == "logreg":
        prob = make_logreg(11, device=dev)
        spec = logreg_spec(prob.X, prob.y)
        C0 = 0.1 * torch.eye(prob.dim, device=dev)
    else:
        target, mu, L = normal_fullrank_wellcond(3, d, device=dev)
        spec = mvnormal_spec(mu, L)
        C0 = torch.eye(d, device=dev)
    d = spec.dim
    vec = torch.zeros(4, d, device=dev)
    mat = torch.stack([C0, torch.zeros_like(C0), torch.zeros_like(C0), C0])
    return spec, vec, mat


@pytest.mark.parametrize("model,d", [("logreg", 62), ("mvnormal", 33), ("mvnormal", 100),
                                     ("mvnormal", 512)])
@pytest.mark.parametrize("injected", [True, False], ids=["noise", "philox"])
def test_fused_fullrank_kernel_matches_plain_version(dev, model, d, injected):
    """d = 33 and 100 end in a ragged whitening panel; at d = 512 the scale
    matrices live in device memory."""
    spec, vec, mat = _fullrank_case(model, dev, d)
    d = spec.dim
    noise = torch.randn((20, N, d), generator=torch.Generator().manual_seed(2)).to(dev)
    args = (spec.model, spec.consts, spec.scalars, vec, mat, seed_words(0), 0, 20, N,
            FusedHyper(), noise if injected else None)
    kv, km, ke, kt = fused_fullrank_run_chunk_cuda(*args, log_every=5)
    rv, rm, re, rt = fused_fullrank_run_chunk_reference(*args, log_every=5)
    torch.cuda.synchronize()
    # norm-wise: the sums run in another order in the kernel
    for a, b in zip(list(kv) + list(km), list(rv) + list(rm)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert torch.allclose(ke, re, rtol=1e-5, atol=1e-4)
    assert torch.allclose(kt, rt, rtol=1e-5, atol=1e-4)
    assert torch.equal(torch.triu(km[0], 1), torch.triu(mat[0], 1))


@pytest.mark.parametrize("model", ["logreg", "mvnormal"])
def test_fused_fullrank_kernel_chunks_and_traces_bitwise(dev, model):
    spec, vec, mat = _fullrank_case(model, dev)
    eng = FusedADVI(spec, family="fullrank")
    s0 = eng.init(vec[0], mat[0])
    whole = eng.run_chunk(s0, 7, 60)
    split = eng.run_chunk(eng.run_chunk(s0, 7, 20), 7, 40)
    traced, trace = eng.run_chunk_traced(s0, 7, 60, log_every=10)
    for f in ("mu", "sig", "m_mu", "v_mu", "m_sig", "v_sig", "avg_mu", "avg_sig"):
        assert torch.equal(getattr(whole, f), getattr(split, f)), f
        assert torch.equal(getattr(whole, f), getattr(traced, f)), f
    assert torch.equal(trace[-1], whole.elbo) and trace.shape == (6,)


# The cluster kernel (fused_advi_fullrank_cluster_kernel): one chunk on cs
# blocks, split by output, so every size gives the single-block bits.
CLUSTER_CASES = [("logreg", 62), ("mvnormal", 33), ("mvnormal", 100), ("mvnormal", 512),
                 ("gaussian", 100)]
CLUSTER_BRANCHES = {
    "adam": FusedBranch(),
    "descent": FusedBranch("descent"),
    "cocob": FusedBranch("cocob"),
    "stl_zero_prox": FusedBranch("descent", "stl_zero_grad", "repgrad", "prox"),
    "cf_zero": FusedBranch("adam", "closed_form_zero_grad"),
}


def _cluster_case(model, d, dev, branch):
    """A served model and the engine's initial rows for the branch (COCOB's
    seven)."""
    if model == "gaussian":
        g = torch.Generator().manual_seed(d)
        spec = gaussian_spec(torch.randn(d, generator=g).to(dev),
                             (0.5 + torch.rand(d, generator=g)).to(dev))
        C0 = torch.eye(d, device=dev)
    else:
        spec, _, mat = _fullrank_case(model, dev, d)
        C0 = mat[0]
    eng = _engine(spec, "fullrank", branch)
    vec, mat = eng.init(torch.zeros(spec.dim, device=dev), C0).stacked_fullrank(
        with_ext=branch.algo == "cocob")
    return spec, vec, mat


def _bits_equal(a, b):
    """Bit for bit, NaN payloads included."""
    return torch.equal(a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32))


def _cluster_sizes(d):
    return [cs for cs in (2, 4, 8, 16) if cs <= -(-d // 32)]


@pytest.mark.parametrize("branch", list(CLUSTER_BRANCHES), ids=list(CLUSTER_BRANCHES))
@pytest.mark.parametrize("model,d", CLUSTER_CASES)
def test_fullrank_cluster_is_the_single_block_kernel(dev, model, d, branch):
    """Every cluster size gives the single-block kernel's bits: 20 injected
    noise steps and 60 Philox steps, traced."""
    br = CLUSTER_BRANCHES[branch]
    spec, vec, mat = _cluster_case(model, d, dev, br)
    noise = torch.randn((20, N, spec.dim), generator=torch.Generator().manual_seed(4)).to(dev)
    for nz, steps in ((noise, 20), (None, 60)):
        args = (spec.model, spec.consts, spec.scalars, vec, mat, seed_words(2), 0, steps, N,
                FusedHyper(), nz, 10, br)
        one = fused_fullrank_run_chunk_cuda(*args, cluster=1)
        for cs in _cluster_sizes(spec.dim):
            got = fused_fullrank_run_chunk_cuda(*args, cluster=cs)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(one[1]).all()), "the case diverged"
            for a, b in zip(one, got):
                assert _bits_equal(a, b), (cs, nz is None)


@pytest.mark.parametrize("model,d", CLUSTER_CASES)
def test_fullrank_cluster_matches_plain_version(dev, model, d):
    """At every size: norm-wise 1e-5 after 20 injected-noise steps, 1e-4
    after 200 Philox steps (float32 transcendentals and sums in another
    order, carried by Adam)."""
    spec, vec, mat = _cluster_case(model, d, dev, FusedBranch())
    noise = torch.randn((20, N, spec.dim), generator=torch.Generator().manual_seed(2)).to(dev)
    for nz, steps, rtol in ((noise, 20, 1e-5), (None, 200, 1e-4)):
        args = (spec.model, spec.consts, spec.scalars, vec, mat, seed_words(0), 0, steps, N,
                FusedHyper(), nz, 5)
        rv, rm, re, rt = fused_fullrank_run_chunk_reference(*args)
        for cs in _cluster_sizes(spec.dim):
            kv, km, ke, kt = fused_fullrank_run_chunk_cuda(*args, cluster=cs)
            torch.cuda.synchronize()
            _norm_close(list(kv) + list(km), list(rv) + list(rm), rtol)
            assert torch.allclose(ke, re, rtol=rtol, atol=10 * rtol)
            assert torch.allclose(kt, rt, rtol=rtol, atol=10 * rtol)
            assert torch.equal(torch.triu(km[0], 1), torch.triu(mat[0], 1))


@pytest.mark.parametrize("model,d", CLUSTER_CASES)
def test_fullrank_cluster_chunks_and_traces_bitwise(dev, model, d):
    """run_chunk(60) equals run_chunk(20) then run_chunk(40), and a traced
    run the untraced one, at every cluster size."""
    spec, vec, mat = _cluster_case(model, d, dev, FusedBranch())
    base = (spec.model, spec.consts, spec.scalars)
    for cs in _cluster_sizes(spec.dim):
        whole = fused_fullrank_run_chunk_cuda(*base, vec, mat, seed_words(7), 0, 60, N,
                                              FusedHyper(), cluster=cs)
        half = fused_fullrank_run_chunk_cuda(*base, vec, mat, seed_words(7), 0, 20, N,
                                             FusedHyper(), cluster=cs)
        split = fused_fullrank_run_chunk_cuda(*base, half[0], half[1], seed_words(7), 20, 40, N,
                                              FusedHyper(), cluster=cs)
        traced = fused_fullrank_run_chunk_cuda(*base, vec, mat, seed_words(7), 0, 60, N,
                                               FusedHyper(), None, 10, cluster=cs)
        torch.cuda.synchronize()
        for a, b, c in zip(whole[:3], split[:3], traced[:3]):
            assert torch.equal(a, b) and torch.equal(a, c), cs
        assert float(traced[3][-1]) == float(whole[2]) and traced[3].shape == (6,)


# The cluster kernel's layout, a block's bytes at n = 10, keyed (n_data, db,
# d, k, cs) (n_data > 0: the logreg; else mvnormal or the Gaussian, which
# share a layout): tests/test_torch_fullrank_cluster.py's CLUSTER_LAYOUTS,
# the figures it hands the wrapper's rule on the CPU.
CLUSTER_LAYOUTS = {
    (208, 32, 33, 4, 2): 70280, (208, 32, 33, 7, 2): 83348,
    (208, 61, 62, 4, 2): 120856, (208, 61, 62, 7, 2): 145408,
    (208, 127, 128, 4, 2): 174524, (208, 127, 128, 4, 4): 221592,
    (208, 127, 128, 7, 2): 176060, (208, 127, 128, 7, 4): 169880,
    (0, 0, 33, 4, 2): 30344, (0, 0, 33, 7, 2): 43412,
    (0, 0, 62, 4, 2): 56792, (0, 0, 62, 7, 2): 81344,
    (0, 0, 100, 4, 2): 146748, (0, 0, 100, 4, 4): 91448,
    (0, 0, 100, 7, 2): 224748, (0, 0, 100, 7, 4): 131048,
    (0, 0, 200, 4, 2): 106884, (0, 0, 200, 4, 4): 84348,
    (0, 0, 200, 7, 2): 109284, (0, 0, 200, 7, 4): 86748,
    (0, 0, 512, 4, 2): 172308, (0, 0, 512, 4, 4): 155908,
    (0, 0, 512, 4, 8): 209148, (0, 0, 512, 4, 16): 205048,
    (0, 0, 512, 7, 2): 178452, (0, 0, 512, 7, 4): 162052,
    (0, 0, 512, 7, 8): 215292, (0, 0, 512, 7, 16): 211192,
    (850, 61, 62, 4, 2): 278912,
}


def test_fullrank_cluster_shared_memory_is_the_kernels(dev):
    """The kernel's make_cluster_layout count (what the wrapper hands
    cluster_blocks and check_cluster) equals the figures the CPU tests hand
    the rule, for the logreg, mvnormal and the Gaussian."""
    smem = _build.function("fused_advi_fullrank", "fused_advi_fullrank_cluster_smem_bytes",
                           [ctypes.c_int] * 7, restype=ctypes.c_size_t)
    for (n_data, db, d, k, cs), want in CLUSTER_LAYOUTS.items():
        models = ("logreg",) if n_data else ("mvnormal", "gaussian")
        for model in models:
            assert smem(MODEL_CODES[model], n_data, db, N, d, k, cs) == want, (model, d, k, cs)


@pytest.mark.parametrize("model,d", [("logreg", 62), ("mvnormal", 100), ("mvnormal", 512),
                                     ("gaussian", 512)])
def test_fullrank_cluster_elbo_and_trace_at_the_largest_size(dev, model, d):
    """At the largest size the kernel takes, with injected noise (the draws
    a bare copy, the fastest they can be) and a trace row every step, the
    ELBO and the trace are the single-block kernel's bits, run after run:
    rank 0's |u|^2 waits for this step's draws."""
    spec, vec, mat = _cluster_case(model, d, dev, FusedBranch())
    noise = 3.0 * torch.randn((50, N, spec.dim),
                              generator=torch.Generator().manual_seed(9)).to(dev)
    args = (spec.model, spec.consts, spec.scalars, vec, mat, seed_words(3), 0, 50, N,
            FusedHyper(), noise, 1)
    one = fused_fullrank_run_chunk_cuda(*args, cluster=1)
    cs = _cluster_sizes(spec.dim)[-1]
    for _ in range(5):
        got = fused_fullrank_run_chunk_cuda(*args, cluster=cs)
        torch.cuda.synchronize()
        assert _bits_equal(one[2], got[2]) and _bits_equal(one[3], got[3]), cs


def test_fullrank_cluster_launches_are_counted_apart(dev):
    """The rule's cluster launch adds to ``cluster_launches``, a forced
    single block to ``launches``; every size is schedulable at d = 512."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import cluster_max_active

    spec, vec, mat = _fullrank_case("mvnormal", dev)
    args = (spec.model, spec.consts, spec.scalars, vec, mat, seed_words(0), 0, 2, N,
            FusedHyper())
    one = fused_fullrank_run_chunk_cuda.launches
    many = fused_fullrank_run_chunk_cuda.cluster_launches
    fused_fullrank_run_chunk_cuda(*args)
    fused_fullrank_run_chunk_cuda(*args, cluster=1)
    torch.cuda.synchronize()
    assert fused_fullrank_run_chunk_cuda.launches == one + 1
    assert fused_fullrank_run_chunk_cuda.cluster_launches == many + 1
    for cs in _cluster_sizes(512):
        assert cluster_max_active(MODEL_CODES["mvnormal"], 0, 0, N, 512, 4, cs) >= 1


def test_fused_fullrank_kernel_refuses_oversized_shared_memory(dev):
    """At d = 512 the largest sample count whose per-step arrays fit one
    block runs with every array in shared memory (the whitening's panel
    operators in device memory: they no longer fit beside), and one sample
    more, which the kernel once refused, runs on its tiered layout (u, z, g
    and w in the device workspace); both match their plain version.
    Descent, whose state is linear in the gradients: Adam's m / sqrt(v)
    magnifies their float32 rounding over 27 samples."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        GROUP_FR_DEVICE_LAYOUT, fullrank_layout)

    spec, vec, mat = _fullrank_case("mvnormal", dev)
    smem = _build.function("fused_advi_fullrank", "fused_advi_fullrank_smem_bytes",
                           [ctypes.c_int] * 7, restype=ctypes.c_size_t)
    n = max(m for m in range(1, 128) if smem(1, 0, 0, 0, m, 512, 4) <= _build.SMEM_LIMIT)
    assert smem(1, 0, 0, 0, n, 512, 4) + 4 * 16 * 1024 > _build.SMEM_LIMIT
    assert fullrank_layout()(1, 0, 0, 0, n, 512, 4)[0] == -1
    assert fullrank_layout()(1, 0, 0, 0, n + 1, 512, 4)[0] == 3
    for m in (n, n + 1):
        noise = torch.randn((20, m, 512), generator=torch.Generator().manual_seed(2)).to(dev)
        args = (spec.model, spec.consts, spec.scalars, vec, mat, (0, 0), 0, 20, m,
                FusedHyper(), noise, 0, FusedBranch("descent"))
        before = fused_fullrank_run_chunk_cuda.group_launches[GROUP_FR_DEVICE_LAYOUT]
        kv, km, _, _ = fused_fullrank_run_chunk_cuda(*args, cluster=1)
        rv, rm, _, _ = fused_fullrank_run_chunk_reference(*args)
        torch.cuda.synchronize()
        assert fused_fullrank_run_chunk_cuda.group_launches[GROUP_FR_DEVICE_LAYOUT] == \
            before + (m > n)
        _norm_close(list(kv) + list(km), list(rv) + list(rm), 1e-5)


def test_built_libraries_report_no_spills(dev):
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import ad_program
    from advancedvi_jl_tpu_torch import ad_spec

    logs = [_build.build(name).with_suffix(".log") for name in _build.KERNELS]
    # the flagship's generated K5 mean-field and chains libraries
    prog = ad_program(ad_spec(make_logreg(11, device=dev).unconstrained()), N)
    logs += [_build.build_generated(k, prog.source).with_suffix(".log")
             for k in ("fused_advi_meanfield", "fused_chains")]
    for path in logs:
        log = path.read_text()
        spills = [ln for ln in log.splitlines() if "spill stores" in ln]
        assert spills and all(", 0 bytes spill stores, 0 bytes spill loads" in ln
                              for ln in spills), log


# (M, K, N, config, trans_b): the flagship's products at the tiles that
# emit them (the hand logits and gradient on the aligned layout and on the
# plain one, K5's logits and gradient, the minibatch body's logits and
# gradient: block_mm_kernels.CONFIGS), and edge shapes (one row, one
# column, one k, k not a multiple of 4, 61-float rows read by scalar loads,
# rows beyond a 10-row tile)
BLOCK_MM_CASES = [
    (10, 61, 208, 0, True), (10, 208, 61, 1, False), (10, 61, 208, 2, True),
    (10, 208, 61, 3, False), (10, 61, 208, 4, True), (10, 208, 61, 5, False),
    (1, 61, 208, 0, True), (10, 61, 1, 0, True), (10, 1, 61, 1, False), (7, 7, 9, 5, False),
    (23, 13, 5, 1, False), (3, 208, 61, 4, False), (16, 6, 30, 2, True), (12, 5, 17, 3, False),
    # the minibatch logits (betas x the slab's rows) and gradient (p x the
    # slab) at B = 512 and 40, db = 61 and 60, n = 10, 1 and 17
    (10, 61, 512, 6, True), (10, 60, 512, 6, True), (10, 512, 61, 7, False),
    (10, 512, 60, 7, False), (1, 61, 40, 6, True), (17, 60, 512, 6, True),
    (17, 40, 60, 7, False), (1, 512, 61, 7, False),
]


@pytest.mark.parametrize("M,K,N,config,trans_b", BLOCK_MM_CASES)
def test_block_mm_against_torch_mm(dev, M, K, N, config, trans_b):
    """csrc/block_mm.cuh against torch.mm in float32 (TF32 off): within a
    few float32 roundings of a K-term sum, and two launches give equal bits."""
    from advancedvi_jl_tpu_torch.ops.cuda.block_mm_kernels import block_mm_cuda

    g = torch.Generator().manual_seed(M * 1000 + K * 10 + N)
    A = torch.randn(M, K, generator=g).to(dev)
    B = torch.randn(K, N, generator=g).to(dev)
    before = block_mm_cuda.launches
    got = block_mm_cuda(A, B, config, trans_b)
    again = block_mm_cuda(A, B, config, trans_b)
    want = torch.mm(A.double(), B.double())
    torch.cuda.synchronize()
    assert block_mm_cuda.launches == before + 2
    assert torch.equal(got, again)
    scale = torch.mm(A.abs().double(), B.abs().double())
    assert float(((got.double() - want).abs() / scale.clamp_min(1e-30)).max()) < 4 * K * 6e-8


# ---------------------------------------------------------------------------
# The branches beyond STL x Adam x ClipScale: rules, entropies, operators,
# VarGrad and the diagonal-Gaussian body, in both fused kernels
# ---------------------------------------------------------------------------

PROX = [FusedBranch(a, e, "repgrad", "prox") for a in ("descent", "dowg", "dog")
        for e in ("closed_form_zero_grad", "stl_zero_grad")]
VARGRAD = [FusedBranch(a, "stl", "scoregrad", o)
           for a in ("adam", "descent", "dowg", "dog", "cocob") for o in ("clip", "none")]
COCOB_FR = FusedBranch("cocob", "stl", "repgrad", "clip")


def _case(family, model, branch, lr=1e-3, alpha=1e-6, warm=None, steps=50):
    """DoWG and DoG start with r0 = 1e-6 (1 + |x0|): their first steps move
    the scale by less than its float32 rounding, so there the plain version
    in float32 is itself ~1e-3 from float64; their comparisons start after
    300 steps of the kernel, where float32 holds ~1e-7."""
    if warm is None:
        warm = 300 if branch.algo in ("dowg", "dog") else 0
    return pytest.param(family, model, branch, lr, alpha, warm, steps,
                        id=f"{family}-{model}-{branch.algo}-{branch.entropy}-"
                           f"{branch.grad_est}-{branch.operator}")


# the cases of chip_smoke.py phase (n); VarGrad's score gradient on the
# logreg is ~100x the pathwise one (descent's step 1e-5); without ClipScale
# VarGrad-DoWG lets sigma cross zero within ~60 steps, and full-rank DoWG on
# the logreg runs away after ~40 (both as in the JAX package): 10 steps
# after a short warm-up there
CASES = (
    [_case("meanfield", "logreg", b) for b in PROX]
    + [_case("meanfield", "logreg", b, lr=1e-5 if b.algo == "descent" else 1e-3)
       for b in VARGRAD if (b.algo, b.operator) != ("dowg", "none")]
    + [_case("meanfield", "logreg", VARGRAD[5], warm=40, steps=10)]
    + [_case("meanfield", "gaussian", b) for b in (FusedBranch(), PROX[2], VARGRAD[8])]
    + [_case("fullrank", "gaussian", b) for b in PROX]
    + [_case("fullrank", "logreg", b, alpha=1e-4, warm=20, steps=10) for b in PROX[2:4]]
    + [_case("fullrank", "logreg", b, lr=1e-4, alpha=1e-4, warm=100 if b.algo == "dog" else 0)
       for b in PROX[:2] + PROX[4:]]
    + [_case("fullrank", "logreg", COCOB_FR), _case("fullrank", "mvnormal", PROX[2])]
)


def _spec(model, dev):
    """(spec, initial scale): the flagship logreg, normal-lognormal d = 11 or
    the dense Gaussian d = 512."""
    if model == "logreg":
        prob = make_logreg(11, device=dev)
        return logreg_spec(prob.X, prob.y), 0.1
    if model == "mvnormal":
        _, mu, L = normal_fullrank_wellcond(3, 512, device=dev)
        return mvnormal_spec(mu, L), 1.0
    t, _, _ = make_normallognormal(5, 10, device=dev)
    return normallognormal_spec(t), 0.2


def _engine(spec, family, branch, lr=1e-3, alpha=1e-6):
    eng = FusedADVI(spec, family=family, n_samples=N, lr=lr)
    eng.algo, eng.entropy, eng.grad_est, eng.operator = (
        branch.algo, branch.entropy, branch.grad_est, branch.operator)
    eng.alpha = alpha
    return eng


def _init(eng, s0):
    d = eng.dim
    return eng.init(torch.zeros(d), s0 * (torch.ones(d) if eng.family == "meanfield"
                                          else torch.eye(d)))


def _norm_close(got, want, rtol):
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= rtol * b.abs().max()


@pytest.mark.parametrize("family,model,branch,lr,alpha,warm,steps", CASES)
def test_fused_branch_matches_plain_version(dev, family, model, branch, lr, alpha, warm, steps):
    spec, s0 = _spec(model, dev)
    eng = _engine(spec, family, branch, lr, alpha)
    st = _init(eng, s0)
    if family == "meanfield":
        rows = (st.stacked(),)
        kern, plain = fused_run_chunk_cuda, fused_run_chunk_reference
    else:
        rows = st.stacked_fullrank()
        kern, plain = fused_fullrank_run_chunk_cuda, fused_fullrank_run_chunk_reference
    nr = len(rows)
    if warm:
        rows = kern(spec.model, spec.consts, spec.scalars, *rows, seed_words(1), 0, warm, N,
                    eng.hyp, branch=branch)[:nr]
    noise = torch.randn((steps, N, spec.dim), generator=torch.Generator().manual_seed(2)).to(dev)
    args = (spec.model, spec.consts, spec.scalars, *rows, seed_words(0), warm, steps, N,
            eng.hyp, noise, steps // 5, branch)
    before = dict(kern.group_launches)
    k = kern(*args)
    r = plain(*args)
    torch.cuda.synchronize()
    for g in branch.groups(spec.model):
        assert kern.group_launches[g] == before[g] + 1, g
    _norm_close([t for x in k[:nr] for t in x], [t for x in r[:nr] for t in x], 1e-5)
    assert torch.allclose(k[nr], r[nr], rtol=1e-5, atol=1e-4)
    assert torch.allclose(k[nr + 1], r[nr + 1], rtol=1e-5, atol=1e-4)
    if family == "fullrank":
        assert torch.equal(torch.triu(k[1], 1), torch.triu(rows[1], 1))


@pytest.mark.parametrize("family,model,branch", [
    ("meanfield", "logreg", PROX[4]), ("meanfield", "logreg", VARGRAD[-2]),
    ("fullrank", "gaussian", PROX[3]), ("fullrank", "logreg", COCOB_FR)],
    ids=lambda v: v if isinstance(v, str) else f"{v.algo}-{v.entropy}-{v.grad_est}")
def test_fused_branch_chunks_and_traces_bitwise(dev, family, model, branch):
    spec, s0 = _spec(model, dev)
    eng = _engine(spec, family, branch)
    st = _init(eng, s0)
    whole = eng.run_chunk(st, 7, 60)
    split = eng.run_chunk(eng.run_chunk(st, 7, 20), 7, 40)
    traced, trace = eng.run_chunk_traced(st, 7, 60, log_every=10)
    for f in ("mu", "sig", "m_mu", "v_mu", "m_sig", "v_sig", "avg_mu", "avg_sig"):
        assert bool(torch.isfinite(getattr(whole, f)).all()), f
        assert torch.equal(getattr(whole, f), getattr(split, f)), f
        assert torch.equal(getattr(whole, f), getattr(traced, f)), f
    for a, b, c in zip(whole.ext or (), split.ext or (), traced.ext or ()):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(trace[-1], whole.elbo)


def test_cocob_rows_count_in_the_shared_memory_refusal(dev):
    """Mean-field: a design that fits beside 8 state rows but not beside
    COCOB's 14 (JAX's engine takes both) runs COCOB on the kWide layout,
    the design read in device memory, and matches its plain version: STL
    COCOB within 1e-5; VarGrad COCOB, whose coefficients f_i - fbar cancel
    log densities of the size of the ~770 data (its float32 plain version
    is itself up to ~1e-5 from a float64 run here), no further from the
    float64 run than twice the plain version is.  Full-rank: when COCOB's 7
    scale matrices do not fit in shared memory they live in device memory,
    and the kernel still matches its plain version."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import KWIDE, fused_layout

    smem = _build.function("fused_advi_meanfield", "fused_advi_meanfield_smem_bytes",
                           [ctypes.c_int] * 7, restype=ctypes.c_size_t)
    n_data = next(m for m in range(600, 1200)
                  if smem(0, m, 61, 0, N, 62, 8) <= _build.SMEM_LIMIT
                  < smem(0, m, 61, 0, N, 62, 14))
    assert fused_layout("fused_advi_meanfield")(0, n_data, 61, 0, N, 62, 14)[:1] == (KWIDE,)
    X = torch.randn(n_data, 61, generator=torch.Generator().manual_seed(0)).to(dev) / 8
    y = (torch.rand(n_data, generator=torch.Generator().manual_seed(1)) < 0.5).float().to(dev)
    spec = logreg_spec(X, y)
    noise = torch.randn((20, N, 62), generator=torch.Generator().manual_seed(2)).to(dev)
    for branch in (FusedBranch("cocob", "stl", "repgrad", "clip"), VARGRAD[-2]):
        rows = _init(_engine(spec, "meanfield", branch), 0.1).stacked()
        args = ("logreg", spec.consts, spec.scalars, rows, (0, 0), 0, 20, N, FusedHyper(),
                noise, 0, branch)
        k_rows, _, _ = fused_run_chunk_cuda(*args)
        r_rows, _, _ = fused_run_chunk_reference(*args)
        torch.cuda.synchronize()
        if branch.grad_est == "repgrad":
            _norm_close(k_rows, r_rows, 1e-5)
            continue
        r64, _, _ = fused_run_chunk_reference(
            "logreg", (X.double(), y.double()), spec.scalars, rows.double(), (0, 0), 0, 20, N,
            FusedHyper(), noise.double(), 0, branch)
        for a, b, c in zip(k_rows.double(), r_rows.double(), r64):
            own = float((b - c).abs().max())
            assert float((a - c).abs().max()) <= 2 * own + 1e-6 * float(c.abs().max())

    fr_smem = _build.function("fused_advi_fullrank", "fused_advi_fullrank_smem_bytes",
                              [ctypes.c_int] * 7, restype=ctypes.c_size_t)
    d = next(k for k in range(60, 200)
             if fr_smem(2, 0, 0, 0, N, k, 7) < fr_smem(2, 0, 0, 0, N, k, 4))
    spec = gaussian_spec(torch.zeros(d, device=dev), torch.ones(d, device=dev))
    branch = COCOB_FR
    vec, mat = _init(_engine(spec, "fullrank", branch), 0.5).stacked_fullrank()
    args = (spec.model, spec.consts, spec.scalars, vec, mat, seed_words(0), 0, 20, N,
            FusedHyper(), None, 0, branch)
    kv, km, _, _ = fused_fullrank_run_chunk_cuda(*args)
    rv, rm, _, _ = fused_fullrank_run_chunk_reference(*args)
    torch.cuda.synchronize()
    _norm_close(list(kv) + list(km), list(rv) + list(rm), 1e-4)


# ---------------------------------------------------------------------------
# K4's minibatch body in both fused kernels, its three slab transports, and
# the K9 probes
# ---------------------------------------------------------------------------

MB_N, MB_B = 4096, 512  # 8 batches of 512 rows of the 60-feature logreg (db = 61)


def _mb_specs(dev, n_data=MB_N, batch=MB_B, n_features=60):
    """The in-place, staged and prefetching specs of one permutation."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        logreg_minibatch_hbm_spec, logreg_minibatch_spec)

    prob = make_logreg(11, n_data=n_data, n_features=n_features, device=dev)
    kw = dict(batch_size=batch, generator=5)
    return (logreg_minibatch_spec(prob.X, prob.y, **kw),
            logreg_minibatch_hbm_spec(prob.X, prob.y, prefetch=False, **kw),
            logreg_minibatch_hbm_spec(prob.X, prob.y, **kw))


MB_CASES = (
    [pytest.param("meanfield", b, id=f"meanfield-{b.algo}-{b.entropy}-{b.grad_est}")
     for b in (FusedBranch(), PROX[2], VARGRAD[4])]
    + [pytest.param("fullrank", b, id=f"fullrank-{b.algo}-{b.entropy}")
       for b in (FusedBranch(), PROX[2])]
)


@pytest.mark.parametrize("family,branch", MB_CASES)
def test_minibatch_transports_match_plain_version_and_each_other(dev, family, branch):
    """17 steps of injected noise wrap the 8-batch schedule twice; DoWG
    starts after 300 steps (see _case)."""
    specs = _mb_specs(dev)
    nb = MB_N // MB_B
    steps = 2 * nb + 1
    warm = 300 if branch.algo == "dowg" else 0
    noise = torch.randn((steps, N, specs[0].dim),
                        generator=torch.Generator().manual_seed(2)).to(dev)
    outs = []
    for spec in specs:
        eng = _engine(spec, family, branch)
        st = _init(eng, 0.1)
        if family == "meanfield":
            rows = (st.stacked(),)
            kern, plain = fused_run_chunk_cuda, fused_run_chunk_reference
        else:
            rows = st.stacked_fullrank()
            kern, plain = fused_fullrank_run_chunk_cuda, fused_fullrank_run_chunk_reference
        nr = len(rows)
        if warm:
            rows = kern(spec.model, spec.consts, spec.scalars, *rows, seed_words(1), 0, warm,
                        N, eng.hyp, branch=branch)[:nr]
        args = (spec.model, spec.consts, spec.scalars, *rows, seed_words(0), warm, steps, N,
                eng.hyp, noise, 0, branch)
        group = branch.groups(spec.model)[-1]
        before = kern.group_launches[group]
        k = kern(*args)
        assert kern.group_launches[group] == before + 1
        outs.append(k)
    r = plain(*args)
    torch.cuda.synchronize()
    _norm_close([t for x in outs[0][:nr] for t in x], [t for x in r[:nr] for t in x], 1e-5)
    assert torch.allclose(outs[0][nr], r[nr], rtol=1e-5, atol=1e-4)
    for other in outs[1:]:  # one code path reads the slab where each transport put it
        assert all(torch.equal(a, b) for a, b in zip(outs[0][:nr + 1], other[:nr + 1]))


@pytest.mark.parametrize("transport", [0, 1, 2], ids=["inplace", "staged", "prefetch"])
@pytest.mark.parametrize("family", ["meanfield", "fullrank"])
def test_minibatch_chunks_and_traces_bitwise(dev, transport, family):
    """Splits at 3 + 4 (between a prefetch and its use) and across the
    schedule's wrap; traced equal to untraced."""
    spec = _mb_specs(dev)[transport]
    eng = FusedADVI(spec, family=family, n_samples=N)
    st = _init(eng, 0.1)
    whole = eng.run_chunk(st, 7, 20)
    split = eng.run_chunk(eng.run_chunk(eng.run_chunk(st, 7, 3), 7, 4), 7, 13)
    traced, trace = eng.run_chunk_traced(st, 7, 20, log_every=5)
    for f in ("mu", "sig", "m_mu", "v_mu", "m_sig", "v_sig", "avg_mu", "avg_sig"):
        assert bool(torch.isfinite(getattr(whole, f)).all()), f
        assert torch.equal(getattr(whole, f), getattr(split, f)), f
        assert torch.equal(getattr(whole, f), getattr(traced, f)), f
    assert torch.equal(trace[-1], whole.elbo)


# (n_samples, batch, n_features) beyond the main shape (10, 512, 60 + the
# intercept): the streamed data's even width (db = 60), a batch that is not
# a multiple of 32, one sample, and 17 (two of the products' 10-row tiles)
MB_SHAPES = [(10, 512, 59), (10, 40, 60), (1, 512, 60), (17, 512, 60), (17, 40, 59)]


@pytest.mark.parametrize("n,batch,features", MB_SHAPES,
                         ids=[f"n{n}-B{b}-db{f + 1}" for n, b, f in MB_SHAPES])
def test_minibatch_shapes_match_plain_version(dev, n, batch, features):
    """The mean-field kernel: every transport within rtol 1e-5 of the plain
    version after 17 injected-noise steps (the 8-batch schedule twice) and
    the three bit-equal; the chains kernel (3 chains, staged, Philox) within
    1e-5 of its plain version and each chain the single-chain kernel's bits."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import (
        FusedChainsADVI, fused_chains_run_chunk_cuda, fused_chains_run_chunk_reference)
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import chain_seed_words

    specs = _mb_specs(dev, n_data=8 * batch, batch=batch, n_features=features)
    d, steps = specs[0].dim, 17
    noise = torch.randn((steps, n, d), generator=torch.Generator().manual_seed(2)).to(dev)
    outs = []
    for spec in specs:
        eng = FusedADVI(spec, n_samples=n)
        args = (spec.model, spec.consts, spec.scalars, _init(eng, 0.1).stacked(),
                seed_words(0), 0, steps, n, eng.hyp, noise)
        outs.append(fused_run_chunk_cuda(*args))
    r = fused_run_chunk_reference(*args)
    torch.cuda.synchronize()
    _norm_close(list(outs[0][0]), list(r[0]), 1e-5)
    assert torch.allclose(outs[0][1], r[1], rtol=1e-5, atol=1e-4)
    for other in outs[1:]:
        assert torch.equal(outs[0][0], other[0]) and torch.equal(outs[0][1], other[1])
    eng = FusedChainsADVI(specs[1], n_chains=3, n_samples=n)
    g = torch.Generator().manual_seed(4)
    st = eng.init((0.2 * torch.randn(3, d, generator=g)).to(dev),
                  0.1 * torch.ones(3, d, device=dev))
    cargs = (eng.model.model, eng.model.consts, eng.model.scalars, st.stacked(),
             eng.chain_seeds(3), 0, 20, n, eng.hyp, None, 0, eng.branch(), eng.lrs, eng.rules)
    k_rows, k_elbo, _ = fused_chains_run_chunk_cuda(*cargs)
    r_rows, r_elbo, _ = fused_chains_run_chunk_reference(*cargs)
    torch.cuda.synchronize()
    _norm_close(list(k_rows.flatten(0, 1)), list(r_rows.flatten(0, 1)), 1e-5)
    assert torch.allclose(k_elbo, r_elbo, rtol=1e-5, atol=1e-4)
    for c in range(3):
        one, e1, _ = fused_run_chunk_cuda(specs[1].model, specs[1].consts, specs[1].scalars,
                                          st.stacked()[c].contiguous(), chain_seed_words(3, c),
                                          0, 20, n, eng.hyp)
        assert torch.equal(one, k_rows[c]) and torch.equal(e1, k_elbo[c]), c


def test_minibatch_staged_slab_refused_at_the_shared_memory_edge(dev):
    """The staged transports keep one B-row slab in shared memory, beside
    (mean-field) the aligned beta copy, where it fits: in each fused kernel
    the largest B that fits runs there, and B + 8, which the kernels once
    refused, runs on its device-memory tier (the mean-field kMbWide group's
    tier 1, the logits in the workspace; the full-rank tiered layout's tier
    1, the slab read in place); both match their plain version after 9
    injected-noise steps (rtol 1e-5) and equal the in-place transport's
    bits.  The full-rank kernel keeps a 512-row slab of 61 features and its
    four d = 62 scale matrices in shared memory."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        KMB_WIDE, MODEL_CODES, fullrank_layout, fused_layout)

    mf = _build.function("fused_advi_meanfield", "fused_advi_meanfield_smem_bytes",
                         [ctypes.c_int] * 7, restype=ctypes.c_size_t)
    fr = _build.function("fused_advi_fullrank", "fused_advi_fullrank_smem_bytes",
                         [ctypes.c_int] * 7, restype=ctypes.c_size_t)
    assert fr(4, 4096, 61, 512, N, 62, 4) == 226884
    code = MODEL_CODES["logreg_minibatch_staged"]
    for family, smem, k in (("meanfield", mf, 8), ("fullrank", fr, 4)):
        B = max(b for b in range(8, 2048, 8)
                if smem(code, 8 * b, 61, b, N, 62, k) <= _build.SMEM_LIMIT)
        for batch, tiered in ((B, False), (B + 8, True)):
            if family == "meanfield":
                group, _, _, tier = fused_layout("fused_advi_meanfield")(
                    code, 4 * batch, 61, batch, N, 62, k)
                assert (group == KMB_WIDE, tier) == (tiered, 1 if tiered else -1)
            else:
                assert fullrank_layout()(code, 4 * batch, 61, batch, N, 62, k)[0] == \
                    (1 if tiered else -1)
            specs = _mb_specs(dev, n_data=4 * batch, batch=batch)
            noise = torch.randn((9, N, 62), generator=torch.Generator().manual_seed(2)).to(dev)
            outs = []
            for spec in (specs[1], specs[0]):
                eng = FusedADVI(spec, family=family, n_samples=N)
                outs.append(eng.run_chunk(_init(eng, 0.1), 0, 9, noise=noise))
            plain = FusedADVI(specs[1], family=family, n_samples=N, interpret=True)
            want = plain.run_chunk(_init(plain, 0.1), 0, 9, noise=noise)
            torch.cuda.synchronize()
            fields = ("mu", "sig", "m_mu", "v_mu", "m_sig", "v_sig", "avg_mu", "avg_sig")
            _norm_close([getattr(outs[0], f) for f in fields], [getattr(want, f) for f in fields],
                        1e-5)
            assert all(torch.equal(getattr(outs[0], f), getattr(outs[1], f)) for f in fields)


def test_probe_kernels_equal_their_plain_versions(dev):
    from advancedvi_jl_tpu_torch.ops.cuda.probe_kernels import (
        probe_cuda, probe_inputs, probe_reference, run_probes)

    before = probe_cuda.launches
    outs = run_probes(dev)
    assert probe_cuda.launches == before + 4
    for i, x in probe_inputs(dev).items():
        assert torch.equal(outs[i], probe_reference(i, x, device=dev)), i
    # rows that differ: the rem schedule reads windows 0, 1, 2, 0, ...
    x = torch.arange(3 * 8 * 128, dtype=torch.float32, device=dev).reshape(24, 128) % 7
    assert torch.equal(probe_cuda(4, x), probe_reference(4, x))


def _probe_x(i, steps, lanes, nb, fill, dev):
    from advancedvi_jl_tpu_torch.ops.cuda.probe_kernels import ROWS

    rows = ROWS * (steps if i == 1 else nb)
    if fill == "ones":
        return torch.ones(rows, lanes, device=dev)
    if fill == "mod7":
        return (torch.arange(rows * lanes, dtype=torch.float32, device=dev) % 7).reshape(
            rows, lanes)
    g = torch.Generator().manual_seed(steps * 7 + lanes + nb)
    return torch.randn(rows, lanes, generator=g).to(dev)


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("lanes", [32, 128, 1024])
@pytest.mark.parametrize("steps", [0, 1, 15, 16, 17])
def test_probe_kernels_at_every_plan_shape(dev, monkeypatch, steps, lanes, nb):
    """Each probe at the plan's shapes: exactly the plain version on
    integer-valued x (ones, arange % 7: every sum exact in float32); on
    normals within 1e-5 of sum |x| (torch.sum keeps its own order); out
    handed to the kernel full of NaN, and every element written."""
    from advancedvi_jl_tpu_torch.ops.cuda.probe_kernels import probe_cuda, probe_reference

    empty = torch.empty

    def nan_empty(*args, **kwargs):  # the wrapper's out: garbage, here NaN
        return empty(*args, **kwargs).fill_(float("nan"))

    for i in (1, 2, 3, 4):
        for fill in (("ones", "mod7", "normal") if i in (1, 4) else (None,)):
            x = _probe_x(i, steps, lanes, nb, fill, dev) if fill else None
            with monkeypatch.context() as m:
                m.setattr(torch, "empty", nan_empty)
                got = probe_cuda(i, x, steps, lanes, nb, dev)
            want = probe_reference(i, x, steps, lanes, nb, dev)
            torch.cuda.synchronize()
            assert not got.isnan().any(), (i, fill)
            if fill == "normal":
                k = torch.arange(steps, device=dev) % nb if i == 4 else torch.arange(steps)
                mass = sum(float(x[8 * j:8 * j + 8].abs().sum()) for j in k.tolist())
                assert float((got - want).abs().max()) <= 1e-5 * mass, (i, fill)
            else:
                assert torch.equal(got, want), (i, fill)


# ---------------------------------------------------------------------------
# K6, the multi-chain kernel, and K7c, the low-rank sampler
# ---------------------------------------------------------------------------

C8 = 8
MIXED_RULES = ["adam", "descent", "dowg", "dog", "cocob", "adam", "dowg", "cocob"]
CHAIN_CASES = {
    "stl-adam-clip": dict(),
    "lr-sweep": dict(lr=[1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 2e-3, 5e-4, 1e-3]),
    "mixed": dict(optimizer=MIXED_RULES, alpha=1e-2),
    "prox-dowg": dict(optimizer="dowg", entropy="closed_form_zero_grad", operator="prox",
                      alpha=1e-2),
    "vargrad-dowg-clip": dict(optimizer="dowg", grad_est="scoregrad", operator="clip",
                              alpha=1e-2),
    "cocob": dict(optimizer="cocob"),
}


def _chains_engine(dev, kw, spec=None):
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import FusedChainsADVI

    if spec is None:
        prob = make_logreg(11, device=dev)
        spec = logreg_spec(prob.X, prob.y)
    eng = FusedChainsADVI(spec, n_chains=C8, n_samples=N, **kw)
    g = torch.Generator().manual_seed(4)
    st = eng.init((0.2 * torch.randn(C8, spec.dim, generator=g)).to(dev),
                  0.1 * torch.ones(C8, spec.dim, device=dev))
    return eng, st


def _chains_args(eng, st, steps, noise, log_every):
    return (eng.model.model, eng.model.consts, eng.model.scalars,
            st.stacked(with_ext=eng.n_rows == 14), eng.chain_seeds(3), st.iteration, steps,
            eng.n_samples, eng.hyp, noise, log_every, eng.branch(), eng.lrs, eng.rules)


@pytest.mark.parametrize("case", list(CHAIN_CASES))
@pytest.mark.parametrize("injected", [True, False], ids=["noise", "philox"])
def test_chains_kernel_matches_plain_version(dev, case, injected):
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import (
        fused_chains_run_chunk_cuda, fused_chains_run_chunk_reference)

    eng, st = _chains_engine(dev, CHAIN_CASES[case])
    rules = CHAIN_CASES[case].get("optimizer", "adam")
    if any(r in ("dowg", "dog") for r in ([rules] if isinstance(rules, str) else rules)):
        st = eng.run_chunk(st, 1, 300)  # past DoWG's rounding-dominated start (see _case)
    steps = 20
    noise = (torch.randn((steps, C8, N, eng.dim), generator=torch.Generator().manual_seed(2))
             .to(dev) if injected else None)
    args = _chains_args(eng, st, steps, noise, 5)
    before = fused_chains_run_chunk_cuda.launches
    k_rows, k_elbo, k_tr = fused_chains_run_chunk_cuda(*args)
    r_rows, r_elbo, r_tr = fused_chains_run_chunk_reference(*args)
    torch.cuda.synchronize()
    assert fused_chains_run_chunk_cuda.launches == before + 1
    assert k_tr.shape == (steps // 5, C8)
    # norm-wise per state row of every chain, as the single-chain kernel
    _norm_close(list(k_rows.flatten(0, 1)), list(r_rows.flatten(0, 1)), 1e-5)
    assert torch.allclose(k_elbo, r_elbo, rtol=1e-5, atol=1e-4)
    assert torch.allclose(k_tr, r_tr, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ["stl-adam-clip", "mixed"])
def test_chains_kernel_chain_is_the_single_chain_kernel(dev, case):
    """Chain c runs the single-chain body keyed by chain_seed_words(3, c):
    the same bits as fused_advi_meanfield for every chain."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import FusedBranch
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import fused_chains_run_chunk_cuda
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import chain_seed_words

    eng, st = _chains_engine(dev, CHAIN_CASES[case])
    rows, elbo, _ = fused_chains_run_chunk_cuda(*_chains_args(eng, st, 30, None, 0))
    rules = MIXED_RULES if case == "mixed" else ["adam"] * C8
    full = st.stacked(with_ext=eng.n_rows == 14)
    for c in range(C8):
        b = eng.branch()
        branch = FusedBranch(rules[c], b.entropy, b.grad_est, b.operator, b.cocob_alpha)
        n_rows = 14 if rules[c] == "cocob" else 8
        one, e1, _ = fused_run_chunk_cuda(eng.model.model, eng.model.consts, eng.model.scalars,
                                          full[c, :n_rows].contiguous(), chain_seed_words(3, c),
                                          0, 30, N, eng.hyp, branch=branch)
        assert torch.equal(one, rows[c, :n_rows]), c
        assert torch.equal(e1, elbo[c]), c


def test_chains_kernel_chunks_and_traces_bitwise(dev):
    eng, st = _chains_engine(dev, CHAIN_CASES["mixed"])
    whole = eng.run_chunk(st, 7, 30)
    split = eng.run_chunk(eng.run_chunk(st, 7, 3), 7, 27)
    traced, trace = eng.run_chunk_traced(st, 7, 30, log_every=10)
    for a, b, c in zip(whole.stacked(), split.stacked(), traced.stacked()):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert trace.shape == (3, C8) and torch.equal(trace[-1], whole.elbo)


def test_chains_kernel_runs_the_minibatch_transports(dev):
    outs = []
    for spec in _mb_specs(dev):
        eng, st = _chains_engine(dev, {}, spec)
        outs.append(eng.run_chunk(st, 5, 17).stacked())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(outs[0]).all())
    assert all(torch.equal(outs[0], o) for o in outs[1:])


# Blocks of G chains: (case, engine arguments, model) of the bitwise checks:
# the flagship branch, a mixed sweep, COCOB, VarGrad (DoWG, clip), the
# closed-form zero-gradient entropy with the prox operator (DoWG), the
# diagonal Gaussian at d = 11 (up to 32 chains a block) and at d = 512, and
# the three minibatch transports
G_CASES = {
    "flagship": (dict(), "logreg"),
    "mixed": (dict(optimizer=MIXED_RULES, alpha=1e-2), "logreg"),
    "cocob": (dict(optimizer="cocob"), "logreg"),
    "staged-minibatch": (dict(), "staged"),
    "vargrad": (CHAIN_CASES["vargrad-dowg-clip"], "logreg"),
    "prox": (CHAIN_CASES["prox-dowg"], "logreg"),
    "gaussian": (dict(), "gaussian-11"),
    "gaussian-512": (dict(), "gaussian-512"),
    "gaussian-2048": (dict(), "gaussian-2048"),
    "inplace-minibatch": (dict(), "inplace"),
    "prefetch-minibatch": (dict(), "prefetch"),
}
# the largest G each layout fits where it is below 32 (the flagship's is 8;
# the diagonal Gaussian's kGauss block, csrc/fused_gauss_body.cuh, 6 at
# d = 512 and 2 at 2,048)
G_CAPS = {"staged-minibatch": 3, "prefetch-minibatch": 3, "inplace-minibatch": 6,
          "gaussian-512": 6, "gaussian-2048": 2}


def _g_spec(dev, which):
    if which == "logreg":
        prob = make_logreg(11, device=dev)
        return logreg_spec(prob.X, prob.y)
    if which.startswith("gaussian"):
        d = int(which.split("-")[1])
        g = torch.Generator().manual_seed(d)
        return gaussian_spec(torch.randn(d, generator=g).to(dev),
                             (0.5 + torch.rand(d, generator=g)).to(dev))
    return _mb_specs(dev)[("inplace", "staged", "prefetch").index(which)]


def _g_engine(dev, case, G):
    """An engine of G x the card's SMs chains (G chains a block where the
    layout fits, else the fewest a block that keep the waves), its state,
    past DoWG's and DoG's start (see _case), and the G it launches with."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import FusedChainsADVI, device_sms

    kw, which = G_CASES[case]
    spec = _g_spec(dev, which)
    C = G * device_sms(dev)
    if "optimizer" in kw and isinstance(kw["optimizer"], list):
        kw = dict(kw, optimizer=(kw["optimizer"] * C)[:C])
    eng = FusedChainsADVI(spec, n_chains=C, n_samples=N, **kw)
    g = torch.Generator().manual_seed(4)
    st = eng.init((0.2 * torch.randn(C, spec.dim, generator=g)).to(dev),
                  0.1 * torch.ones(C, spec.dim, device=dev))
    rules = kw.get("optimizer", "adam")
    if any(r in ("dowg", "dog") for r in ([rules] if isinstance(rules, str) else rules)):
        st = eng.run_chunk(st, 1, 300)
    return eng, st, eng.chains_per_block()


def _expected_g(case, G):
    cap = G_CAPS.get(case, 32)
    return -(-G // -(-G // cap))


G_PARAMS = [pytest.param(case, G, id=f"{G}-{case}") for G in (2, 8) for case in G_CASES] + [
    pytest.param("gaussian", 32, id="32-gaussian")]


@pytest.mark.parametrize("case,G", G_PARAMS)
def test_chains_blocks_of_g_chains_are_the_single_chain_kernel(dev, case, G):
    """At C = G x SMs each block takes G chains where the layout fits (else
    the fewest chains a block that fill as few waves); chains 0, G - 1, G
    and C - 1 equal the single-chain kernel keyed by their words, bit for
    bit, after 30 Philox steps."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import fused_chains_run_chunk_cuda
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import chain_seed_words

    eng, st, g = _g_engine(dev, case, G)
    assert g == _expected_g(case, G) >= 2
    before = fused_chains_run_chunk_cuda.launches
    rows, elbo, _ = fused_chains_run_chunk_cuda(*_chains_args(eng, st, 30, None, 0))
    assert fused_chains_run_chunk_cuda.launches == before + 1
    full = st.stacked(with_ext=eng.n_rows == 14)
    rules = eng._rule_list or [eng.algo] * eng.n_chains
    C = eng.n_chains
    for c in (0, g - 1, g, C - 1):
        b = eng.branch()
        branch = FusedBranch(rules[c], b.entropy, b.grad_est, b.operator, b.cocob_alpha)
        n_rows = 14 if rules[c] == "cocob" else 8
        one, e1, _ = fused_run_chunk_cuda(eng.model.model, eng.model.consts, eng.model.scalars,
                                          full[c, :n_rows].contiguous(), chain_seed_words(3, c),
                                          st.iteration, 30, N, eng.hyp, branch=branch)
        assert torch.equal(one, rows[c, :n_rows]), c
        assert torch.equal(e1, elbo[c]), c


@pytest.mark.parametrize("case", list(G_CASES))
def test_chains_blocks_of_g_chains_match_plain_version(dev, case):
    """Blocks of G = 2 chains (C = 2 x SMs) against the plain version after
    20 injected-noise steps, traced (norm-wise 1e-5 per state row), and
    split or traced launches bit-equal to one untraced launch."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import (
        fused_chains_run_chunk_cuda, fused_chains_run_chunk_reference)

    eng, st, g = _g_engine(dev, case, 2)
    assert g == 2
    steps, C = 20, eng.n_chains
    noise = torch.randn((steps, C, N, eng.dim),
                        generator=torch.Generator().manual_seed(2)).to(dev)
    args = _chains_args(eng, st, steps, noise, 5)
    k_rows, k_elbo, k_tr = fused_chains_run_chunk_cuda(*args)
    r_rows, r_elbo, r_tr = fused_chains_run_chunk_reference(*args)
    u_rows, u_elbo, _ = fused_chains_run_chunk_cuda(*_chains_args(eng, st, steps, noise, 0))
    torch.cuda.synchronize()
    assert k_tr.shape == (steps // 5, C)
    _norm_close(list(k_rows.flatten(0, 1)), list(r_rows.flatten(0, 1)), 1e-5)
    assert torch.allclose(k_elbo, r_elbo, rtol=1e-5, atol=1e-4)
    assert torch.allclose(k_tr, r_tr, rtol=1e-5, atol=1e-4)
    assert torch.equal(k_rows, u_rows) and torch.equal(k_elbo, u_elbo)
    whole = eng.run_chunk(st, 7, 30)
    split = eng.run_chunk(eng.run_chunk(st, 7, 3), 7, 27)
    assert all(torch.equal(a, b) for a, b in zip(whole.stacked(), split.stacked()))


def test_chains_shared_memory_is_the_single_chain_kernels(dev):
    """A block of one chain takes the single-chain kernel's layout, a block
    of G chains the model's data once and G chains' arrays (the figures
    tests/test_torch_fused_chains.py's G_LAYOUTS hands the wrapper's rule;
    the diagonal Gaussian's kGauss layout G chains' arrays and nothing
    shared), a design too large for the aligned layout (771 x 61) runs one chain a
    block, and what does not fit one chain's block runs the kWide layout,
    one chain a block."""
    chains = _build.function("fused_chains", "fused_chains_smem_bytes", [ctypes.c_int] * 8,
                             restype=ctypes.c_size_t)
    single = _build.function("fused_advi_meanfield", "fused_advi_meanfield_smem_bytes",
                             [ctypes.c_int] * 7, restype=ctypes.c_size_t)
    # (model code, shape, (bytes of one chain, shared bytes, bytes a chain))
    for code, shape, (one, shared, per_chain) in (
            (0, (208, 61, 0, 10, 62, 8), (72800, 51584, 21120)),
            (0, (208, 61, 0, 10, 62, 14), (74288, 51584, 22608)),
            (0, (100, 5, 0, 3, 6, 14), (4516, 2400, 2012)),
            (0, (2600, 20, 0, 10, 21, 8), (326176, 218400, 107672)),
            (0, (3400, 16, 0, 10, 17, 8), (370336, 231200, 139032)),
            (0, (771, 61, 0, 10, 62, 8), (232384, 191208, 41080)),
            (2, (0, 0, 0, 10, 11, 8), (1384, 0, 1384)),
            (2, (0, 0, 0, 10, 512, 8), (33292, 0, 33292)),
            (2, (0, 0, 0, 10, 512, 14), (45580, 0, 45580)),
            (3, (4096, 61, 512, 10, 62, 8), (33632, 256, 33280)),
            (3, (16384, 61, 512, 10, 62, 8), (33632, 256, 33280)),
            (4, (4096, 61, 512, 16, 62, 14), (178504, 125184, 53224)),
            (4, (16384, 61, 512, 10, 62, 8), (158560, 125184, 33280)),
            (5, (16384, 61, 512, 10, 62, 14), (160048, 125184, 34768)),
            (5, (1024, 7, 128, 4, 8, 8), (6744, 3616, 3024))):
        assert chains(code, *shape, 1) == single(code, *shape) == one, (code, shape)
        for G in (2, 3, 8, 32):
            assert chains(code, *shape, G) == shared + G * per_chain, (code, shape, G)
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import FusedChainsADVI

    plain = make_logreg(11, n_data=771, device=dev)
    assert FusedChainsADVI(logreg_spec(plain.X, plain.y), n_chains=4096,
                           n_samples=N).chains_per_block() == 1
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import (
        FusedChainsADVI, fused_chains_run_chunk_cuda, fused_chains_run_chunk_reference)

    # 200 samples of the flagship do not fit one chain's block: each chain
    # runs the kWide layout with its own slice of the workspace
    prob = make_logreg(11, device=dev)
    eng = FusedChainsADVI(logreg_spec(prob.X, prob.y), n_chains=C8, n_samples=200)
    st = eng.init(torch.zeros(C8, prob.dim, device=dev), 0.1 * torch.ones(C8, prob.dim, device=dev))
    assert eng.chains_per_block(132) == 1
    args = (eng.model.model, eng.model.consts, eng.model.scalars, st.stacked(),
            eng.chain_seeds(3), 0, 5, 200, eng.hyp)
    k_rows, _, _ = fused_chains_run_chunk_cuda(*args)
    r_rows, _, _ = fused_chains_run_chunk_reference(*args)
    torch.cuda.synchronize()
    _norm_close(list(k_rows.flatten(0, 1)), list(r_rows.flatten(0, 1)), 1e-4)


@pytest.mark.parametrize("n,d,r", [(65_536, 256, 8), (10, 62, 8), (33, 5, 3), (300, 130, 17)])
def test_lowrank_sampler_kernel_matches_plain_version(dev, n, d, r):
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
        lowrank_sample_cuda, lowrank_sample_reference)

    g = torch.Generator().manual_seed(d)
    loc = torch.randn(d, generator=g).to(dev)
    D = (0.5 + torch.rand(d, generator=g)).to(dev)
    U = (0.3 * torch.randn(d, r, generator=g)).to(dev)
    before = lowrank_sample_cuda.launches
    z, u1, u2 = lowrank_sample_cuda(seed_words(3), 4, loc, D, U, n)
    zr, u1r, u2r = lowrank_sample_reference(seed_words(3), 4, loc, D, U, n)
    zm, um = meanfield_sample_cuda(seed_words(3), 4, loc, D, n)
    z0, _, _ = lowrank_sample_cuda(seed_words(3), 4, loc, D, torch.zeros_like(U), n)
    torch.cuda.synchronize()
    assert lowrank_sample_cuda.launches == before + 2
    assert torch.equal(u1, um) and torch.equal(u1, u1r) and torch.equal(u2, u2r)
    assert torch.equal(z0, zm)  # U = 0 draws the mean-field z
    assert _rel(z, zr) <= 1e-6  # the r-term sums run in another order


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("kernel,shape", [("meanfield", (10, 62)), ("meanfield", (1000, 129)),
                                          ("fullrank", (256, 1024)), ("fullrank", (33, 62)),
                                          ("lowrank", (300, 130, 17)), ("lowrank", (10, 62, 8))])
def test_samplers_draw_their_rows_at_a_row_offset(dev, kernel, shape, parts):
    """K7a, K7b and K7c at each rank's row offset (a mesh's "mc" axis cut
    into ``parts``): u (u1, u2) bit for bit the plain version's and the
    whole draw's rows; z of K7a both ways and of K7c against the whole draw
    (each element's sum is its own), z of K7b within 1e-6 of the plain
    version (a product over other tiles)."""
    from advancedvi_jl_tpu_torch.ops.cuda import location_scale_kernels as lsk
    from advancedvi_jl_tpu_torch.parallel.mesh import block

    n, d = shape[:2]
    g = torch.Generator().manual_seed(d)
    loc, D = torch.randn(d, generator=g).to(dev), (0.5 + torch.rand(d, generator=g)).to(dev)
    args = {"meanfield": (loc, D),
            "fullrank": (loc, torch.tril(0.1 * torch.randn(d, d, generator=g)).to(dev)
                         + torch.eye(d, device=dev)),
            "lowrank": (loc, D, (0.3 * torch.randn(d, shape[-1], generator=g)).to(dev))}[kernel]
    cuda = getattr(lsk, f"{kernel}_sample_cuda")
    plain = getattr(lsk, f"{kernel}_sample_reference")
    whole = cuda(seed_words(3), 4, *args, n)
    for i in range(parts):
        row0, k = block(n, parts, i)
        mine, ref = cuda(seed_words(3), 4, *args, k, row0=row0), plain(
            seed_words(3), 4, *args, k, row0=row0)
        torch.cuda.synchronize()
        rows = slice(row0, row0 + k)
        for a, b, w in zip(mine[1:], ref[1:], whole[1:]):
            assert torch.equal(a, b) and torch.equal(a, w[rows])
        assert _rel(mine[0], ref[0]) <= 1e-6
        if kernel != "fullrank":
            assert torch.equal(mine[0], whole[0][rows])
        if kernel == "meanfield":
            assert torch.equal(mine[0], ref[0])


def test_lowrank_sampler_autograd_on_the_card(dev):
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import lowrank_sample

    d, r = 62, 8
    loc = torch.zeros(d, device=dev, requires_grad=True)
    D = torch.ones(d, device=dev, requires_grad=True)
    U = (0.1 * torch.ones(d, r, device=dev)).requires_grad_(True)
    z, u1, u2 = lowrank_sample(seed_words(1), 0, loc, D, U, N)
    (z * z).sum().backward()
    ct = (2 * z).detach()
    assert torch.allclose(loc.grad, ct.sum(0), rtol=1e-6, atol=1e-5)
    assert torch.allclose(D.grad, (ct * u1).sum(0), rtol=1e-6, atol=1e-5)
    assert torch.allclose(U.grad, ct.T @ u2, rtol=1e-5, atol=1e-5)


def test_lowrank_sampler_refuses_oversized_rank(dev):
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import lowrank_sample_cuda

    d = 16
    with pytest.raises(ValueError, match="shared"):
        lowrank_sample_cuda((0, 0), 0, torch.zeros(d, device=dev), torch.ones(d, device=dev),
                            torch.zeros(d, 400, device=dev), 4)


def _ad_targets(dev):
    import advancedvi_jl_tpu_torch as avt

    prob = make_logreg(11, n_data=208, n_features=60, device=dev)
    nln, _, _ = make_normallognormal(0, 10, device=dev)
    anchor = torch.linspace(-1.0, 1.0, 5, device=dev)
    quartic = avt.fn_target(lambda t, a: -((t - a) ** 2).sum(-1) - 0.1 * ((t - a) ** 4).sum(-1),
                            5, anchor)
    return {"logreg": prob.unconstrained(), "nln": nln.unconstrained(), "quartic": quartic}


@pytest.mark.parametrize("name", ["logreg", "nln", "quartic"])
@pytest.mark.parametrize("family", ["meanfield", "fullrank"])
def test_k5_body_matches_plain_version(dev, name, family):
    """K5's generated body in the mean-field and full-rank kernels against
    the graph's replay, 30 injected-noise steps (norm-wise 1e-5)."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import ad_spec

    target = _ad_targets(dev)[name]
    spec = ad_spec(target)
    d = spec.dim
    eng = FusedADVI(spec, family=family, n_samples=N)
    prog = eng.ad
    scale = 0.1 * (torch.ones(d, device=dev) if family == "meanfield"
                   else torch.eye(d, device=dev))
    st = eng.init(torch.zeros(d, device=dev), scale)
    noise = torch.randn((30, N, d), generator=torch.Generator().manual_seed(2)).to(dev)
    args = ("ad", prog.consts, (), (0, 0), 0, 30, N, eng.hyp, noise)
    if family == "meanfield":
        rows = st.stacked()
        k = fused_run_chunk_cuda(*args[:3], rows, *args[3:], ad=prog)[0]
        r = fused_run_chunk_reference(*args[:3], rows, *args[3:], ad=prog)[0]
    else:
        vec, mat = st.stacked_fullrank()
        k = torch.cat([t.flatten() for t in fused_fullrank_run_chunk_cuda(
            *args[:3], vec, mat, *args[3:], ad=prog)[:2]])
        r = torch.cat([t.flatten() for t in fused_fullrank_run_chunk_reference(
            *args[:3], vec, mat, *args[3:], ad=prog)[:2]])
    torch.cuda.synchronize()
    assert float((k - r).abs().max()) <= 1e-5 * float(r.abs().max())


# ---------------------------------------------------------------------------
# The dense Gaussian and the kWide layout in the mean-field and chains
# kernels (csrc/fused_meanfield_body.cuh wide_layout)
# ---------------------------------------------------------------------------


def _wide_spec(dev, name):
    """(spec, n_samples) of a configuration JAX's mean-field engine takes
    that one block's shared memory cannot hold, or of the dense Gaussian."""
    if name.startswith("mvnormal"):
        d, _, n = name[len("mvnormal_d"):].partition("_n")
        _, mu, L = normal_fullrank_wellcond(3, int(d), device=dev)
        return mvnormal_spec(mu, L), int(n) if n else N
    if name == "logreg_512x199":
        prob = make_logreg(11, n_data=512, n_features=198, device=dev)
        return logreg_spec(prob.X, prob.y), N
    d, n = (2048, N) if name == "gaussian_d2048" else (512, 128)
    g = torch.Generator().manual_seed(d)
    return gaussian_spec(torch.randn(d, generator=g).to(dev),
                         (0.5 + torch.rand(d, generator=g)).to(dev)), n


WIDE_CASES = ["gaussian_d2048", "gaussian_d512_n128", "logreg_512x199", "mvnormal_d62",
              "mvnormal_d512", "mvnormal_d512_n128", "mvnormal_d2048"]


@pytest.mark.parametrize("name", WIDE_CASES)
def test_wide_layout_and_mvnormal_match_plain_version(dev, name):
    """Each configuration on the kWide group, the dense Gaussian on its
    kMvn instance (its tier by its size), or the diagonal Gaussian at the
    sizes that took kWide before its kGauss group, against the plain version: 30
    injected-noise steps within 1e-5 norm-wise, and a chunked Philox run and
    a traced one bitwise the whole run."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import GROUP_DEVICE_LAYOUT, GROUP_MVNORMAL

    spec, n = _wide_spec(dev, name)
    d = spec.dim
    rows = _rows(d, dev)
    noise = torch.randn((30, n, d), generator=torch.Generator().manual_seed(2)).to(dev)
    args = (spec.model, spec.consts, spec.scalars, rows, (0, 0), 0, 30, n, FusedHyper(), noise)
    before = dict(fused_run_chunk_cuda.group_launches)
    k_rows, k_elbo, _ = fused_run_chunk_cuda(*args)
    r_rows, r_elbo, _ = fused_run_chunk_reference(*args)
    torch.cuda.synchronize()
    _norm_close(k_rows, r_rows, 1e-5)
    assert torch.allclose(k_elbo, r_elbo, rtol=1e-5, atol=1e-4)
    after = fused_run_chunk_cuda.group_launches
    assert after[GROUP_MVNORMAL] - before[GROUP_MVNORMAL] == int(spec.model == "mvnormal")
    # the diagonal Gaussian runs its kGauss group, on no device-memory tier
    tiered = name != "mvnormal_d62" and spec.model != "gaussian"
    assert after[GROUP_DEVICE_LAYOUT] - before[GROUP_DEVICE_LAYOUT] == int(tiered)
    base = (spec.model, spec.consts, spec.scalars)
    whole, e1, _ = fused_run_chunk_cuda(*base, rows, (0, 7), 0, 40, n, FusedHyper())
    half, _, _ = fused_run_chunk_cuda(*base, rows, (0, 7), 0, 15, n, FusedHyper())
    two, e2, _ = fused_run_chunk_cuda(*base, half, (0, 7), 15, 25, n, FusedHyper())
    traced, e3, trace = fused_run_chunk_cuda(*base, rows, (0, 7), 0, 40, n, FusedHyper(), None, 10)
    torch.cuda.synchronize()
    assert torch.equal(whole, two) and torch.equal(e1, e2)
    assert torch.equal(whole, traced) and torch.equal(e1, e3) and float(trace[-1]) == float(e1)


@pytest.mark.parametrize("name,C", [("mvnormal_d62", C8), ("mvnormal_d62", 264),
                                    ("gaussian_d2048", C8), ("mvnormal_d512", C8),
                                    ("mvnormal_d512", 264), ("mvnormal_d2048", C8),
                                    ("mvnormal_d512_n128", C8)])
def test_wide_chains_match_plain_version_and_the_single_chain_kernel(dev, name, C):
    """K6 on the dense Gaussian (one chain a block, and two at C = 264 on
    132 SMs: at d = 62 P staged once for the block, at d = 512 streamed
    through the product's ring) and on the kWide layout (one chain a block,
    each with its slice of the workspace): 20 injected-noise steps within
    1e-5 of the plain version, and chains 0, G - 1, G and C - 1 of a Philox
    run bitwise the single-chain kernel."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import (
        FusedChainsADVI, fused_chains_run_chunk_cuda, fused_chains_run_chunk_reference)
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import chain_seed_words

    spec, n = _wide_spec(dev, name)
    d = spec.dim
    eng = FusedChainsADVI(spec, n_chains=C, n_samples=n)
    g = torch.Generator().manual_seed(4)
    st = eng.init((0.2 * torch.randn(C, d, generator=g)).to(dev), 0.1 * torch.ones(C, d, device=dev))
    G = eng.chains_per_block()
    if C == 264 and torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert G == 2
    noise = torch.randn((20, C, n, d), generator=torch.Generator().manual_seed(2)).to(dev)
    args = _chains_args(eng, st, 20, noise, 0)
    k_rows, k_elbo, _ = fused_chains_run_chunk_cuda(*args)
    r_rows, r_elbo, _ = fused_chains_run_chunk_reference(*args)
    p_rows, p_elbo, _ = fused_chains_run_chunk_cuda(*_chains_args(eng, st, 30, None, 0))
    torch.cuda.synchronize()
    _norm_close(list(k_rows.flatten(0, 1)), list(r_rows.flatten(0, 1)), 1e-5)
    assert torch.allclose(k_elbo, r_elbo, rtol=1e-5, atol=1e-4)
    rows = st.stacked()
    for c in sorted({0, G - 1, G % C, C - 1}):
        one, e1, _ = fused_run_chunk_cuda(spec.model, spec.consts, spec.scalars,
                                          rows[c].contiguous(), chain_seed_words(3, c), 0, 30,
                                          n, eng.hyp)
        assert torch.equal(one, p_rows[c]) and torch.equal(e1, p_elbo[c]), c


def test_wide_workspace_is_returned_after_each_chunk(dev):
    """The kWide workspace (K5's quartic at d = 2,048, n = 10: its scratch,
    u, z and g on tier 3) is allocated for a launch and handed back to the
    caching allocator after it: chunk after chunk, the allocated bytes come
    back to where they were and the reserved ones stop growing."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import KWIDE, fused_layout
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import FusedChainsADVI

    spec, n, _, _ = _tier_spec(dev, "ad_quartic_d2048_n10")
    eng = FusedADVI(spec, n_samples=n)
    group, _, ws, tier = fused_layout("fused_advi_meanfield", eng.ad.source)(
        MODEL_CODES["ad"], 0, 0, 0, n, 2048, 8)
    assert (group, tier) == (KWIDE, 3) and ws >= 3 * n * 2048
    ch = FusedChainsADVI(spec, n_chains=C8, n_samples=n)
    st, cs = _init(eng, 0.1), ch.init(torch.zeros(C8, 2048), 0.1 * torch.ones(C8, 2048))
    st, cs = eng.run_chunk(st, 0, 5), ch.run_chunk(cs, 0, 5)
    torch.cuda.synchronize()
    allocated, reserved = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
    for _ in range(3):
        st, cs = eng.run_chunk(st, 0, 5), ch.run_chunk(cs, 0, 5)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(dev) == allocated
        assert torch.cuda.memory_reserved(dev) == reserved


# The diagonal Gaussian's kGauss group (csrc/fused_gauss_body.cuh): every
# width JAX takes at n = 10 (d = 11: the normal-lognormal's width; 62: one
# slice of 16 lanes; 512 and 2,048: four and sixteen 32-lane slices) and
# d = 512 at n = 128, under every kind of rule
GAUSS_SHAPES = [(11, N), (62, N), (512, N), (2048, N), (512, 128)]
GAUSS_BRANCHES = {
    "adam": FusedBranch(),
    "descent-prox": PROX[0],
    "dowg": FusedBranch("dowg", "stl", "repgrad", "clip"),
    "cocob": COCOB_FR,
    "vargrad": FusedBranch("adam", "stl", "scoregrad", "clip"),
}


def _gauss_engine(dev, d, n, branch):
    g = torch.Generator().manual_seed(d)
    spec = gaussian_spec(torch.randn(d, generator=g).to(dev),
                         (0.5 + torch.rand(d, generator=g)).to(dev))
    eng = FusedADVI(spec, n_samples=n, lr=1e-3)
    eng.algo, eng.entropy, eng.grad_est, eng.operator = (
        branch.algo, branch.entropy, branch.grad_est, branch.operator)
    eng.alpha = 1e-2  # DoWG's r0 scale: see tests/test_torch_prox_scoregrad.py
    st = eng.init((0.2 * torch.randn(d, generator=g)).to(dev), 0.1 * torch.ones(d, device=dev))
    return spec, eng, st.stacked()


@pytest.mark.parametrize("branch", list(GAUSS_BRANCHES))
@pytest.mark.parametrize("d,n", GAUSS_SHAPES, ids=[f"d{d}-n{n}" for d, n in GAUSS_SHAPES])
def test_gauss_group_matches_plain_version(dev, d, n, branch):
    """kGauss at each width and branch, on no workspace: 30 injected-noise
    steps within 1e-5 norm-wise of the plain version (ELBO and trace too),
    40 Philox steps within 1e-4, and bitwise its 15 + 25 chunks and its
    traced run.  DoWG starts after 300 steps of the kernel (its cold start
    is rounding-dominated: chip_smoke.py's WARM).  VarGrad's coefficients
    cancel log densities of the size of d, so its noise steps are held to a
    float64 run of the plain version: each row within 1e-5 of it
    norm-wise, or no further from it than twice the float32 plain version
    is (the bar of VarGrad COCOB on the 771 x 61 logreg);
    the ELBO's absolute bar grows to 8 float32 ulps of its terms' size
    (|lognorm| + d) where that is larger than 1e-4."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import KGAUSS, GROUP_GAUSSIAN, fused_layout

    b = GAUSS_BRANCHES[branch]
    spec, eng, rows = _gauss_engine(dev, d, n, b)
    group, _, ws, tier = fused_layout("fused_advi_meanfield")(MODEL_CODES["gaussian"], 0, 0, 0,
                                                              n, d, rows.shape[0])
    assert (group, ws, tier) == (KGAUSS, 0, -1)
    base, hyp = (spec.model, spec.consts, spec.scalars), eng.hyp
    it0 = 0
    if b.algo == "dowg":
        rows, _, _ = fused_run_chunk_cuda(*base, rows, (0, 9), 0, 300, n, hyp, None, 0, b)
        it0 = 300
    atol = max(1e-4, 8 * 2.0 ** -23 * (abs(spec.scalars[0]) + d))
    noise = torch.randn((30, n, d), generator=torch.Generator().manual_seed(2)).to(dev)
    was = fused_run_chunk_cuda.group_launches[GROUP_GAUSSIAN]
    args = (*base, rows, (0, 5), it0, 30, n, hyp, noise, 5, b)
    k_rows, k_elbo, k_tr = fused_run_chunk_cuda(*args)
    r_rows, r_elbo, r_tr = fused_run_chunk_reference(*args)
    whole, e1, _ = fused_run_chunk_cuda(*base, rows, (0, 7), it0, 40, n, hyp, None, 0, b)
    plain, e0, _ = fused_run_chunk_reference(*base, rows, (0, 7), it0, 40, n, hyp, None, 0, b)
    half, _, _ = fused_run_chunk_cuda(*base, rows, (0, 7), it0, 15, n, hyp, None, 0, b)
    two, e2, _ = fused_run_chunk_cuda(*base, half, (0, 7), it0 + 15, 25, n, hyp, None, 0, b)
    traced, e3, trace = fused_run_chunk_cuda(*base, rows, (0, 7), it0, 40, n, hyp, None, 10, b)
    torch.cuda.synchronize()
    assert fused_run_chunk_cuda.group_launches[GROUP_GAUSSIAN] == was + 5
    if b.grad_est == "scoregrad":
        r64, _, _ = fused_run_chunk_reference(
            spec.model, tuple(t.double() for t in spec.consts), spec.scalars, rows.double(),
            (0, 5), it0, 30, n, hyp, noise.double(), 5, b)
        for a_, b_, c_ in zip(k_rows.double(), r_rows.double(), r64):
            own = float((b_ - c_).abs().max())
            assert float((a_ - c_).abs().max()) <= max(2 * own, 1e-5 * float(c_.abs().max()))
    else:
        _norm_close(k_rows, r_rows, 1e-5)
    assert torch.allclose(k_elbo, r_elbo, rtol=1e-5, atol=atol)
    assert torch.allclose(k_tr, r_tr, rtol=1e-5, atol=atol)
    _norm_close(whole, plain, 1e-4)
    assert torch.allclose(e1, e0, rtol=1e-4, atol=max(atol, 1e-3))
    assert torch.equal(whole, two) and torch.equal(e1, e2)
    assert torch.equal(whole, traced) and torch.equal(e1, e3) and float(trace[-1]) == float(e1)


def test_gauss_group_needs_no_workspace_at_any_width(dev):
    """The widest Gaussian JAX takes, d = 2,048 and n = 128 with COCOB's 14
    state rows, on the mean-field kernel and on K6 at any G: the kGauss
    group with no workspace, the kernel's count of its shared memory
    (gauss::layout_for: 14 and 2 rows of d, 2 x 128 x 16 slice partials,
    16, 128, 2 x 64, 5), and 10 injected-noise steps within 1e-5 of the plain
    version."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import KGAUSS, fused_layout

    code, n, d = MODEL_CODES["gaussian"], 128, 2048
    floats = 14 * d + 2 * d + 2 * n * 16 + 16 + n + 2 * 64 + 5
    assert fused_layout("fused_advi_meanfield")(code, 0, 0, 0, n, d, 14) == \
        (KGAUSS, 4 * floats, 0, -1)
    for G in (1, 2):
        assert fused_layout("fused_chains")(code, 0, 0, 0, n, d, 14, G) == \
            (KGAUSS, 4 * G * floats, 0, -1)
    spec, eng, rows = _gauss_engine(dev, d, n, COCOB_FR)
    noise = torch.randn((10, n, d), generator=torch.Generator().manual_seed(3)).to(dev)
    args = (spec.model, spec.consts, spec.scalars, rows, (0, 1), 0, 10, n, eng.hyp, noise, 0,
            COCOB_FR)
    k_rows, k_elbo, _ = fused_run_chunk_cuda(*args)
    r_rows, r_elbo, _ = fused_run_chunk_reference(*args)
    torch.cuda.synchronize()
    _norm_close(k_rows, r_rows, 1e-5)
    assert torch.allclose(k_elbo, r_elbo, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [1, N, 128])
@pytest.mark.parametrize("d", [5, 62, 101, 231, 512, 2048])
def test_mvnormal_product_matches_torch_mm(dev, n, d):
    """The dense Gaussian body's product alone (csrc/mvnormal_product.cuh
    through csrc/block_mm.cu block_mm_mvnormal, on the kMvn plan at n rows:
    P staged in shared memory below about d = 214 at n = 10, streamed
    through the TMA ring above; d % 4 != 0 on P's padded rows) on a random P
    that is not symmetric, against torch.mm in float64, within a few float32
    roundings of a d-term sum; two launches equal."""
    from advancedvi_jl_tpu_torch.ops.cuda.block_mm_kernels import mvnormal_product_cuda

    g = torch.Generator().manual_seed(d + n)
    A = torch.randn(n, d, generator=g).to(dev)
    P = torch.randn(d, d, generator=g).to(dev)
    got, again = mvnormal_product_cuda(A, P), mvnormal_product_cuda(A, P)
    torch.cuda.synchronize()
    want = torch.mm(A.double(), P.double())
    scale = torch.mm(A.abs().double(), P.abs().double())
    assert torch.equal(got, again)
    assert float(((got.double() - want).abs() / scale.clamp_min(1e-30)).max()) < 4 * d * 6e-8


@pytest.mark.parametrize("d,tier", [(62, 0), (200, 0), (231, 1), (512, 1), (1024, 3),
                                    (2048, 3)])
def test_mvnormal_runs_on_its_own_instances_and_the_products_plan(dev, d, tier):
    """The dense Gaussian takes the kMvn group on the mean-field and chains
    kernels at every width, on the tier its size gives at n = 10; the
    product's launcher runs the plan of that tier (the same shared bytes),
    and below the last tier a ring stage holds at least 32 KB of P."""
    from advancedvi_jl_tpu_torch.ops.cuda.block_mm_kernels import mvnormal_product_layout
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import KMVN, fused_layout

    code = MODEL_CODES["mvnormal"]
    group, smem, ws, got_tier = fused_layout("fused_advi_meanfield")(code, 0, 0, 0, N, d, 8)
    assert (group, got_tier) == (KMVN, tier)
    assert fused_layout("fused_chains")(code, 0, 0, 0, N, d, 8, 1)[::3] == (KMVN, tier)
    plan = mvnormal_product_layout(N, d)
    assert (plan["tier"], plan["smem_bytes"]) == (tier, smem)
    assert ws == (3 * N * d if tier == 3 else 0)
    stage_bytes = 4 * plan["ring_rows"] * (-(-d // 4) * 4)
    assert (plan["ring_rows"] == 0) if tier == 0 else stage_bytes >= (32768 if tier < 3 else 1)


# ---------------------------------------------------------------------------
# The tiered layouts: K5's body on the mean-field and chains kernels' kWide
# group, the minibatch transports' kMbWide group, and the full-rank
# single-block kernel's tier_layout
# ---------------------------------------------------------------------------


def _quartic_target(d, dev):
    import advancedvi_jl_tpu_torch as avt

    anchor = torch.linspace(-1.0, 1.0, d, device=dev)
    w = torch.linspace(1.0, 5.0, d, device=dev)
    return avt.fn_target(lambda t, a: -((t - a["anchor"]) ** 2 * a["w"]).sum(-1)
                         - 0.1 * ((t - a["anchor"]) ** 4).sum(-1), d,
                         {"anchor": anchor, "w": w})


def _wide_logreg_target(dev):
    import advancedvi_jl_tpu_torch as avt

    X = torch.randn(8192, 4, generator=torch.Generator().manual_seed(0)).to(dev)
    return avt.fn_target(lambda t, dat: -torch.log1p(torch.exp(t @ dat.T)).sum(-1), 4, X)


def _tier_spec(dev, name):
    """(spec, n_samples, branch, alpha) of a configuration on a tiered
    layout."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import ad_spec

    if name.startswith("ad_quartic_d"):
        d, n = (int(x) for x in name[len("ad_quartic_d"):].split("_n"))
        return ad_spec(_quartic_target(d, dev)), n, FusedBranch(), 1e-6
    if name == "ad_wide_logreg":
        return ad_spec(_wide_logreg_target(dev)), N, FusedBranch(), 1e-6
    if name.startswith("mb_"):  # mb_<transport>_B<batch>_n<n>[_db<db>]
        parts = name.split("_")
        transport = ("inplace", "staged", "prefetch").index(parts[1])
        batch, n = int(parts[2][1:]), int(parts[3][1:])
        features = int(parts[4][2:]) - 1 if len(parts) > 4 else 60
        n_data = 4096 if batch * 4 <= 4096 else 4 * batch
        return _mb_specs(dev, n_data=n_data, batch=batch, n_features=features)[transport], n, \
            FusedBranch(), 1e-6
    if name.startswith("mvnormal_d512_n128"):
        _, mu, L = normal_fullrank_wellcond(3, 512, device=dev)
        algo = name.rsplit("_", 1)[1]
        branch = FusedBranch() if algo == "adam" else \
            FusedBranch(algo, "closed_form_zero_grad", "repgrad", "prox")
        return mvnormal_spec(mu, L), 128, branch, 1e-2
    n_data, feats = {"logreg_512x199_dowg": (512, 198), "logreg_4096x61_n16": (4096, 60)}[name]
    prob = make_logreg(11, n_data=n_data, n_features=feats, device=dev)
    n = 16 if name.endswith("n16") else N
    branch = FusedBranch("dowg", "closed_form_zero_grad", "repgrad", "prox") \
        if name.endswith("dowg") else FusedBranch()
    return logreg_spec(prob.X, prob.y), n, branch, 1e-4


# (family, configuration, group (mean-field) and tier): each tier of each
# new layout where its size puts it
TIER_CASES = [
    ("meanfield", "ad_wide_logreg", 3, 2), ("meanfield", "ad_quartic_d2048_n10", 3, 3),
    ("meanfield", "mb_staged_B800_n10", 4, 1), ("meanfield", "mb_staged_B1024_n10", 4, 2),
    ("meanfield", "mb_prefetch_B1024_n10", 4, 2), ("meanfield", "mb_inplace_B512_n128", 4, 1),
    ("meanfield", "mb_staged_B512_n128", 4, 2), ("meanfield", "mb_staged_B64_n32_db512", 4, 3),
    ("fullrank", "mb_staged_B1024_n10", None, 1), ("fullrank", "mb_prefetch_B1024_n10", None, 1),
    ("fullrank", "logreg_512x199_dowg", None, 1), ("fullrank", "logreg_4096x61_n16", None, 2),
    ("fullrank", "mvnormal_d512_n128_adam", None, 3),
    ("fullrank", "mvnormal_d512_n128_dowg", None, 3),
    ("fullrank", "mvnormal_d512_n128_dog", None, 3),
    ("fullrank", "ad_quartic_d256_n64", None, 3),
]


@pytest.mark.parametrize("family,name,group,tier", TIER_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in TIER_CASES])
def test_tiered_layouts_match_plain_version(dev, family, name, group, tier):
    """Each configuration runs on the tier its size gives (the launch's
    layout query and its launch group say so), matches the plain version
    after 20 injected-noise steps (norm-wise 1e-5; DoWG and DoG with r0
    scale 1e-2, 1e-4 on the logreg), and a 40-step Philox run equals its 15
    + 25 chunks and its traced run bit for bit (the logreg under full-rank
    DoWG, which runs away as JAX's does: 30 steps, 10 + 20, as _case's 20 +
    10).  The full-rank
    configurations run on one block (cluster=1)."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        GROUP_AD_DEVICE_LAYOUT, GROUP_FR_DEVICE_LAYOUT, GROUP_MB_DEVICE_LAYOUT, MODEL_CODES,
        FusedProxADVI, _model_args, fullrank_layout, fused_layout)

    spec, n, branch, alpha = _tier_spec(dev, name)
    eng = FusedProxADVI(spec, family=family, n_samples=n, optimizer=branch.algo, alpha=alpha) \
        if branch.operator == "prox" else FusedADVI(spec, family=family, n_samples=n)
    ad = eng.ad
    d = spec.dim
    st = eng.init(0.1 * torch.randn(d, generator=torch.Generator().manual_seed(1)).to(dev),
                  0.1 * (torch.ones(d, device=dev) if family == "meanfield"
                         else torch.eye(d, device=dev)))
    consts = spec.consts if ad is None else ad.consts
    body = None if ad is None else ad.source
    c0, c1, n_data, db, batch, _, _ = _model_args(spec.model, consts, spec.scalars, d, dev, n, ad)
    code = MODEL_CODES[spec.model]
    if family == "meanfield":
        rows = (st.stacked(),)
        got = fused_layout("fused_advi_meanfield", body)(code, n_data, db, batch, n, d, 8)
        assert (got[0], got[3]) == (group, tier)
        kern, plain = fused_run_chunk_cuda, fused_run_chunk_reference
        counted = GROUP_AD_DEVICE_LAYOUT if ad is not None else GROUP_MB_DEVICE_LAYOUT
    else:
        rows = st.stacked_fullrank()
        assert fullrank_layout(body)(code, n_data, db, batch, n, d, 4)[0] == tier
        kern = lambda *a: fused_fullrank_run_chunk_cuda(*a, cluster=1)  # noqa: E731
        plain, counted = fused_fullrank_run_chunk_reference, GROUP_FR_DEVICE_LAYOUT
    nr = len(rows)
    base = (spec.model, consts, spec.scalars)
    hyp = eng.hyp
    noise = torch.randn((20, n, d), generator=torch.Generator().manual_seed(2)).to(dev)
    counter = (fused_run_chunk_cuda if family == "meanfield"
               else fused_fullrank_run_chunk_cuda).group_launches
    was = counter[counted]
    k = kern(*base, *rows, (0, 0), 0, 20, n, hyp, noise, 0, branch, ad)
    r = plain(*base, *rows, (0, 0), 0, 20, n, hyp, noise, 0, branch, ad)
    torch.cuda.synchronize()
    assert counter[counted] == was + 1
    _norm_close([t for x in k[:nr] for t in x], [t for x in r[:nr] for t in x], 1e-5)
    assert torch.allclose(k[nr], r[nr], rtol=1e-5, atol=1e-4)
    total, first = (30, 10) if spec.model == "logreg" and branch.algo == "dowg" else (40, 15)
    whole = kern(*base, *rows, (0, 7), 0, total, n, hyp, None, 0, branch, ad)
    half = kern(*base, *rows, (0, 7), 0, first, n, hyp, None, 0, branch, ad)
    two = kern(*base, *half[:nr], (0, 7), first, total - first, n, hyp, None, 0, branch, ad)
    traced = kern(*base, *rows, (0, 7), 0, total, n, hyp, None, 10, branch, ad)
    torch.cuda.synchronize()
    for a, b, c in zip(whole[:nr + 1], two[:nr + 1], traced[:nr + 1]):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b) and torch.equal(a, c)
    assert float(traced[nr + 1][-1]) == float(whole[nr])


@pytest.mark.parametrize("name,group,tier", [("ad_quartic_d2048_n10", 3, 3),
                                             ("mb_staged_B1024_n10", 4, 2)])
def test_tiered_chains_match_plain_version_and_the_single_chain_kernel(dev, name, group, tier):
    """K6 at C = 8 on K5's quartic at d = 2,048 (kWide) and on the staged
    transport at B = 1,024 (kMbWide), one chain a block on its slice of the
    workspace: 20 injected-noise steps within 1e-5 of the plain version,
    and chains 0, 3 and 7 of a Philox run bitwise the single-chain kernel."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
        GROUP_AD_DEVICE_LAYOUT, GROUP_MB_DEVICE_LAYOUT, MODEL_CODES, _model_args, fused_layout)
    from advancedvi_jl_tpu_torch.ops.cuda.fused_chains import (
        FusedChainsADVI, fused_chains_run_chunk_cuda, fused_chains_run_chunk_reference)
    from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import chain_seed_words

    spec, n, _, _ = _tier_spec(dev, name)
    d = spec.dim
    eng = FusedChainsADVI(spec, n_chains=C8, n_samples=n)
    ad = eng.ad
    consts = spec.consts if ad is None else ad.consts
    c0, c1, n_data, db, batch, _, _ = _model_args(spec.model, consts, spec.scalars, d, dev, n, ad)
    got = fused_layout("fused_chains", None if ad is None else ad.source)(
        MODEL_CODES[spec.model], n_data, db, batch, n, d, 8, 1)
    assert (got[0], got[3]) == (group, tier) and eng.chains_per_block() == 1
    g = torch.Generator().manual_seed(4)
    st = eng.init((0.2 * torch.randn(C8, d, generator=g)).to(dev),
                  0.1 * torch.ones(C8, d, device=dev))
    noise = torch.randn((20, C8, n, d), generator=torch.Generator().manual_seed(2)).to(dev)
    counted = GROUP_AD_DEVICE_LAYOUT if ad is not None else GROUP_MB_DEVICE_LAYOUT
    was = fused_chains_run_chunk_cuda.group_launches[counted]
    args = list(_chains_args(eng, st, 20, noise, 0)) + [ad]
    args[1] = consts
    k_rows, k_elbo, _ = fused_chains_run_chunk_cuda(*args)
    r_rows, r_elbo, _ = fused_chains_run_chunk_reference(*args)
    pargs = list(_chains_args(eng, st, 30, None, 0)) + [ad]
    pargs[1] = consts
    p_rows, p_elbo, _ = fused_chains_run_chunk_cuda(*pargs)
    torch.cuda.synchronize()
    assert fused_chains_run_chunk_cuda.group_launches[counted] == was + 2
    _norm_close(list(k_rows.flatten(0, 1)), list(r_rows.flatten(0, 1)), 1e-5)
    assert torch.allclose(k_elbo, r_elbo, rtol=1e-5, atol=1e-4)
    rows = st.stacked()
    for c in (0, 3, C8 - 1):
        one, e1, _ = fused_run_chunk_cuda(spec.model, consts, spec.scalars, rows[c].contiguous(),
                                          chain_seed_words(3, c), 0, 30, n, eng.hyp, ad=ad)
        assert torch.equal(one, p_rows[c]) and torch.equal(e1, p_elbo[c]), c
