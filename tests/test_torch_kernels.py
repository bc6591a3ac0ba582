"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device (marker ``cuda``) and skips without one.
The module imports no JAX, so on a machine with a card and without JAX it
runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
"""

import pytest
import torch

from advancedvi_jl_tpu_torch.models.logreg import make_logreg
from advancedvi_jl_tpu_torch.models.normal import normal_fullrank_wellcond
from advancedvi_jl_tpu_torch.ops.cuda import _build
from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
    FusedADVI,
    FusedHyper,
    FusedLogRegADVI,
    fused_fullrank_run_chunk_cuda,
    fused_fullrank_run_chunk_reference,
    fused_run_chunk_cuda,
    fused_run_chunk_reference,
    logreg_spec,
    mvnormal_spec,
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


@pytest.mark.parametrize("injected", [True, False], ids=["noise", "philox"])
def test_fused_kernel_matches_plain_version(dev, injected):
    prob = make_logreg(11, device=dev)
    d = prob.dim
    noise = torch.randn((20, N, d), generator=torch.Generator().manual_seed(2)).to(dev)
    args = (prob.X, prob.y, (1.0, 3.0), _rows(d, dev), seed_words(0), 0, 20, N,
            FusedHyper(), noise if injected else None)
    k_rows, k_elbo, k_tr = fused_run_chunk_cuda(*args, log_every=5)
    r_rows, r_elbo, r_tr = fused_run_chunk_reference(*args, log_every=5)
    torch.cuda.synchronize()
    # norm-wise: sums over 208 data are taken in another order by the kernel
    for a, b in zip(k_rows, r_rows):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert torch.allclose(k_elbo, r_elbo, rtol=1e-5)
    assert torch.allclose(k_tr, r_tr, rtol=1e-5)


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
    X = torch.zeros(4096, 61, device=dev)
    y = torch.zeros(4096, device=dev)
    with pytest.raises(ValueError, match="shared"):
        fused_run_chunk_cuda(X, y, (1.0, 3.0), _rows(62, dev), (0, 0), 0, 1, N, FusedHyper())


def _rel(a, b) -> float:
    """Norm-wise relative difference ||a - b||_F / ||b||_F."""
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("n,d", [(256, 1024), (10, 62), (33, 5)])
def test_fullrank_sampler_kernel_matches_plain_version(dev, n, d):
    _, _, L = normal_fullrank_wellcond(n, d)
    loc = torch.randn(d, generator=torch.Generator().manual_seed(d)).to(dev)
    C = (L + torch.triu(torch.ones(d, d), 1)).to(dev)  # the upper triangle is ignored
    before = fullrank_sample_cuda.launches
    z, u = fullrank_sample_cuda(seed_words(3), 4, loc, C, n)
    zr, ur = fullrank_sample_reference(seed_words(3), 4, loc, C, n)
    _, umf = meanfield_sample_cuda(seed_words(3), 4, loc, torch.ones_like(loc), n)
    torch.cuda.synchronize()
    assert fullrank_sample_cuda.launches == before + 1
    assert torch.equal(u, umf) and (u - ur).abs().max() <= 1e-6
    # sums over d in another order than the plain product
    assert _rel(z, zr) <= 1e-6


def test_fullrank_sampler_autograd_on_the_card(dev):
    d = 62
    loc = torch.zeros(d, device=dev, requires_grad=True)
    C = torch.eye(d, device=dev).requires_grad_(True)
    z, u = fullrank_sample(seed_words(1), 0, loc, C, N)
    (z * z).sum().backward()
    assert torch.allclose(loc.grad, (2 * z).sum(0).detach(), rtol=1e-6, atol=1e-5)
    want = torch.tril((2 * z).detach().T @ u)
    assert torch.allclose(C.grad, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["C", "CT"])
@pytest.mark.parametrize("n,d", [(256, 1024), (10, 512), (10, 62), (7, 100)])
def test_trisolve_kernel_meets_its_residual_bound(dev, mode, n, d):
    _, _, L = normal_fullrank_wellcond(d, d)
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


def test_vdiv_backward_launches_the_other_mode(dev):
    d, n = 256, 24
    _, _, L = normal_fullrank_wellcond(0, d)
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


def _fullrank_case(model, dev):
    if model == "logreg":
        prob = make_logreg(11, device=dev)
        spec = logreg_spec(prob.X, prob.y)
        C0 = 0.1 * torch.eye(prob.dim, device=dev)
    else:
        target, mu, L = normal_fullrank_wellcond(3, 512, device=dev)
        spec = mvnormal_spec(mu, L)
        C0 = torch.eye(512, device=dev)
    d = spec.dim
    vec = torch.zeros(4, d, device=dev)
    mat = torch.stack([C0, torch.zeros_like(C0), torch.zeros_like(C0), C0])
    return spec, vec, mat


@pytest.mark.parametrize("model", ["logreg", "mvnormal"])
@pytest.mark.parametrize("injected", [True, False], ids=["noise", "philox"])
def test_fused_fullrank_kernel_matches_plain_version(dev, model, injected):
    spec, vec, mat = _fullrank_case(model, dev)
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


def test_fused_fullrank_kernel_refuses_oversized_shared_memory(dev):
    spec, vec, mat = _fullrank_case("mvnormal", dev)
    with pytest.raises(ValueError, match="shared"):
        fused_fullrank_run_chunk_cuda(spec.model, spec.consts, spec.scalars, vec, mat,
                                      (0, 0), 0, 1, 128, FusedHyper())


def test_built_libraries_report_no_spills(dev):
    for name in _build.KERNELS:
        log = _build.build(name).with_suffix(".log").read_text()
        spills = [ln for ln in log.splitlines() if "spill stores" in ln]
        assert spills and all(", 0 bytes spill stores, 0 bytes spill loads" in ln
                              for ln in spills), log
