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
from advancedvi_jl_tpu_torch.ops.cuda import _build
from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
    FusedHyper,
    FusedLogRegADVI,
    fused_run_chunk_cuda,
    fused_run_chunk_reference,
)
from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    meanfield_sample,
    meanfield_sample_cuda,
    meanfield_sample_reference,
    seed_words,
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


def test_built_libraries_report_no_spills(dev):
    for name in _build.KERNELS:
        log = _build.build(name).with_suffix(".log").read_text()
        assert "0 bytes spill stores" in log, log
