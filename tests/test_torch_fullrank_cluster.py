"""The full-rank kernel's thread-block cluster, on the CPU: the rule that
picks the cluster size (``cluster_blocks``), the panel partition the
kernel splits its work by, the cluster layout's shared memory, and the
refusal of a forced size the kernel cannot serve.  The kernel itself runs
only on a card (tests/test_torch_kernels.py: bitwise against the
single-block kernel at every size, and against the plain version)."""

import pytest
import torch

from advancedvi_jl_tpu_torch.models.logreg import make_logreg
from advancedvi_jl_tpu_torch.ops.cuda import _build
from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import (
    CLUSTER_SIZES,
    MINIBATCH_MODELS,
    PANEL,
    FusedBranch,
    FusedHyper,
    check_cluster,
    cluster_blocks,
    cluster_panels,
    fused_fullrank_run_chunk,
    gaussian_spec,
    logreg_spec,
    mvnormal_spec,
    panel_owner,
)

N = 10
N_DATA = 208  # the flagship logreg's rows

# The cluster kernel's layout, a block's bytes at n = 10, keyed (n_data, db,
# d, k, cs) (n_data > 0: the logreg; else mvnormal or the Gaussian, which
# share a layout): the kernel's own figures (make_cluster_layout), held
# equal to its count on the card by
# tests/test_torch_kernels.py::test_fullrank_cluster_shared_memory_is_the_kernels.
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


def _block_bytes(model, d, branch, n_data=N_DATA):
    """The stand-in for the kernel's count: cs -> a block's bytes."""
    n_data = n_data if model == "logreg" else 0
    key = (n_data, d - 1 if n_data else 0, d, 4 + branch.ext_rows // 2)
    return lambda cs: CLUSTER_LAYOUTS[key + (cs,)]


def _rule(model, d, branch, n_data=N_DATA):
    return cluster_blocks(model, d, N, branch, _block_bytes(model, d, branch, n_data))


def _allowed(d):
    """The cluster sizes the kernel takes at width d: powers of two up to
    16 and at most one block a panel."""
    return [cs for cs in CLUSTER_SIZES if cs > 1 and cs <= -(-d // PANEL)]


@pytest.mark.parametrize("algo", ["dowg", "dog"])
@pytest.mark.parametrize("model,d", [("logreg", 62), ("mvnormal", 512), ("gaussian", 100)])
def test_cluster_blocks_keeps_distance_rules_on_one_block(model, d, algo):
    """DoWG and DoG need a sum over every entry before any entry moves."""
    branch = FusedBranch(algo, "stl_zero_grad", "repgrad", "prox")
    assert _rule(model, d, branch) == 1


@pytest.mark.parametrize("model", list(MINIBATCH_MODELS) + ["ad"])
@pytest.mark.parametrize("d", [62, 512])
def test_cluster_blocks_keeps_minibatch_and_ad_on_one_block(model, d):
    """The slab transports and K5's scratch are placed for one block."""
    count = _block_bytes("logreg", 62, FusedBranch())
    assert cluster_blocks(model, d, N, FusedBranch(), count) == 1


BRANCHES = {
    "adam": FusedBranch(),
    "descent_prox": FusedBranch("descent", "stl_zero_grad", "repgrad", "prox"),
    "cocob": FusedBranch("cocob"),
    "cf_zero": FusedBranch("adam", "closed_form_zero_grad"),
}
# The fastest size of phase (m)'s route sweep (chip_smoke.py route_sweep, an
# H100) at each swept model and width, the same under every rule but one:
# mvnormal under COCOB ran 2-3% slower on two blocks than on one at d = 62.
SWEEP_BEST = {("logreg", 33): 2, ("logreg", 62): 2, ("logreg", 128): 4,
              **{(m, d): cs for m in ("mvnormal", "gaussian")
                 for d, cs in ((33, 1), (62, 2), (100, 4), (200, 4), (512, 16))}}


@pytest.mark.parametrize("model,d", list(SWEEP_BEST) + [("mvnormal", 11), ("gaussian", 11)])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_cluster_blocks_takes_a_block_a_panel(model, d, branch):
    """At every swept width the rule picks the sweep's fastest size: a
    block a whitening panel (the largest power of two up to 16 and the
    panels) from CLUSTER_MIN_D up, one block below it and below two panels,
    with a layout that fits."""
    br = BRANCHES[branch]
    cs = _rule(model, d, br)
    cocob_62 = (model, d, branch) == ("mvnormal", 62, "cocob")
    want = 1 if d < 32 or cocob_62 else SWEEP_BEST[(model, d)]
    assert cs == want
    if cs > 1:
        assert cs == min(16, 1 << ((-(-d // PANEL)).bit_length() - 1))
        assert _block_bytes(model, d, br)(cs) <= _build.SMEM_LIMIT


def test_cluster_blocks_halves_until_the_layout_fits():
    """A logreg whose design fills a block's shared memory gets a smaller
    cluster (every block holds the whole design, and the samples twice)."""
    branch = FusedBranch()
    big = 850  # 850 x 61 floats of design: the single-block layout fits, the cluster's not
    assert _block_bytes("logreg", 62, branch, big)(2) > _build.SMEM_LIMIT
    assert _rule("logreg", 62, branch, big) == 1
    assert _rule("logreg", 62, branch) == 2


def test_cluster_blocks_asks_the_layout_only_of_served_launches():
    """The rule asks the kernel's count only for a launch the cluster
    serves, and only of sizes it would take."""
    asked = []
    count = lambda cs: asked.append(cs) or 0  # noqa: E731
    assert cluster_blocks("ad", 512, N, FusedBranch(), count) == 1
    assert cluster_blocks("mvnormal", 11, N, FusedBranch(), count) == 1
    assert asked == []
    cluster_blocks("mvnormal", 512, N, FusedBranch(), count)
    assert set(asked) <= {2, 4, 8, 16}


@pytest.mark.parametrize("d", [11, 33, 62, 100, 512])
def test_panel_partition_covers_every_panel_once(d):
    """Each panel goes to exactly one block; the lower-triangle entries a
    block owns (row a holds a + 1) differ between blocks by at most two
    panels' bands (32 rows of at most d entries each: the last, partial
    fold), and not at all where the folded pairs fill every block (np a
    multiple of 2 cs, d a multiple of 32)."""
    panels = -(-d // PANEL)
    for cs in _allowed(d) or [1]:
        own = cluster_panels(d, cs)
        assert len(own) == cs
        assert sorted(p for ps in own for p in ps) == list(range(panels))
        assert all(panel_owner(p, cs) == r for r, ps in enumerate(own) for p in ps)
        entries = [sum(a + 1 for p in ps for a in range(PANEL * p, min(d, PANEL * p + PANEL)))
                   for ps in own]
        assert sum(entries) == d * (d + 1) // 2
        assert max(entries) - min(entries) <= 2 * PANEL * d
        if panels % (2 * cs) == 0 and d % PANEL == 0:
            assert len(set(entries)) == 1, (cs, entries)


def test_panel_partition_at_d512_pairs_the_folded_panels():
    """At d = 512 and 8 blocks, block r owns panels r and 15 - r: 16,416
    lower entries each."""
    own = cluster_panels(512, 8)
    assert own == tuple((r, 15 - r) for r in range(8))
    assert {sum(a + 1 for p in ps for a in range(32 * p, 32 * p + 32)) for ps in own} == {16416}


@pytest.mark.parametrize("key", [k for k in CLUSTER_LAYOUTS if k[0] != 850])
def test_cluster_layout_fits_at_the_rules_sizes(key):
    """The layout of every size the kernel takes at these widths fits a
    block's 232,448 bytes (the figures are the kernel's own)."""
    assert CLUSTER_LAYOUTS[key] <= 232_448 == _build.SMEM_LIMIT


def test_forced_cluster_refuses_a_layout_over_the_limit():
    with pytest.raises(ValueError, match="limit"):
        check_cluster("logreg", 62, N, FusedBranch(), 2,
                      _block_bytes("logreg", 62, FusedBranch(), 850))
    assert check_cluster("logreg", 62, N, FusedBranch(), 2,
                         _block_bytes("logreg", 62, FusedBranch())) == 2


def _case(model, d):
    if model == "logreg":
        prob = make_logreg(11, device="cpu")
        spec = logreg_spec(prob.X, prob.y)
    elif model == "mvnormal":
        g = torch.Generator().manual_seed(d)
        A = torch.randn(d, d, generator=g) / d ** 0.5 + 2.0 * torch.eye(d)
        spec = mvnormal_spec(torch.randn(d, generator=g), torch.linalg.cholesky(A @ A.T))
    else:
        g = torch.Generator().manual_seed(d)
        spec = gaussian_spec(torch.randn(d, generator=g), 0.5 + torch.rand(d, generator=g))
    d = spec.dim
    vec = torch.zeros(4, d)
    C0 = 0.1 * torch.eye(d)
    mat = torch.stack([C0, torch.zeros_like(C0), torch.zeros_like(C0), C0])
    return spec, vec, mat


@pytest.mark.parametrize("model,d,cluster,branch,match", [
    ("mvnormal", 100, 3, FusedBranch(), "one of"),
    ("mvnormal", 100, 32, FusedBranch(), "one of"),
    ("mvnormal", 100, 8, FusedBranch(), "panels"),
    ("logreg", 62, 4, FusedBranch(), "panels"),
    ("mvnormal", 11, 2, FusedBranch(), "panels"),
    ("mvnormal", 100, 2, FusedBranch("dowg", "stl_zero_grad", "repgrad", "prox"), "serve"),
    ("gaussian", 100, 2, FusedBranch("dog", "stl_zero_grad", "repgrad", "prox"), "serve"),
])
def test_forced_cluster_that_cannot_be_served_raises(model, d, cluster, branch, match):
    """The check runs before either device's path: no size is quietly
    replaced by another."""
    spec, vec, mat = _case(model, d)
    with pytest.raises(ValueError, match=match):
        fused_fullrank_run_chunk(spec.model, spec.consts, spec.scalars, vec, mat, (0, 0), 0, 2,
                                 N, FusedHyper(), branch=branch, cluster=cluster)


@pytest.mark.parametrize("model", list(MINIBATCH_MODELS) + ["ad"])
def test_forced_cluster_refuses_minibatch_and_ad(model):
    with pytest.raises(ValueError, match="serve"):
        check_cluster(model, 62, N, FusedBranch(), 2)


@pytest.mark.parametrize("model,d", [("logreg", 62), ("mvnormal", 100), ("gaussian", 100)])
def test_forced_cluster_runs_the_same_function_on_the_cpu(model, d):
    """On CPU tensors every size that passes the check runs the plain
    version: the cluster kernel computes the single-block function."""
    spec, vec, mat = _case(model, d)
    noise = torch.randn((3, N, spec.dim), generator=torch.Generator().manual_seed(1))
    args = (spec.model, spec.consts, spec.scalars, vec, mat, (0, 0), 0, 3, N, FusedHyper(),
            noise, 1)
    want = fused_fullrank_run_chunk(*args)
    for cs in [1] + _allowed(spec.dim):
        got = fused_fullrank_run_chunk(*args, cluster=cs)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
