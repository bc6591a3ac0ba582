"""Hygiene of the PyTorch port: it imports no JAX, builds nothing at import,
and its chip smoke script refuses to run without a card or outside a
checkout."""

import ast
import importlib
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import advancedvi_jl_tpu_torch
from advancedvi_jl_tpu_torch.ops.cuda import _build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "advancedvi_jl_tpu_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "advancedvi_jl_tpu")


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests/test_torch_kernels.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_package_exports_the_slice():
    for name in ("optimize", "KLMinRepGradDescent", "MeanFieldGaussian", "STL",
                 "ClipScale", "PolynomialAveraging", "adam", "dowg",
                 "FusedLogRegADVI", "DivergenceError", "FullRankGaussian",
                 "FullRankLocationScale", "mvnormal_spec", "FusedADVI",
                 "KLMinRepGradProxDescent", "KLMinScoreGradDescent", "BBVI",
                 "ScoreGradELBO", "descent", "dog", "cocob",
                 "ProximalLocationScaleEntropy", "CLOSED_FORM_ZERO_GRAD", "STL_ZERO_GRAD",
                 "FusedProxADVI", "FusedScoreGradVI", "gaussian_spec",
                 "normallognormal_spec", "subsample", "ReshufflingBatchSubsampling",
                 "SubsampledObjective", "FactorizedTarget", "factorized_target",
                 "logreg_minibatch_spec", "logreg_minibatch_hbm_spec", "make_bnn",
                 "subsampled_normals", "LowRankGaussian", "LowRankLocationScale",
                 "estimate_objective", "FusedChainsADVI", "FnTarget", "fn_target",
                 "CustomGradTarget", "ad_spec", "fused_spec_for",
                 "KLMinNaturalGradDescent", "KLMinSqrtNaturalGradDescent", "KLMinWassFwdBwd",
                 "FisherMinBatchMatch", "WithTermination", "elbo_at_least", "ExternalTarget",
                 "PathfinderResult", "pathfinder", "multipath_pathfinder",
                 "importance_diagnostics", "pareto_khat"):
        assert hasattr(advancedvi_jl_tpu_torch, name), name
    assert not _build._libs, "importing the package must not build or load kernels"


def test_kernel_sources_and_build_flags():
    for name in _build.KERNELS + _build.TEST_KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path("fused_advi_meanfield")
    assert path.parent == _build.BUILD_DIR and path.name.endswith(".so")
    with pytest.raises(ValueError, match="unknown kernel"):
        _build.build("nope")


def test_library_name_hashes_every_shared_header(monkeypatch, tmp_path):
    """Editing any csrc/*.cuh header (not only philox.cuh) must change the
    library's name, so a stale build is never loaded."""
    for name in ("k.cu", "philox.cuh", "shared.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k")
    assert _build.library_path("k") == before
    (tmp_path / "shared.cuh").write_text("// edited\n")
    edited = _build.library_path("k")
    assert edited != before
    (tmp_path / "new.cuh").write_text("// a new header\n")
    assert _build.library_path("k") != edited
    (tmp_path / "k.cu").write_text("// edited kernel\n")
    assert _build.library_path("k") not in (before, edited)


def test_generated_library_name_hashes_the_body(monkeypatch, tmp_path):
    """A K5 library's name covers the generated body as well as the kernel
    and its headers; only the fused kernels take a body, and asking for
    another raises before anything is written or built."""
    for name in ("fused_chains.cu", "fused_common.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "GEN_DIR", tmp_path / "gen")
    a = _build.generated_library_path("fused_chains", "// body a\n")
    assert a == _build.generated_library_path("fused_chains", "// body a\n")
    assert a != _build.generated_library_path("fused_chains", "// body b\n")
    assert a != _build.library_path("fused_chains") and "-ad-" in a.name
    assert _build.body_path("// body a\n").name.startswith("ad_")
    assert _build.body_path("// body a\n") != _build.body_path("// body b\n")
    (tmp_path / "fused_common.cuh").write_text("// edited\n")
    assert _build.generated_library_path("fused_chains", "// body a\n") != a
    with pytest.raises(ValueError, match="takes no generated body"):
        _build.build_generated("trisolve", "// body\n")
    assert not (tmp_path / "gen").exists()
    assert set(_build.AD_KERNELS) <= set(_build.KERNELS)


def test_library_name_hashes_the_defines(monkeypatch, tmp_path):
    """A library built with defines (the fused kernels' phase clocks) has a
    name of its own, which names the defines; with a generated K5 body too."""
    (tmp_path / "k.cu").write_text("// k\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    plain = _build.library_path("k")
    clocks = _build.library_path("k", ("AVI_PHASE_CLOCKS",))
    assert clocks != plain and "-avi_phase_clocks-" in clocks.name
    assert clocks == _build.library_path("k", ("AVI_PHASE_CLOCKS",))
    assert _build.library_path("k", ("OTHER",)) not in (plain, clocks)
    body = _build.generated_library_path("k", "// body\n")
    body_clocks = _build.generated_library_path("k", "// body\n", ("AVI_PHASE_CLOCKS",))
    assert body_clocks not in (body, plain, clocks) and "-ad-avi_phase_clocks-" in body_clocks.name
    assert not _build._libs


def test_trisolve_wrapper_checks_its_rows_before_the_device():
    """The rows a block of K8 are 0 (the card's choice) or 1, 2, 4, 8."""
    from advancedvi_jl_tpu_torch.ops.cuda.trisolve_kernels import ROWS_PER_BLOCK, solve_right_cuda

    assert ROWS_PER_BLOCK == (1, 2, 4, 8)
    C, V = torch.eye(4), torch.ones(2, 4)
    with pytest.raises(ValueError, match="rows must be"):
        solve_right_cuda(C, V, "C", 3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        solve_right_cuda(C, V, "CT", 2)


def test_fused_sources_keep_k5_under_its_macro():
    """Every line that K5 adds to the fused kernels sits under AVI_AD_BODY,
    so the libraries built without a body compile as before."""
    for name in ("fused_common.cuh", "fused_meanfield_body.cuh", "fused_advi_fullrank.cu",
                 "fused_advi_meanfield.cu", "fused_chains.cu"):
        depth, guarded = 0, []
        for line in (_build.CSRC / name).read_text().splitlines():
            if line.startswith("#if"):
                depth += 1
                guarded.append("AVI_AD_BODY" in line)
            elif line.startswith("#endif"):
                depth -= 1
                guarded.pop()
            elif line.lstrip().startswith("//"):
                continue
            elif "avi::ad::" in line or "kAD)" in line or "L.ad" in line:
                assert any(guarded), f"{name}: {line.strip()}"


def test_every_kernel_includes_only_known_headers():
    for name in _build.KERNELS + _build.TEST_KERNELS:
        for line in (_build.CSRC / f"{name}.cu").read_text().splitlines():
            if line.startswith('#include "'):
                assert (_build.CSRC / line.split('"')[1]).is_file(), line


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def _run_smoke(cwd: Path, script: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "FAILED" in proc.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    proc = _run_smoke(tmp_path, alone)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_port_modules_load_no_jax_and_build_nothing():
    """Importing every module of the port, the proximal and score-gradient
    slice's included, pulls in no JAX and builds or loads no kernel."""
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in PORT.rglob("*.py") if p.name != "__init__.py")
    assert "advancedvi_jl_tpu_torch.objectives.scoregradelbo" in mods
    assert "advancedvi_jl_tpu_torch.models.normallognormal" in mods
    for new in ("subsampling", "objectives.subsampled", "core.factorized", "models.bnn",
                "models.subsampled_normals", "ops.cuda.probe_kernels", "parallel.chains",
                "estimate", "families.low_rank", "ops.cuda.fused_chains", "ops.cuda.ad_body",
                "ops.sqrtm", "algorithms.gauss_expected", "algorithms.measure_space",
                "algorithms.termination", "algorithms.pathfinder", "core.external",
                "utils.diagnostics"):
        assert f"advancedvi_jl_tpu_torch.{new}" in mods, new
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from advancedvi_jl_tpu_torch.ops.cuda import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton')]\n"
        "assert not bad and not _build._libs, (bad, _build._libs)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module,name", [
    ("models.logreg", "make_logreg"), ("models.normallognormal", "make_normallognormal"),
    ("models.normal", "normal_fullrank"), ("models.normal", "normal_fullrank_wellcond"),
    ("models.normal", "normal_meanfield"), ("models.bnn", "make_bnn"),
    ("models.subsampled_normals", "subsampled_normals"), ("convert", "to_tensor"),
    ("convert", "logreg_from_numpy"), ("convert", "meanfield_from_numpy"),
    ("convert", "fullrank_from_numpy"), ("convert", "normal_target_from_numpy"),
    ("convert", "normallognormal_from_numpy"), ("convert", "fused_state_from_numpy"),
    ("convert", "bnn_from_numpy"), ("convert", "subsampled_normals_from_numpy"),
    ("convert", "reshuffling_state_from_numpy"), ("convert", "minibatch_spec_from_numpy"),
    ("subsampling", "ReshufflingBatchSubsampling.init"),
    ("subsampling", "ReshufflingBatchSubsampling.epoch_batches"),
    ("ops.cuda.probe_kernels", "run_probes"), ("convert", "lowrank_from_numpy"),
    ("convert", "chains_state_from_numpy"), ("convert", "measure_space_state_from_numpy"),
    ("convert", "pathfinder_from_numpy"), ("algorithms.pathfinder", "pathfinder"),
])
def test_constructors_default_to_the_card(module, name):
    """Every constructor that creates tensors puts them on the card unless
    the caller asks for the CPU."""
    obj = importlib.import_module(f"advancedvi_jl_tpu_torch.{module}")
    for part in name.split("."):
        obj = getattr(obj, part)
    assert inspect.signature(obj).parameters["device"].default == "cuda"


def test_default_device_is_not_the_cpu_without_a_card():
    """Without CUDA the default fails with torch's own error instead of
    quietly running on the CPU."""
    from advancedvi_jl_tpu_torch.models.logreg import make_logreg

    if torch.cuda.is_available():
        pytest.skip("the default only fails on a machine without CUDA")
    with pytest.raises((AssertionError, RuntimeError)):
        make_logreg(11, n_data=8, n_features=2)
    assert make_logreg(11, n_data=8, n_features=2, device="cpu").X.device.type == "cpu"
