"""Hygiene of the PyTorch port: it imports no JAX, builds nothing at import,
and its chip smoke script refuses to run without a card or outside a
checkout."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

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
                 "FusedLogRegADVI", "DivergenceError"):
        assert hasattr(advancedvi_jl_tpu_torch, name), name
    assert not _build._libs, "importing the package must not build or load kernels"


def test_kernel_sources_and_build_flags():
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path("fused_advi_meanfield")
    assert path.parent == _build.BUILD_DIR and path.name.endswith(".so")
    with pytest.raises(ValueError, match="unknown kernel"):
        _build.build("nope")


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
