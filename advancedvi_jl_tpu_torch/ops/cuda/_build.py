"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface under ``build/kernels/`` at
the root of the checkout.  The file name carries a hash of the flags, the
kernel's source and every shared header, so an edited source is rebuilt and
an unchanged one is reused.  The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside the library as ``<lib>.log``.

Nothing here runs when the package is imported: a wrapper calls ``function``
when it is first handed a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# No --use_fast_math: the normals must keep logf/cosf (csrc/philox.cuh).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# Dynamic shared memory one block may use on Hopper (227 KB); the wrappers
# refuse a launch above it before making it.
SMEM_LIMIT = 232448
KERNELS = ("meanfield_sample", "fused_advi_meanfield", "fullrank_sample", "trisolve",
           "fused_advi_fullrank", "probes", "fused_chains", "lowrank_sample")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are "
            "built from csrc/ with the CUDA toolkit"
        )
    return path


def library_path(name: str) -> Path:
    """The library's path: its name carries a hash of the flags, of
    ``<name>.cu`` and of every shared header ``csrc/*.cuh``, so editing any
    header a kernel may include rebuilds it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    return build_all([name])[name]


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Compile the named kernels that have no up-to-date library, one
    ``nvcc`` process per source, all started together; returns their paths."""
    for name in names:
        if name not in KERNELS:
            raise ValueError(f"unknown kernel {name!r}; known: {KERNELS}")
    paths = {name: library_path(name) for name in names}
    jobs = []
    for name, out in paths.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} ({proc.returncode}):\n{err}")
            continue
        out.with_suffix(".log").write_text(err)
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def function(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """The C entry ``symbol`` of kernel library ``name``, built and loaded on
    first use, with its argument types declared (pointers and the stream as
    ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    fn = _fns.get((name, symbol))
    if fn is None:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
