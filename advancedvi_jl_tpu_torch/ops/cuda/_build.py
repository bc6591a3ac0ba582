"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface under ``build/kernels/`` at
the root of the checkout.  The file name carries a hash of the flags, the
kernel's source and every shared header, so an edited source is rebuilt and
an unchanged one is reused.  The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside the library as ``<lib>.log``.

The fused kernels (``AD_KERNELS``) also build with a generated model body,
K5 (ops/cuda/ad_body.py): ``build_generated`` writes the body to
``build/kernels/gen/ad_<hash>.cuh`` and compiles ``csrc/<name>.cu`` with
``-DAVI_AD_BODY=ad_<hash>.cuh`` into ``lib<name>-ad-<hash>.so``, the hash
covering the flags, the kernel's source, every shared header and the body.
A failed build raises; nothing runs the body's plain version in its place.

A kernel may also build with preprocessor ``defines`` (the fused kernels'
per-phase cycle counters, ``AVI_PHASE_CLOCKS``) into
``lib<name>-<define>-<hash>.so`` (``lib<name>-ad-<define>-<hash>.so`` with a
generated body), its hash covering the defines.

Nothing here runs when the package is imported: a wrapper calls ``function``
when it is first handed a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
GEN_DIR = BUILD_DIR / "gen"  # the generated K5 bodies
# No --use_fast_math: the normals must keep logf/cosf (csrc/philox.cuh).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# Dynamic shared memory one block may use on Hopper (227 KB); the wrappers
# refuse a launch above it before making it.
SMEM_LIMIT = 232448
KERNELS = ("meanfield_sample", "fused_advi_meanfield", "fullrank_sample", "trisolve",
           "fused_advi_fullrank", "probes", "fused_chains", "lowrank_sample", "fullrank_bf16")
# Launchers that only card tests call (csrc/block_mm.cu runs the fused
# kernels' block product alone): built on demand, never by ``build_all()``.
TEST_KERNELS = ("block_mm",)
AD_KERNELS = ("fused_advi_meanfield", "fused_advi_fullrank", "fused_chains")

_libs: Dict[Tuple[str, Optional[str]], ctypes.CDLL] = {}
_fns: Dict[Tuple[str, Optional[str], str], ctypes._CFuncPtr] = {}
# nvcc's wall seconds of each library built by this process
BUILD_SECONDS: Dict[Path, float] = {}


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


def _source_hash(name: str, body: Optional[str] = None, defines: Sequence[str] = ()) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    if body is not None:
        h.update(body.encode())
    return h.hexdigest()[:16]


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """The library's path: its name carries a hash of the flags and
    ``defines``, of ``<name>.cu`` and of every shared header ``csrc/*.cuh``,
    so editing any header a kernel may include rebuilds it."""
    tag = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{_source_hash(name, defines=defines)}.so"


def body_path(body: str) -> Path:
    """Where a generated K5 body is written: named by its own hash."""
    return GEN_DIR / f"ad_{hashlib.sha256(body.encode()).hexdigest()[:16]}.cuh"


def generated_library_path(name: str, body: str, defines: Sequence[str] = ()) -> Path:
    """The library of kernel ``name`` with the generated ``body`` (and
    ``defines``): its hash also covers the body."""
    tag = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}-ad{tag}-{_source_hash(name, body, defines)}.so"


def build(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``-D`` of each of ``defines``)
    unless an up-to-date library exists."""
    return build_all([name], defines)[name]


def _atomic_write(path: Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


Job = Tuple[str, Path, Tuple[str, ...]]  # (kernel, library, extra nvcc flags)


def compile_jobs(jobs: Sequence[Job]) -> None:
    """Run one ``nvcc`` per (name, library, extra flags) whose library does
    not exist yet, all started together; each library and its ``.log``
    appear atomically.  Raises on any failure.  Jobs from ``kernel_jobs``
    and ``generated_jobs`` may be mixed, so that every library a run needs
    compiles at once."""
    started, seen = [], set()
    for name, out, extra in jobs:
        if out.exists() or out in seen:
            continue
        seen.add(out)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        started.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in started:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {out.name} ({proc.returncode}):\n{err}")
            continue
        BUILD_SECONDS[out] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(err)
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all(names: Sequence[str] = KERNELS, defines: Sequence[str] = ()) -> Dict[str, Path]:
    """Compile the named kernels that have no up-to-date library, one
    ``nvcc`` process per source, all started together; returns their paths."""
    jobs = kernel_jobs(names, defines)
    compile_jobs(jobs)
    return {name: out for name, out, _ in jobs}


def kernel_jobs(names: Sequence[str] = KERNELS, defines: Sequence[str] = ()) -> List[Job]:
    """``compile_jobs``' job of each named kernel (with ``-D`` of each of
    ``defines``)."""
    for name in names:
        if name not in KERNELS + TEST_KERNELS:
            raise ValueError(f"unknown kernel {name!r}; known: {KERNELS + TEST_KERNELS}")
    flags = tuple(f"-D{d}" for d in defines)
    return [(name, library_path(name, defines), flags) for name in names]


def build_generated(name: str, body: str, defines: Sequence[str] = ()) -> Path:
    """Compile kernel ``name`` with the generated K5 ``body`` (and ``-D`` of
    each of ``defines``) unless an up-to-date library exists."""
    return build_generated_all([(name, body)], defines)[(name, body)]


def build_generated_all(pairs: Sequence[Tuple[str, str]],
                        defines: Sequence[str] = ()) -> Dict[Tuple[str, str], Path]:
    """``build_generated`` of every (kernel, body) pair, one ``nvcc`` each,
    all started together; returns their paths."""
    jobs = generated_jobs(pairs, defines)
    compile_jobs(jobs)
    return {pair: out for pair, (_, out, _) in zip(pairs, jobs)}


def generated_jobs(pairs: Sequence[Tuple[str, str]], defines: Sequence[str] = ()) -> List[Job]:
    """``compile_jobs``' job of every (kernel, body) pair, each body written
    to its header under GEN_DIR."""
    jobs = []
    for name, body in pairs:
        if name not in AD_KERNELS:
            raise ValueError(f"kernel {name!r} takes no generated body; those that do: "
                             f"{AD_KERNELS}")
        header = body_path(body)
        if not header.exists() or header.read_text() != body:
            _atomic_write(header, body)
        jobs.append((name, generated_library_path(name, body, defines),
                     ("-I", str(GEN_DIR), f"-DAVI_AD_BODY={header.name}",
                      *(f"-D{d}" for d in defines))))
    return jobs


def function(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int,
             body: Optional[str] = None, defines: Sequence[str] = ()):
    """The C entry ``symbol`` of kernel library ``name`` (with the generated
    K5 ``body``, or built with ``defines``, when given), built and loaded on
    first use, with its argument types declared (pointers and the stream as
    ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    key = " ".join((hashlib.sha256(body.encode()).hexdigest() if body is not None else "",
                    *defines)).strip() or None
    fn = _fns.get((name, key, symbol))
    if fn is None:
        lib = _libs.get((name, key))
        if lib is None:
            path = build(name, defines) if body is None else build_generated(name, body, defines)
            lib = _libs[(name, key)] = ctypes.CDLL(str(path))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[(name, key, symbol)] = fn
    return fn


def launch(fn, device, *args) -> int:
    """``fn(*args, stream)``: a C entry called with ``device``'s current
    stream, under a device context only when ``device`` is not the current
    device (a launch goes to the current device); returns its error."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch._C._cuda_getDevice():  # torch.cuda.current_device, less host work
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
