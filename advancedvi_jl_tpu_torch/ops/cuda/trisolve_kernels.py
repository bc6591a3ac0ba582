"""Batched right division by a lower-triangular factor (CUDA).

Port of ops/pallas/trisolve_kernels.py (``_solve_raw``, ``solve_right``,
``vdiv_c``, ``vdiv_ct``).  Both modes solve a RIGHT division, batched over
the rows of V (n, d):

- ``mode="C"``:  W = V C^{-1}   (solves W C = V)   -- the STL entropy
  backward ``apply_inv_scale_T``;
- ``mode="CT"``: W = V C^{-T}   (solves W C^T = V) -- the log_prob
  whitening ``scale \\ (z - location)``.

Only the lower triangle of C is read.  The JAX kernel's d % 128 gate was a
TPU tile constraint: csrc/trisolve.cu takes any d.  The kernel inverts each
32 x 32 diagonal block of C once, into a scratch tensor that the wrapper
allocates, and then runs products panel by panel.  ``solve_right``
launches the kernel for CUDA tensors (float32 only: anything else raises)
and runs ``solve_right_reference``, its plain PyTorch version, for CPU
tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .location_scale_kernels import check_f32

MODES = ("C", "CT")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be 'C' or 'CT', got {mode!r}")


def solve_right_reference(C: torch.Tensor, V: torch.Tensor, mode: str = "C") -> torch.Tensor:
    """Plain version: W = V tril(C)^{-1} (mode "C") or V tril(C)^{-T} ("CT")."""
    _check_mode(mode)
    L = torch.tril(C)
    return torch.linalg.solve_triangular(L.T if mode == "CT" else L, V,
                                         upper=mode == "CT", left=False)


_SOLVE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
ROWS_PER_BLOCK = (1, 2, 4, 8)


def rows_per_block(n: int) -> int:
    """The rows of V a block of the kernel owns for n rows on the current
    card: the least of ROWS_PER_BLOCK whose blocks fit on the SMs at once."""
    return _build.function("trisolve", "trisolve_rows_per_block", [ctypes.c_int])(n)


def solve_right_cuda(C: torch.Tensor, V: torch.Tensor, mode: str = "C",
                     rows: int = 0) -> torch.Tensor:
    """Launch csrc/trisolve.cu on the current stream (same result as
    ``solve_right_reference``), ``rows`` rows of V a block (0: the card's
    choice, ``rows_per_block``).  Adds one to ``solve_right_cuda.launches``
    per call."""
    _check_mode(mode)
    if rows and rows not in ROWS_PER_BLOCK:
        raise ValueError(f"rows must be 0 or one of {ROWS_PER_BLOCK}, got {rows}")
    if not V.is_cuda:
        raise ValueError(f"solve_right_cuda needs CUDA tensors, got {V.device}")
    if V.ndim != 2:
        raise ValueError(f"V must be (n, d), got shape {tuple(V.shape)}")
    n, d = V.shape
    check_f32("C", C, (d, d), V.device)
    check_f32("V", V, (n, d), V.device)
    W = torch.empty_like(V)
    if n == 0 or d == 0:
        return W
    with torch.cuda.device(V.device):
        rows = rows or rows_per_block(n)
        smem = _build.function("trisolve", "trisolve_smem_bytes", [ctypes.c_int] * 2,
                               restype=ctypes.c_size_t)(d, rows)
        if smem > _build.SMEM_LIMIT:
            raise ValueError(
                f"the solve keeps {rows} rows of V and its C tiles in shared memory: "
                f"{smem} bytes for d={d} is over the {_build.SMEM_LIMIT}-byte limit "
                "of one block"
            )
        # the diagonal blocks' inverses, d/32 x 32 x 32
        M = torch.empty(-(-d // 32) * 1024, dtype=torch.float32, device=V.device)
        fn = _build.function("trisolve", "trisolve", _SOLVE_ARGTYPES)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(C.data_ptr(), V.data_ptr(), W.data_ptr(), M.data_ptr(), n, d,
                 int(mode == "CT"), rows, stream)
    _build.check(err, "trisolve launch")
    solve_right_cuda.launches += 1
    return W


solve_right_cuda.launches = 0


def solve_right(C: torch.Tensor, V: torch.Tensor, mode: str = "C") -> torch.Tensor:
    """W = V C^{-1} (mode "C") or V C^{-T} (mode "CT") for (n, d) V: the
    kernel for CUDA tensors, its plain version for CPU tensors.  Not
    differentiable (``vdiv_c``/``vdiv_ct`` are)."""
    if V.is_cuda:
        return solve_right_cuda(C, V, mode)
    if V.device.type == "cpu":
        return solve_right_reference(C, V, mode)
    raise ValueError(f"no triangular solve for device {V.device}")


# For W = V C^{-1}: ct_V = ct C^{-T} (the kernel in the other mode) and
# ct_C = -W^T ct_V.  For W = V C^{-T}: ct_V = ct C^{-1} and ct_C = -ct_V^T W.
# ct_C is dense; the family's tril projects it.


class _VDivC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, C, V):
        W = solve_right(C, V, "C")
        ctx.save_for_backward(C, W)
        return W

    @staticmethod
    def backward(ctx, ct):
        C, W = ctx.saved_tensors
        ct_V = solve_right(C, ct.contiguous(), "CT")
        return -W.T @ ct_V, ct_V


class _VDivCT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, C, V):
        W = solve_right(C, V, "CT")
        ctx.save_for_backward(C, W)
        return W

    @staticmethod
    def backward(ctx, ct):
        C, W = ctx.saved_tensors
        ct_V = solve_right(C, ct.contiguous(), "C")
        return -ct_V.T @ W, ct_V


def vdiv_c(C: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """W = V C^{-1} for lower-triangular C, batched over rows of V."""
    return _VDivC.apply(C, V)


def vdiv_ct(C: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """W = V C^{-T} for lower-triangular C, batched over rows of V."""
    return _VDivCT.apply(C, V)
