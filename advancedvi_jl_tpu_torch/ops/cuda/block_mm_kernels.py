"""The block product of ``csrc/block_mm.cuh``, launched alone (``csrc/block_mm.cu``).

The product runs inside the fused kernels (the hand logreg body's logits and
gradient, the minibatch logreg body's, and every mm/mv node of K5's
generated body); this wrapper exists so the card tests can hold it against
``torch.mm`` at the fused kernels' shapes and at edge shapes, and check that
two launches give the same bits.
``CONFIGS`` are the tiles those callers emit: (rows, columns a thread, lanes
splitting k, A read as float4s); B is read by scalar loads in all.  The library is built
on first use (``_build.TEST_KERNELS``), not with the fused kernels.
"""

from __future__ import annotations

import ctypes

import torch

from advancedvi_jl_tpu_torch.ops.cuda import _build

CONFIGS = {
    0: (10, 1, 2, True),   # the hand logits (fused_common.cuh kLogit*, aligned betas)
    1: (10, 1, 8, True),   # the hand gradient (kGrad*, aligned weight rows)
    2: (10, 1, 2, False),  # the hand logits on the plain layout (no aligned copy)
    3: (10, 1, 8, False),  # the hand gradient on the plain layout
    4: (5, 2, 1, True),    # K5's flagship logits (ad_body._tile, rows of round4(d))
    5: (2, 2, 1, True),    # K5's flagship gradient
    6: (10, 4, 4, True),   # the minibatch logits (kMbLogit*, aligned betas, the slab's rows)
    7: (10, 2, 16, True),  # the minibatch gradient (kMbGrad*, the rows of p, the slab)
}


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def block_mm_reference(A: torch.Tensor, B: torch.Tensor, config: int = 0,
                       trans_b: bool = False) -> torch.Tensor:
    """The plain version: A (M, K) @ B (K, N) in float32."""
    return torch.mm(A, B)


def block_mm_cuda(A: torch.Tensor, B: torch.Tensor, config: int = 0,
                  trans_b: bool = False) -> torch.Tensor:
    """C = A (M, K) @ B (K, N) by block_mm in one block on the current
    stream, A laid out with rows of round4(K) floats for the configs that
    read it as float4s, B as (K, N) or, with ``trans_b``, as B^T (N, K).
    Adds one to ``block_mm_cuda.launches``."""
    if config not in CONFIGS:
        raise ValueError(f"config must be one of {sorted(CONFIGS)}, got {config}")
    if not (A.is_cuda and B.is_cuda):
        raise ValueError(f"block_mm_cuda needs CUDA tensors, got {A.device} and {B.device}")
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != B.shape[0]:
        raise ValueError(f"shapes {tuple(A.shape)} and {tuple(B.shape)} do not multiply")
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise ValueError("block_mm_cuda computes in float32")
    vec_a = CONFIGS[config][3]
    (M, K), N = A.shape, B.shape[1]
    lda = _round4(K) if vec_a else K
    Ap = torch.zeros(M, lda, dtype=torch.float32, device=A.device)
    Ap[:, :K] = A
    if trans_b:
        ldb, Bp = K, B.T.contiguous()
    else:
        ldb, Bp = N, B.contiguous()
    C = torch.empty(M, N, dtype=torch.float32, device=A.device)
    fn = _build.function("block_mm", "block_mm_run", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p])
    with torch.cuda.device(A.device):
        err = fn(Ap.data_ptr(), Bp.data_ptr(), C.data_ptr(), M, N, K, lda, ldb, int(trans_b),
                 config, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "block_mm launch")
    block_mm_cuda.launches += 1
    return C


block_mm_cuda.launches = 0


def mvnormal_product_cuda(A: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """A (M, d) @ P (d, d) by the dense-Gaussian body's product
    (csrc/mvnormal_product.cuh, the kMvn instances' ``mvnormal_stream_body``;
    csrc/block_mm.cu ``block_mm_mvnormal``) on the plan the mean-field
    kernel takes at n = M (``mvnormal_product_layout``): P staged in shared
    memory at tier 0, else streamed by rows through the TMA ring, P's rows
    padded to round4(d) floats once per tensor (``kernel_precision``).
    Adds one to ``mvnormal_product_cuda.launches``."""
    from advancedvi_jl_tpu_torch.ops.cuda.fused_advi import kernel_precision

    if not (A.is_cuda and P.is_cuda):
        raise ValueError(f"mvnormal_product_cuda needs CUDA tensors, got {A.device} and "
                         f"{P.device}")
    M, d = A.shape
    if tuple(P.shape) != (d, d) or A.dtype != torch.float32 or P.dtype != torch.float32:
        raise ValueError(f"expected float32 (M, d) and (d, d), got {tuple(A.shape)} and "
                         f"{tuple(P.shape)}")
    A, Pk = A.contiguous(), kernel_precision(P)
    C = torch.empty(M, d, dtype=torch.float32, device=A.device)
    fn = _build.function("block_mm", "block_mm_mvnormal", [ctypes.c_void_p] * 3
                         + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    err = _build.launch(fn, A.device, A.data_ptr(), Pk.data_ptr(), C.data_ptr(), M, d)
    _build.check(err, "block_mm_mvnormal launch")
    mvnormal_product_cuda.launches += 1
    return C


def mvnormal_product_layout(M: int, d: int) -> dict:
    """The plan ``mvnormal_product_cuda`` and the kMvn body run at n = M
    rows and width d (csrc/block_mm.cu ``block_mm_mvnormal_layout``): its
    tier (0: P staged in shared memory), rows a thread, rows a pass over P,
    P's rows a ring stage (0: staged) and shared bytes."""
    fn = _build.function("block_mm", "block_mm_mvnormal_layout", [ctypes.c_int] * 2
                         + [ctypes.c_void_p], restype=None)
    out = (ctypes.c_longlong * 5)()
    fn(M, d, ctypes.addressof(out))
    return dict(zip(("tier", "tile_rows", "pass_rows", "ring_rows", "smem_bytes"),
                    (int(v) for v in out)))


mvnormal_product_cuda.launches = 0


def block_mm(A: torch.Tensor, B: torch.Tensor, config: int = 0, trans_b: bool = False):
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if A.is_cuda:
        return block_mm_cuda(A, B, config, trans_b)
    if A.device.type == "cpu":
        return block_mm_reference(A, B, config, trans_b)
    raise ValueError(f"no block product for device {A.device}")
