"""Level-parallel blocked triangular inverse (port of ops/trinv.py).

    [[A, 0], [B, D]]^{-1} = [[A^{-1}, 0], [-D^{-1} B A^{-1}, D^{-1}]]

bottom up: one batched inversion of the d / 128 diagonal (128, 128) blocks
(``torch.linalg.solve_triangular`` against I), then log2(d / 128) levels in
which every pair's off-diagonal block is two batched products
(``torch.bmm``).  The JAX package computes this outside Pallas with XLA
solves and matmuls, so torch ops are its port.  Differentiable (solves and
products).  ``FullRankLocationScale(solve_mode="inverse")`` applies C^{-1}
and C^{-T} through it.
"""

from __future__ import annotations

import torch

_BASE = 128  # the JAX package's base-case block


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def supports_blocked_inverse(d: int, block: int = _BASE) -> bool:
    """Shape gate: d must tile into a power-of-two number of base blocks."""
    return d % block == 0 and _is_pow2(d // block)


def tril_inverse(C: torch.Tensor, block: int = _BASE) -> torch.Tensor:
    """Inverse of a lower-triangular (d, d) matrix, level-parallel; one
    triangular solve against I when the shape gate fails (as in the JAX
    package)."""
    d = C.shape[0]
    if not supports_blocked_inverse(d, block):
        return torch.linalg.solve_triangular(
            C, torch.eye(d, dtype=C.dtype, device=C.device), upper=False)

    nb = d // block
    idx = torch.arange(nb, device=C.device)
    diag_blocks = C.reshape(nb, block, nb, block)[idx, :, idx, :]  # (nb, block, block)
    eye = torch.eye(block, dtype=C.dtype, device=C.device).expand(nb, block, block)
    X = torch.linalg.solve_triangular(diag_blocks, eye, upper=False)

    # X holds the inverses of C's p diagonal (m, m) blocks; each level
    # merges consecutive pairs [[A, 0], [B, D]] -> [[Ai, 0], [-Di B Ai, Di]].
    m, p = block, nb
    while p > 1:
        p //= 2
        X = X.reshape(p, 2, m, m)
        Ai, Di = X[:, 0], X[:, 1]
        idx = torch.arange(p, device=C.device)
        B = C.reshape(p, 2 * m, p, 2 * m)[idx, m:, idx, :m]  # the sub-diagonal blocks
        O = -torch.bmm(Di, torch.bmm(B, Ai))
        X = torch.cat([torch.cat([Ai, torch.zeros_like(O)], dim=2),
                       torch.cat([O, Di], dim=2)], dim=1)
        m *= 2
    return X[0]
