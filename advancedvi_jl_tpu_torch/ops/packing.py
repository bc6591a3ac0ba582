"""Tile-packed lower-triangular scale layout (port of ops/packing.py).

A packed scale is the (T, block, block) stack of the T = nb (nb + 1) / 2
tiles of the (zero-padded) (D, D) matrix, D = nb * block, that meet the
lower triangle, in row-major tile order: tile (i, j), j <= i, at index
i (i + 1) / 2 + j.  Diagonal tiles keep their upper-of-tile entries as
zeros.  This is the JAX package's layout, so a packed JAX parameter carries
over by ``np.asarray`` alone.  Every elementwise pass over the parameters
(optimizer moments, operators, averaging) then touches half the dense
scale; the dense factor is made only where a product or a solve reads it.

Pack is one ``index_select`` of the tile grid and unpack one out-of-place
``index_put`` into it; every tile index occurs once, so autograd carries
each gradient entry to one place (no scatter adds up duplicates).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

BLOCK = 128  # the JAX package's tile edge


def default_block(d: int) -> int:
    """The JAX package's tile edge for a width d: the smallest multiple of
    128 that keeps the tile count at most 36 (nb <= 8)."""
    return 128 * max(1, -(-d // (8 * 128)))


def _nb(d: int, block: int = BLOCK) -> int:
    return -(-d // block)


def n_tiles(d: int, block: Optional[int] = None) -> int:
    block = default_block(d) if block is None else block
    nb = _nb(d, block)
    return nb * (nb + 1) // 2


def packed_shape(d: int, block: Optional[int] = None) -> Tuple[int, int, int]:
    """Shape of the packed representation: (T, block, block)."""
    block = default_block(d) if block is None else block
    return (n_tiles(d, block), block, block)


class _Layout(NamedTuple):
    pos: torch.Tensor  # (T,) grid position i * nb + j of each packed tile
    diag: torch.Tensor  # (nb,) packed index of each diagonal tile
    mask: torch.Tensor  # (T, block, block) the JAX package's ``t * mask``
    ar: torch.Tensor  # (block,) 0 .. block - 1


def _make_layout(nb: int, block: int, device: torch.device, dtype: torch.dtype) -> _Layout:
    """The index tensors and tile mask, made on ``device`` (no host copy, so
    no wait for the card)."""
    i, j = torch.tril_indices(nb, nb, device=device)  # row-major over the lower triangle
    tri = torch.ones(block, block, dtype=dtype, device=device).tril()
    mask = torch.where((i == j)[:, None, None], tri, torch.ones_like(tri))
    k = torch.arange(nb, device=device)
    return _Layout(i * nb + j, k * (k + 1) // 2 + k, mask,
                   torch.arange(block, device=device))


_cached_layout = functools.lru_cache(maxsize=64)(_make_layout)


def _layout(nb: int, block: int, like: torch.Tensor) -> _Layout:
    """``_make_layout`` once a (nb, block, device, dtype), so a pack or an
    unpack is a gather or a scatter and one multiply.  Inside a CUDA graph
    capture the tensors are made anew: a captured kernel runs only at
    replay, so a tensor made there must not serve a later call."""
    args = (nb, block, like.device, like.dtype)
    if like.is_cuda and torch.cuda.is_current_stream_capturing():
        return _make_layout(*args)
    return _cached_layout(*args)


def tril_pack(dense: torch.Tensor, block: Optional[int] = None) -> torch.Tensor:
    """(d, d) dense -> (T, block, block) lower-triangle tiles.  Only the lower
    triangle of ``dense`` is read."""
    d = dense.shape[-1]
    block = default_block(d) if block is None else block
    nb = _nb(d, block)
    D = nb * block
    if D != d:
        dense = F.pad(dense, (0, D - d, 0, D - d))
    grid = dense.reshape(nb, block, nb, block).permute(0, 2, 1, 3).reshape(nb * nb, block, block)
    lay = _layout(nb, block, dense)
    return grid.index_select(0, lay.pos) * lay.mask


def tril_unpack(v: torch.Tensor, d: int, block: Optional[int] = None) -> torch.Tensor:
    """(T, block, block) tiles -> (d, d) dense lower-triangular matrix."""
    block = default_block(d) if block is None else block
    nb = _nb(d, block)
    D = nb * block
    lay = _layout(nb, block, v)
    grid = v.new_zeros(nb * nb, block, block).index_put((lay.pos,), v * lay.mask)
    dense = grid.reshape(nb, nb, block, block).permute(0, 2, 1, 3).reshape(D, D)
    return dense[:d, :d] if D != d else dense


def packed_diag(v: torch.Tensor, d: int, block: Optional[int] = None) -> torch.Tensor:
    """Diagonal of the packed triangle, (d,)."""
    block = default_block(d) if block is None else block
    tii = _layout(_nb(d, block), block, v).diag
    return torch.diagonal(v.index_select(0, tii), dim1=1, dim2=2).reshape(-1)[:d]


def packed_with_diag(v: torch.Tensor, d: int, new_diag: torch.Tensor,
                     block: Optional[int] = None) -> torch.Tensor:
    """Packed triangle with its diagonal replaced exactly by ``new_diag``."""
    block = default_block(d) if block is None else block
    nb = _nb(d, block)
    D = nb * block
    if D != d:
        new_diag = F.pad(new_diag, (0, D - d))
    lay = _layout(nb, block, v)
    vals = new_diag.reshape(nb, block).to(v.dtype)
    return v.index_put((lay.diag[:, None], lay.ar[None, :], lay.ar[None, :]), vals)
