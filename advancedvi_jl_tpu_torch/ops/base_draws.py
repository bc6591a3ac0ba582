"""Base draws that the sampler kernels do not take: a Student-t or Laplace
base in any dtype, and the Normal base in float64 (the counterpart of each
base's ``sample``, JAX families/base.py:30, :60, :94, which draw with
``jax.random`` outside any Pallas kernel).

The draw of step ``it`` comes from one ``torch.Generator`` on the family's
device, seeded by a 64-bit word that Philox4x32-10 (``philox4x32_words``)
makes from the key's two seed words and ``it`` (stream "base" of the
counter).  So u is a function of (key, it, n, m, dtype, device) alone: a
chunked or resumed run draws the same bits as an uninterrupted one, and a
generator never carries state from one step to the next.  The CPU and CUDA generators give different streams.

Student-t is a normal over the square root of a chi-square over df, the
chi-square twice a ``torch._standard_gamma`` draw (which takes the generator
on both devices); Laplace is ``sign(v) log1p(-|v|)`` of a uniform v on
(-1, 1), as ``jax.random.laplace`` computes it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..families.base import Laplace, Normal, StudentT
from .cuda.location_scale_kernels import SeedLike, as_key, philox4x32_words

_MASK32 = 0xFFFFFFFF
# Counter word 3 of the base-draw seeds ("base"): no sampler kernel uses it.
_BASE_STREAM = 0x62617365


def generator(words: Sequence[int], device) -> torch.Generator:
    """A torch generator on ``device`` seeded by two 32-bit words, read as
    one 64-bit seed."""
    seed = ((int(words[0]) & _MASK32) << 32) | (int(words[1]) & _MASK32)
    return torch.Generator(device=device).manual_seed(seed)


def key_generator(key: SeedLike, device) -> torch.Generator:
    """The generator of ``key``'s step: seeded by the first two words of
    Philox4x32-10 at counter (it, it >> 32, 0, "base") under the seed words."""
    k = as_key(key)
    w = philox4x32_words((k.it & _MASK32, (k.it >> 32) & _MASK32, 0, _BASE_STREAM), k.seed)
    return generator(w[:2], device)


def draw(base, key: SeedLike, n: int, m: int, dtype: torch.dtype, device,
         rows=None) -> torch.Tensor:
    """(n, m) iid draws of ``base`` for ``key``, in ``dtype`` on ``device``;
    with ``rows=(row0, count)`` those rows of them.  A generator cannot start
    at a row, so a rank of a device mesh's "mc" axis draws the whole (n, m)
    block and keeps its rows (the sampler kernels draw only theirs)."""
    u = _draw(base, key, n, m, dtype, device)
    return u if rows is None else u.narrow(0, rows[0], rows[1])


def _draw(base, key: SeedLike, n: int, m: int, dtype: torch.dtype, device) -> torch.Tensor:
    g = key_generator(key, device)
    shape = (n, m)
    if isinstance(base, Normal):
        return torch.randn(shape, dtype=dtype, device=device, generator=g)
    if isinstance(base, StudentT):
        normal = torch.randn(shape, dtype=dtype, device=device, generator=g)
        half_df = torch.full(shape, base.df / 2.0, dtype=dtype, device=device)
        chi2 = 2.0 * torch._standard_gamma(half_df, generator=g)
        return normal * torch.rsqrt(chi2 / base.df)
    if isinstance(base, Laplace):
        epsneg = torch.finfo(dtype).eps / 2.0  # the gap below 1.0
        v = torch.empty(shape, dtype=dtype, device=device).uniform_(-1.0 + epsneg, 1.0,
                                                                    generator=g)
        return torch.sign(v) * torch.log1p(-torch.abs(v))
    raise TypeError(f"no base draw for {type(base).__name__}")
