"""Step-indexed Philox normals and the fused samplers (CUDA).

Port of ops/pallas/location_scale_kernels.py (``_uniform01``,
``_box_muller``, ``_meanfield_sample_raw``, ``_fullrank_sample_raw`` and
the ``meanfield_sample``/``fullrank_sample`` custom VJPs).  Both samplers
draw the same u for the same (seed, iteration).  The TPU kernel drew its bits from the on-chip PRNG; here they
come from Philox4x32-10 (Salmon et al., SC'11), a counter-based generator
that is the same function on the card (csrc/philox.cuh) and in plain
PyTorch (``philox4x32_reference``):

- key = the two uint32 seed words;
- counter = (global iteration, sample row, lane group j // 4, stream);
  stream 0 gives the four u1 uniforms of a lane group, stream 1 the four u2
  (Box-Muller's two uniforms); the low-rank sampler's factor draws take
  streams 2 and 3.

So a draw depends on (seed, iteration, row, lane) only: never on the chunk,
the launch geometry or the device, which is the step-indexed contract of
the reference's fused engine (fused_advi.py:465-473).  Every sampler takes
a row offset ``row0``: a draw of n rows at ``row0`` is rows [row0, row0 + n)
of any larger draw, bit for bit, so each rank of a device mesh's "mc" axis
draws its own rows and nothing else (the port's counterpart of the
reference's ``jax_threefry_partitionable``).  Uniforms take the
top 23 bits by the mantissa trick and normals are
``sqrt(-2 log(u1 + 2^-24)) * cos(2 pi u2)``, the reference's Box-Muller.

Chain c of a multi-chain run draws under ``chain_seed_words(seed, c)``,
the counterpart of the reference's ``jax.random.split(key, n_chains)``.

Port of ``_lowrank_sample_raw`` and the ``lowrank_sample`` custom VJP (K7c)
too: its u1 is the mean-field draw of the same key, bit for bit.

Every wrapper takes the plain PyTorch version for a tensor on the CPU and
launches the kernel for a CUDA tensor; there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from . import _build

_MASK32 = 0xFFFFFFFF
_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
# float32 constants of the Box-Muller transform (exact in f32, so a python
# scalar and a CUDA ``float`` literal give the same products)
TWO_PI_F32 = 6.2831854820251465
TINY_F32 = 2.0 ** -24


class PhiloxKey(NamedTuple):
    """Seed words plus the counter's iteration word: the port's RNG key."""

    seed: Tuple[int, int]
    it: int = 0


SeedLike = Union[int, torch.Generator, Tuple[int, int], PhiloxKey]


def seed_words(seed: SeedLike) -> Tuple[int, int]:
    """Two uint32 seed words from an int, a ``torch.Generator``, a pair of
    words or a ``PhiloxKey`` (the counterpart of the reference's
    ``key_to_seed``)."""
    if isinstance(seed, PhiloxKey):
        return seed.seed
    if isinstance(seed, torch.Generator):
        w = torch.randint(0, 2**32, (2,), generator=seed, dtype=torch.int64)
        return int(w[0]), int(w[1])
    if isinstance(seed, (tuple, list)):
        if len(seed) != 2:
            raise ValueError(f"expected two seed words, got {seed!r}")
        return int(seed[0]) & _MASK32, int(seed[1]) & _MASK32
    seed = int(seed)
    return seed & _MASK32, (seed >> 32) & _MASK32


def as_key(key: SeedLike) -> PhiloxKey:
    if isinstance(key, PhiloxKey):
        return key
    return PhiloxKey(seed_words(key), 0)


# ---------------------------------------------------------------------------
# Plain PyTorch Philox (int64 tensors holding uint32 values)
# ---------------------------------------------------------------------------


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * b.  The product can
    reach 2^64 and overflow int64, so m is split into 16-bit halves: each
    partial product stays below 2^48."""
    t1 = b * (m & 0xFFFF)
    t2 = b * (m >> 16)
    s = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (s >> 32), s & _MASK32


def _key_word(k):
    if isinstance(k, torch.Tensor):
        return k.to(torch.int64) & _MASK32
    return int(k) & _MASK32


def philox4x32_reference(counter, key):
    """Philox4x32-10 of four counter words (int64 tensors or ints holding
    uint32 values, broadcast together) under a two-word key (ints, or int64
    tensors that broadcast against the counter: one key per batch entry);
    ints go to the device of the tensor words."""
    device = next((c.device for c in counter if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=device) for c in counter)
    )
    k0, k1 = _key_word(key[0]), _key_word(key[1])
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox4x32_words(counter, key) -> Tuple[int, int, int, int]:
    """``philox4x32_reference`` of one counter in Python ints: the same
    words without a tensor op, for the seeds a host makes each step."""
    c0, c1, c2, c3 = (int(c) & _MASK32 for c in counter)
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for _ in range(10):
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 & _MASK32, (p0 >> 32) ^ c3 ^ k1, p0 & _MASK32
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


# Counter word 3 of the chain keys ("chns"): no draw uses this stream.
_CHAIN_STREAM = 0x63686E73


def chain_seed_words(seed: SeedLike, c: int) -> Tuple[int, int]:
    """The seed words of chain ``c`` of a run keyed by ``seed``: the first two
    words of Philox4x32-10 at counter (c, 0, 0, "chns") under the run's
    words.  Distinct chains get distinct keys; the general chains path and
    the fused chains engine both draw chain c's normals under these words
    (the counterpart of ``jax.random.split(key, n_chains)[c]``, whose
    threefry bits the port cannot reproduce)."""
    w = philox4x32_words((c, 0, 0, _CHAIN_STREAM), seed_words(seed))
    return w[0], w[1]


# Counter word 3 of the sub-keys of one draw ("splt"): no draw uses this stream.
_SPLIT_STREAM = 0x73706C74


def split_seed_words(seed: SeedLike, i: int) -> Tuple[int, int]:
    """The seed words of part ``i`` of a draw keyed by ``seed``: the first
    two words of Philox4x32-10 at counter (i, 0, 0, "splt") under its words.
    A family made of parts (``GlobalLocalFamily``) draws part i under these
    words at the key's iteration, so no two parts share a stream (the
    counterpart of ``jax.random.split(key)``)."""
    w = philox4x32_words((i, 0, 0, _SPLIT_STREAM), seed_words(seed))
    return w[0], w[1]


def chain_seed_table(seed: SeedLike, n_chains: int) -> torch.Tensor:
    """``chain_seed_words(seed, c)`` of chains 0 .. n_chains - 1 as one
    (n_chains, 2) int64 CPU tensor, from one vectorised Philox call."""
    c = torch.arange(n_chains, dtype=torch.int64)
    w = philox4x32_reference((c, 0, 0, _CHAIN_STREAM), seed_words(seed))
    return torch.stack([w[0], w[1]], dim=1)


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) float32 from uint32 bits: (bits >> 9) | 0x3F800000 lies in
    [1, 2) as a float32."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(-2.0 * torch.log(u1 + TINY_F32)) * torch.cos(
        TWO_PI_F32 * u2
    )


def check_row0(row0: int, n: int) -> None:
    """Raise unless rows [row0, row0 + n) lie in the 32-bit counter word."""
    if not 0 <= row0 or row0 + n > _MASK32 + 1:
        raise ValueError(f"rows [{row0}, {row0 + n}) do not fit the 32-bit counter row")


def philox_normals_reference(
    seed, it: int, n: int, d: int, device=None, stream: int = 0, row0: int = 0
) -> torch.Tensor:
    """(n, d) standard normals of iteration ``it`` (an int, or an int64
    tensor of one element): element (i, j) comes from
    counters (it, row0 + i, j // 4, stream) and (it, row0 + i, j // 4,
    stream + 1) at position j % 4 of the output words.  ``seed``: two words,
    or a (C, 2) int64 tensor of C keys, which gives (C, n, d), one key a
    leading row."""
    check_row0(row0, n)
    groups = -(-d // 4)
    row = torch.arange(row0, row0 + n, dtype=torch.int64, device=device).view(n, 1)
    grp = torch.arange(groups, dtype=torch.int64, device=device).view(1, groups)
    c0 = torch.as_tensor(it & _MASK32, dtype=torch.int64, device=device)
    lead: Tuple[int, ...] = ()
    if isinstance(seed, torch.Tensor):
        lead = (seed.shape[0],)
        seed = (seed[:, 0].view(-1, 1, 1), seed[:, 1].view(-1, 1, 1))
    words1 = philox4x32_reference((c0, row, grp, stream), seed)
    words2 = philox4x32_reference((c0, row, grp, stream + 1), seed)
    bits1 = torch.stack(words1, dim=-1).reshape(*lead, n, 4 * groups)[..., :d]
    bits2 = torch.stack(words2, dim=-1).reshape(*lead, n, 4 * groups)[..., :d]
    return box_muller(uniform01(bits1), uniform01(bits2))


# ---------------------------------------------------------------------------
# K7a: the mean-field sampler
# ---------------------------------------------------------------------------


def _check_it_word(it_word: torch.Tensor, offset: int) -> None:
    """Raise unless ``it_word`` is an int64 tensor of one element and
    ``offset`` an iteration offset in [0, 2^32)."""
    if it_word.dtype != torch.int64 or it_word.numel() != 1:
        raise ValueError(f"it_word must be an int64 tensor of one element, got "
                         f"{it_word.dtype} {tuple(it_word.shape)}")
    if not 0 <= offset <= _MASK32:
        raise ValueError(f"with it_word, it is an offset in [0, 2^32), got {offset}")


def meanfield_sample_reference(
    seed: Tuple[int, int], it: int, location: torch.Tensor,
    scale_diag: torch.Tensor, n: int, it_word: Optional[torch.Tensor] = None,
    row0: int = 0,
):
    """Plain version of the kernel: z = u * sigma + m; returns (z, u), rows
    [row0, row0 + n) of the draw.  With ``it_word``, the draws are those of
    iteration ``it_word + it``."""
    if it_word is not None:
        _check_it_word(it_word, it)
        it = it_word.reshape(()) + it
    u = philox_normals_reference(
        seed, it, n, location.shape[0], device=location.device, row0=row0
    )
    return u * scale_diag + location, u


def check_f32(name: str, t: torch.Tensor, shape, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device`` (what a kernel's raw pointers assume)."""
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(
            f"{name} must be a contiguous float32 {tuple(shape)} tensor on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


_SAMPLE_ARGTYPES = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
       ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p]
)


def meanfield_sample_cuda(
    seed: Tuple[int, int], it: int, location: torch.Tensor,
    scale_diag: torch.Tensor, n: int, it_word: Optional[torch.Tensor] = None,
    row0: int = 0,
):
    """Launch csrc/meanfield_sample.cu on the current stream; returns (z, u),
    two views of one (2, n, d) buffer: rows [row0, row0 + n) of the draw.  With ``it_word`` (an int64 tensor of
    one element on the card), the kernel reads the iteration there: it
    draws iteration ``it_word + it``, ``it`` an offset, so that a CUDA graph
    of launches at offsets 0 .. K-1 draws K new iterations at each replay
    once the word is advanced by K.  Adds one to
    ``meanfield_sample_cuda.launches`` per launch."""
    if it_word is not None:
        _check_it_word(it_word, it)
        if not it_word.is_cuda:
            raise ValueError(f"it_word must be a CUDA tensor (the kernel reads it), got "
                             f"{it_word.device}")
    if not location.is_cuda:
        raise ValueError(f"meanfield_sample_cuda needs GPU tensors, got {location.device}")
    check_row0(row0, n)
    dev = location.device
    d = location.shape[0]
    check_f32("location", location, (d,), dev)
    check_f32("scale_diag", scale_diag, (d,), dev)
    if it_word is not None and it_word.device != dev:
        raise ValueError(f"it_word lies on {it_word.device}, location on {dev}")
    fn = meanfield_sample_cuda.fn
    if fn is None:
        fn = meanfield_sample_cuda.fn = _build.function(
            "meanfield_sample", "meanfield_sample", _SAMPLE_ARGTYPES)
    zu = torch.empty((2, n, d), dtype=torch.float32, device=dev)
    z, u = zu[0], zu[1]  # indexing: cheaper on the host than unbind
    if n == 0:
        return z, u
    err = _build.launch(
        fn, dev, location.data_ptr(), scale_diag.data_ptr(), z.data_ptr(), u.data_ptr(), n, d,
        seed[0], seed[1], it & _MASK32, row0, None if it_word is None else it_word.data_ptr())
    _build.check(err, "meanfield_sample launch")
    meanfield_sample_cuda.launches += 1
    return z, u


meanfield_sample_cuda.launches = 0
meanfield_sample_cuda.fn = None  # the C entry, fetched (and built) at the first launch


def meanfield_sample_raw(seed, it, location, scale_diag, n, it_word=None, row0=0):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if location.is_cuda:
        return meanfield_sample_cuda(seed, it, location, scale_diag, n, it_word, row0)
    if location.device.type == "cpu":
        return meanfield_sample_reference(seed, it, location, scale_diag, n, it_word, row0)
    raise ValueError(f"no sampler for device {location.device}")


class _MeanFieldSample(torch.autograd.Function):
    """z = u * sigma + m with dz/dm = 1 and dz/dsigma = u (the reference's
    ``_mf_bwd``: the backward is two reductions, outside the kernel)."""

    @staticmethod
    def forward(ctx, location, scale_diag, seed, it, n, row0):
        z, u = meanfield_sample_raw(seed, it, location, scale_diag, n, row0=row0)
        ctx.save_for_backward(u)
        ctx.mark_non_differentiable(u)
        return z, u

    @staticmethod
    def backward(ctx, ct_z, ct_u):
        (u,) = ctx.saved_tensors
        return ct_z.sum(dim=0), (ct_z * u).sum(dim=0), None, None, None, None


def meanfield_sample(
    seed: Tuple[int, int], it: int, location: torch.Tensor,
    scale_diag: torch.Tensor, n: int, row0: int = 0,
):
    """Fused z = u * sigma + m; returns (z, u), rows [row0, row0 + n) of the
    draw, differentiable in (m, sigma)."""
    return _MeanFieldSample.apply(location, scale_diag, tuple(seed), int(it), int(n),
                                  int(row0))


# ---------------------------------------------------------------------------
# K7b: the full-rank sampler
# ---------------------------------------------------------------------------


def col_span(d: int, cols) -> Tuple[int, int]:
    """(col0, ncols) of ``cols``, or all d output columns for None."""
    if cols is None:
        return 0, d
    col0, ncols = int(cols[0]), int(cols[1])
    if col0 < 0 or ncols < 0 or col0 + ncols > d:
        raise ValueError(f"columns [{col0}, {col0 + ncols}) are not columns of a width-{d} draw")
    return col0, ncols


def fullrank_affine_reference(
    u: torch.Tensor, location: torch.Tensor, scale: torch.Tensor, cols=None,
) -> torch.Tensor:
    """z = u tril(C)^T + m for given draws u (the product of the kernel's
    second launch); only the lower triangle of ``scale`` is used.  ``cols=
    (col0, ncols)``: those columns of z alone, from C's rows col0 .. (and
    u's columns below col0 + ncols)."""
    if cols is None:
        return u @ torch.tril(scale).T + location
    col0, ncols = col_span(location.shape[0], cols)
    end = col0 + ncols
    rows = torch.tril(scale[col0:end, :end], diagonal=col0)
    return u[:, :end] @ rows.T + location[col0:end]


def fullrank_sample_reference(
    seed: Tuple[int, int], it: int, location: torch.Tensor,
    scale: torch.Tensor, n: int, row0: int = 0, cols=None,
):
    """Plain version of the kernel: z = u tril(C)^T + m; returns (z, u),
    rows [row0, row0 + n) of the draw (``cols``: those columns of z).  u is
    the mean-field sampler's draw for the same (seed, it)."""
    u = philox_normals_reference(
        seed, it, n, location.shape[0], device=location.device, row0=row0
    )
    return fullrank_affine_reference(u, location, scale, cols), u


# csrc/fullrank_sample.cu's product: 64 x 64 output tiles, summed over k in
# steps of 32 (two a column tile of C); a block takes at least FR_MIN_STEPS
# steps, so a small shape runs on fewer blocks than the card has SMs.
FR_TILE = 64
FR_STEP = 32
FR_MIN_STEPS = 4


class FullRankPlan(NamedTuple):
    """How the product's work is cut over the blocks (stream-K).  Every
    (tile, step) of the triangle, tiles in order of column tile then row
    tile, is laid end to end; block b takes steps [b W / B, (b + 1) W / B)
    of the W in all.  Its range is one or more segments, each a piece of
    one tile: (row0, col0, step0, step1, tile, piece, pieces, slot).  A tile
    cut into several pieces keeps each piece's partial sum in workspace slot
    ``slot + piece``; the last to arrive adds them in piece order."""

    blocks: int
    tiles: int   # output tiles, one counter each
    slots: int   # 64 x 64 partial sums in the workspace
    table: torch.Tensor  # int32: block offsets (padded to 4 words), then segments


def fullrank_plan(n: int, d: int, sms: int, col0: int = 0,
                  ncols: Optional[int] = None, tile_cost: int = 0) -> FullRankPlan:
    """The product's cut of (n, d) over at most ``sms`` blocks (the card's
    SMs: one block an SM).  ``col0, ncols``: the output columns [col0, col0
    + ncols) alone (C's rows there; the whole product for ncols None): a
    segment's col0 is C's row, and column tile j sums k below the range's
    end or its own, whichever comes first.  The whole product's table does
    not depend on the range arguments.  ``tile_cost``: steps' worth of work
    that each tile's epilogue costs, laid before its first step so that the
    cut balances it too and counts it in the block of the tile's first
    piece, which adds a cut tile's pieces (a block whose range holds none of
    a tile's steps takes no piece of it)."""
    ncols = d - col0 if ncols is None else ncols
    end = col0 + ncols
    row_tiles, col_tiles = -(-n // FR_TILE), -(-ncols // FR_TILE)
    # column tile j sums k < min(end, col0 + 64 (j + 1)): C's row c stops at k = c
    tile_steps = [-(-min(end, col0 + FR_TILE * (j + 1)) // FR_STEP) for j in range(col_tiles)]
    total = row_tiles * (sum(tile_steps) + col_tiles * tile_cost)
    blocks = max(1, min(sms, total // FR_MIN_STEPS))
    starts = [b * total // blocks for b in range(blocks + 1)]
    per_block = [[] for _ in range(blocks)]
    at = slots = 0
    b = 0
    for j in range(col_tiles):
        for i in range(row_tiles):
            tile = j * row_tiles + i
            at += tile_cost  # the epilogue's cost, in the block of the tile's first piece
            end_at = at + tile_steps[j]
            while starts[b + 1] <= at:
                b += 1
            last = b
            while starts[last + 1] < end_at:
                last += 1
            pieces = last - b + 1
            for q in range(pieces):
                lo, hi = max(starts[b + q], at), min(starts[b + q + 1], end_at)
                per_block[b + q].append(
                    (FR_TILE * i, col0 + FR_TILE * j, lo - at, hi - at, tile, q, pieces,
                     slots if pieces > 1 else 0))
            slots += pieces if pieces > 1 else 0
            at = end_at
    head = (blocks + 4) & ~3  # the offsets, padded so each segment is 16-byte aligned
    offsets, count = [], 0
    for segs in per_block:
        offsets.append(count)
        count += len(segs)
    offsets.append(count)
    words = offsets + [0] * (head - blocks - 1) + [w for segs in per_block for s in segs
                                                   for w in s]
    return FullRankPlan(blocks, row_tiles * col_tiles, slots,
                        torch.tensor(words, dtype=torch.int32))


class CardPlan(NamedTuple):
    """A plan with its table on the card; for the bf16 product also its
    workspace: ``slots`` 64 x 64 partial sums and a flag each, the flags
    zero when made and left so by every launch (the piece that adds a
    tile's partial sums clears their flags), so no launch needs a memset.
    Launches of one plan on one stream share them."""

    plan: FullRankPlan
    table: torch.Tensor
    work: Optional[torch.Tensor]
    flags: Optional[torch.Tensor]


_FR_PLANS = {}  # (n, d, col0, ncols, device index, bf16) -> CardPlan
_FR_ARGTYPES = (
    [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 4 + [ctypes.c_uint32] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)


def _card_plan(n: int, d: int, device: torch.device, col0: int = 0, ncols: Optional[int] = None,
               bf16: bool = False) -> CardPlan:
    """K7b's plan of the product's columns [col0, col0 + ncols) on
    ``device``, or with ``bf16`` the bf16 product's (BF16_TILE_COST) with
    its workspace; made once a key."""
    ncols = d if ncols is None else ncols
    key = (n, d, col0, ncols, device.index, bf16)
    hit = _FR_PLANS.get(key)
    if hit is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = fullrank_plan(n, d, sms, col0, ncols, BF16_TILE_COST if bf16 else 0)
        table = plan.table.to(device)  # read by the bf16 product before its launch's wait
        work = flags = None
        if bf16:
            slots = max(plan.slots, 1)
            work = torch.empty(slots * FR_TILE * FR_TILE, dtype=torch.float32, device=device)
            flags = torch.zeros(slots, dtype=torch.int32, device=device)
        hit = _FR_PLANS[key] = CardPlan(plan, table, work, flags)
    return hit


def fullrank_sample_cuda(
    seed: Tuple[int, int], it: int, location: torch.Tensor,
    scale: torch.Tensor, n: int, row0: int = 0, cols=None, product: bool = True,
):
    """Launch csrc/fullrank_sample.cu on the current stream (the draws, then
    the product); returns (z, u), rows [row0, row0 + n) of the draw.  Only
    the lower triangle of ``scale`` is read.  ``cols=(col0, ncols)``: z is
    (n, ncols), those columns of the product alone (the draws stay whole).
    ``product=False`` launches the draws alone and returns (None, u) (the
    bfloat16 product's route).  Adds one to ``fullrank_sample_cuda.launches``
    per call."""
    if not location.is_cuda:
        raise ValueError(f"fullrank_sample_cuda needs GPU tensors, got {location.device}")
    check_row0(row0, n)
    dev = location.device
    d = location.shape[0]
    col0, ncols = col_span(d, cols)
    check_f32("location", location, (d,), dev)
    if product:
        check_f32("scale", scale, (d, d), dev)
    fn = _build.function("fullrank_sample", "fullrank_sample", _FR_ARGTYPES)
    z = torch.empty((n, ncols), dtype=torch.float32, device=dev) if product else None
    u = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0:
        return z, u
    tiles = slots = blocks = 0
    table = work = None
    if product and ncols:
        plan, table, _, _ = _card_plan(n, d, dev, col0, ncols)
        tiles, slots, blocks = plan.tiles, plan.slots, plan.blocks
        # the partial sums, then one int32 counter a tile
        work = torch.empty(slots * FR_TILE * FR_TILE + tiles, dtype=torch.float32, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            location.data_ptr(), ptr(scale if product else None), ptr(z), u.data_ptr(),
            ptr(work), None if work is None else work.data_ptr() + 4 * slots * FR_TILE * FR_TILE,
            ptr(table), blocks, tiles, n, d, seed[0], seed[1], it & _MASK32, row0, col0, ncols,
            int(product and ncols > 0), stream,
        )
    _build.check(err, "fullrank_sample launch")
    fullrank_sample_cuda.launches += 1
    return z, u


fullrank_sample_cuda.launches = 0


def fullrank_sample_raw(seed, it, location, scale, n, row0=0, cols=None):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if location.is_cuda:
        return fullrank_sample_cuda(seed, it, location, scale, n, row0, cols)
    if location.device.type == "cpu":
        return fullrank_sample_reference(seed, it, location, scale, n, row0, cols)
    raise ValueError(f"no sampler for device {location.device}")


def fullrank_draw(seed, it, location: torch.Tensor, n: int, row0: int = 0) -> torch.Tensor:
    """u alone, rows [row0, row0 + n) of the (n, d) draw: K7b's draw launch
    for a CUDA tensor, its plain version for a CPU one."""
    if location.is_cuda:
        return fullrank_sample_cuda(seed, it, location, None, n, row0, product=False)[1]
    if location.device.type == "cpu":
        return philox_normals_reference(seed, it, n, location.shape[0], device=location.device,
                                        row0=row0)
    raise ValueError(f"no sampler for device {location.device}")


def _tril_rows_grad(ct_z: torch.Tensor, u: torch.Tensor, d: int, cols) -> torch.Tensor:
    """tril(ct_z^T u) restricted to C's rows ``cols`` (the rest zero)."""
    if cols is None:
        return torch.tril(ct_z.T @ u)
    col0, ncols = cols
    end = col0 + ncols
    dC = ct_z.new_zeros((d, d))
    dC[col0:end, :end] = torch.tril(ct_z.T @ u[:, :end], diagonal=col0)
    return dC


def _cols_grad(ct_z: torch.Tensor, d: int, cols) -> torch.Tensor:
    """sum of ct_z over the rows, placed at columns ``cols`` of a (d,) zero."""
    if cols is None:
        return ct_z.sum(dim=0)
    dm = ct_z.new_zeros(d)
    dm[cols[0]:cols[0] + cols[1]] = ct_z.sum(dim=0)
    return dm


class _FullRankSample(torch.autograd.Function):
    """z = u C^T + m with dm = sum ct_z and dC = tril(ct_z^T u) (the
    reference's ``_fr_bwd``; the product runs outside the kernel).  With a
    column range only C's rows and m's entries in the range get a
    gradient."""

    @staticmethod
    def forward(ctx, location, scale, seed, it, n, row0, cols):
        z, u = fullrank_sample_raw(seed, it, location, scale, n, row0, cols)
        ctx.save_for_backward(u)
        ctx.mark_non_differentiable(u)
        ctx.cols = cols
        return z, u

    @staticmethod
    def backward(ctx, ct_z, ct_u):
        (u,) = ctx.saved_tensors
        d = u.shape[1]
        return (_cols_grad(ct_z, d, ctx.cols), _tril_rows_grad(ct_z, u, d, ctx.cols),
                None, None, None, None, None)


def fullrank_sample(
    seed: Tuple[int, int], it: int, location: torch.Tensor,
    scale: torch.Tensor, n: int, row0: int = 0, cols=None,
):
    """Fused z = u tril(C)^T + m; returns (z, u), rows [row0, row0 + n) of
    the draw (``cols=(col0, ncols)``: those columns of z alone),
    differentiable in (m, C)."""
    if cols is not None:
        cols = col_span(location.shape[0], cols)
    return _FullRankSample.apply(location, scale, tuple(seed), int(it), int(n), int(row0), cols)


# ---------------------------------------------------------------------------
# The bfloat16 sampling product (compute_dtype="bfloat16")
# ---------------------------------------------------------------------------


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even) and back to its dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def fullrank_bf16_reference(u: torch.Tensor, location: torch.Tensor, scale: torch.Tensor,
                            cols=None) -> torch.Tensor:
    """Plain version of csrc/fullrank_bf16.cu: z = bf16(u) bf16(tril C)^T +
    m, the products and sums in the parameters' dtype (a product of two
    bf16 values is exact in float32).  ``cols``: those columns of z."""
    return fullrank_affine_reference(bf16_round(u), location, bf16_round(scale), cols)


_BF16_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BF16_F64_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
BF16_ROUTES = ("tma", "loads")
# steps' worth of work a tile's epilogue costs the bf16 product's plan
BF16_TILE_COST = 2


def bf16_route(n: int, d: int, aligned: bool) -> Optional[str]:
    """How csrc/fullrank_bf16.cu stages a float32 product of n draws at width
    d, chosen by shape before the launch: "tma" (2-D tensor copies) where a
    row of d floats is a whole number of 16-byte units and u and C start on
    16 bytes (``aligned``), else "loads" (each warpgroup loads its own
    steps from device memory); None where there is nothing to launch
    (n = 0)."""
    if n == 0:
        return None
    return "tma" if d % 4 == 0 and aligned else "loads"


def fullrank_bf16_cuda(u: torch.Tensor, location: torch.Tensor, scale: torch.Tensor,
                       cols=None) -> torch.Tensor:
    """Launch csrc/fullrank_bf16.cu on the current stream: z (n, ncols), the
    bfloat16 product's columns ``cols`` (all d for None) for given draws u
    (n, d); float32 parameters on the tensor cores (wgmma over
    ``fullrank_plan``'s stream-K cut with BF16_TILE_COST, staged by
    ``bf16_route``'s route), float64 ones summed in double.  Only the lower
    triangle of ``scale`` is read.  Adds one to ``fullrank_bf16_cuda.launches``
    per launch, and a float32 launch to
    ``fullrank_bf16_cuda.route_launches[route]``."""
    if not location.is_cuda:
        raise ValueError(f"fullrank_bf16_cuda needs GPU tensors, got {location.device}")
    dev, dtype = location.device, location.dtype
    n, d = u.shape[0], location.shape[0]
    col0, ncols = col_span(d, cols)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the bfloat16 product takes float32 or float64 parameters, got {dtype}")
    for name, t, shape in (("u", u, (n, d)), ("location", location, (d,)),
                           ("scale", scale, (d, d))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if dtype == torch.float64 and n > 65535:
        raise ValueError(f"the float64 product takes at most 65,535 rows, got {n}")
    z = torch.empty((n, ncols), dtype=dtype, device=dev)
    if n == 0 or ncols == 0:
        return z
    if dtype == torch.float64:
        fn = _build.function("fullrank_bf16", "fullrank_bf16_f64", _BF16_F64_ARGTYPES)
        err = _build.launch(fn, dev, u.data_ptr(), scale.data_ptr(), location.data_ptr(),
                            z.data_ptr(), n, d, col0, ncols)
        _build.check(err, "fullrank_bf16 launch")
        fullrank_bf16_cuda.launches += 1
        return z
    fn = _build.function("fullrank_bf16", "fullrank_bf16", _BF16_ARGTYPES)
    route = bf16_route(n, d, u.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0)
    plan, table, work, flags = _card_plan(n, d, dev, col0, ncols, bf16=True)
    err = _build.launch(fn, dev, u.data_ptr(), scale.data_ptr(), location.data_ptr(),
                        z.data_ptr(), work.data_ptr(), flags.data_ptr(), table.data_ptr(),
                        plan.blocks, n, d, col0, ncols, int(route == "tma"))
    _build.check(err, "fullrank_bf16 launch")
    fullrank_bf16_cuda.launches += 1
    fullrank_bf16_cuda.route_launches[route] += 1
    return z


fullrank_bf16_cuda.launches = 0
fullrank_bf16_cuda.route_launches = dict.fromkeys(BF16_ROUTES, 0)


def fullrank_bf16_raw(u, location, scale, cols=None):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if location.is_cuda:
        return fullrank_bf16_cuda(u, location, scale, cols)
    if location.device.type == "cpu":
        return fullrank_bf16_reference(u, location, scale, cols)
    raise ValueError(f"no bfloat16 product for device {location.device}")


class _FullRankBf16(torch.autograd.Function):
    """z = bf16(u) bf16(C)^T + m with the JAX package's gradient of its
    mixed-precision matmul (``jnp.matmul(u.astype(bf16), C.T.astype(bf16),
    preferred_element_type=f32)``): the transpose of a bf16 operand is a
    product in the parameters' dtype rounded to bf16, so dC = tril(bf16(ct_z^T
    bf16(u))) and du = bf16(ct_z bf16(tril C)); dm = sum ct_z unrounded.
    With a column range only the range's rows of C and entries of m."""

    @staticmethod
    def forward(ctx, u, location, scale, cols):
        z = fullrank_bf16_raw(u, location, scale, cols)
        ctx.save_for_backward(u, scale)
        ctx.cols = cols
        return z

    @staticmethod
    def backward(ctx, ct_z):
        u, scale = ctx.saved_tensors
        d, cols = u.shape[1], ctx.cols
        du = dC = None
        if ctx.needs_input_grad[0]:
            col0, ncols = col_span(d, cols)
            end = col0 + ncols
            rows = torch.tril(bf16_round(scale[col0:end, :end]), diagonal=col0)
            du = u.new_zeros(u.shape)
            du[:, :end] = bf16_round(ct_z @ rows)
        if ctx.needs_input_grad[2]:
            dC = bf16_round(_tril_rows_grad(ct_z, bf16_round(u), d, cols))
        return du, _cols_grad(ct_z, d, cols), dC, None


def fullrank_bf16(u: torch.Tensor, location: torch.Tensor, scale: torch.Tensor, cols=None):
    """The bfloat16 sampling product z = bf16(u) bf16(tril C)^T + m
    (``cols``: those columns), differentiable in (u, m, C) with the JAX
    package's rounding points."""
    if cols is not None:
        cols = col_span(location.shape[0], cols)
    return _FullRankBf16.apply(u, location, scale, cols)


# ---------------------------------------------------------------------------
# K7c: the low-rank sampler
# ---------------------------------------------------------------------------

# Philox streams of the low-rank factor draws u2 (u1 takes streams 0 and 1)
LOWRANK_FACTOR_STREAM = 2


def lowrank_sample_reference(
    seed: Tuple[int, int], it: int, location: torch.Tensor,
    scale_diag: torch.Tensor, scale_factors: torch.Tensor, n: int, row0: int = 0,
):
    """Plain version of the kernel: z = u1 * D + u2 U^T + m; returns (z, u1,
    u2), rows [row0, row0 + n) of the draw.  u1 is the mean-field sampler's
    draw for the same (seed, it); u2 (n, r) comes from counters (it, row,
    k // 4, 2) and (..., 3)."""
    d, r = scale_factors.shape
    dev = location.device
    u1 = philox_normals_reference(seed, it, n, d, device=dev, row0=row0)
    u2 = philox_normals_reference(seed, it, n, r, device=dev, stream=LOWRANK_FACTOR_STREAM,
                                  row0=row0)
    return u1 * scale_diag + u2 @ scale_factors.T + location, u1, u2


_LOWRANK_ARGTYPES = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 3 + [ctypes.c_uint32] * 4 + [ctypes.c_void_p]
)


def lowrank_sample_cuda(
    seed: Tuple[int, int], it: int, location: torch.Tensor,
    scale_diag: torch.Tensor, scale_factors: torch.Tensor, n: int, row0: int = 0,
):
    """Launch csrc/lowrank_sample.cu on the current stream; returns (z, u1,
    u2), rows [row0, row0 + n) of the draw.  Adds one to
    ``lowrank_sample_cuda.launches`` per launch."""
    if not location.is_cuda:
        raise ValueError(f"lowrank_sample_cuda needs GPU tensors, got {location.device}")
    check_row0(row0, n)
    dev = location.device
    d = location.shape[0]
    r = scale_factors.shape[1] if scale_factors.ndim == 2 else -1
    check_f32("location", location, (d,), dev)
    check_f32("scale_diag", scale_diag, (d,), dev)
    check_f32("scale_factors", scale_factors, (d, r), dev)
    smem = _build.function("lowrank_sample", "lowrank_sample_smem_bytes", [ctypes.c_int],
                           restype=ctypes.c_size_t)(r)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"the low-rank sampler keeps a 128-lane slice of the factors in shared "
            f"memory: {smem} bytes at rank {r} is over the {_build.SMEM_LIMIT}-byte "
            "limit of one block"
        )
    fn = _build.function("lowrank_sample", "lowrank_sample", _LOWRANK_ARGTYPES)
    z = torch.empty((n, d), dtype=torch.float32, device=dev)
    u1 = torch.empty((n, d), dtype=torch.float32, device=dev)
    u2 = torch.empty((n, r), dtype=torch.float32, device=dev)
    if n == 0:
        return z, u1, u2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(location.data_ptr(), scale_diag.data_ptr(), scale_factors.data_ptr(),
                 z.data_ptr(), u1.data_ptr(), u2.data_ptr(), n, d, r,
                 seed[0], seed[1], it & _MASK32, row0, stream)
    _build.check(err, "lowrank_sample launch")
    lowrank_sample_cuda.launches += 1
    return z, u1, u2


lowrank_sample_cuda.launches = 0


def lowrank_sample_raw(seed, it, location, scale_diag, scale_factors, n, row0=0):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if location.is_cuda:
        return lowrank_sample_cuda(seed, it, location, scale_diag, scale_factors, n, row0)
    if location.device.type == "cpu":
        return lowrank_sample_reference(seed, it, location, scale_diag, scale_factors, n, row0)
    raise ValueError(f"no sampler for device {location.device}")


class _LowRankSample(torch.autograd.Function):
    """z = u1 D + u2 U^T + m with dm = sum ct_z, dD = sum ct_z u1 and
    dU = ct_z^T u2 (the reference's ``_lr_bwd``; outside the kernel)."""

    @staticmethod
    def forward(ctx, location, scale_diag, scale_factors, seed, it, n, row0):
        z, u1, u2 = lowrank_sample_raw(seed, it, location, scale_diag, scale_factors, n, row0)
        ctx.save_for_backward(u1, u2)
        ctx.mark_non_differentiable(u1, u2)
        return z, u1, u2

    @staticmethod
    def backward(ctx, ct_z, ct_u1, ct_u2):
        u1, u2 = ctx.saved_tensors
        return ct_z.sum(dim=0), (ct_z * u1).sum(dim=0), ct_z.T @ u2, None, None, None, None


def lowrank_sample(
    seed: Tuple[int, int], it: int, location: torch.Tensor,
    scale_diag: torch.Tensor, scale_factors: torch.Tensor, n: int, row0: int = 0,
):
    """Fused z = u1 D + u2 U^T + m; returns (z, u1, u2), rows [row0, row0 +
    n) of the draw, differentiable in (m, D, U)."""
    return _LowRankSample.apply(location, scale_diag, scale_factors, tuple(seed), int(it),
                                int(n), int(row0))


def normal_moments_ok(u: torch.Tensor, sigmas: float = 5.0) -> bool:
    """Mean and variance of iid N(0, 1) draws within ``sigmas`` standard
    errors (used by the tests and the chip check)."""
    m = u.numel()
    mean = float(u.double().mean())
    var = float(u.double().var())
    return abs(mean) < sigmas / math.sqrt(m) and abs(var - 1.0) < sigmas * math.sqrt(2.0 / m)
