"""Step-indexed Philox normals and the fused mean-field sampler (CUDA).

Port of ops/pallas/location_scale_kernels.py (``_uniform01``,
``_box_muller``, ``_meanfield_sample_raw`` and the ``meanfield_sample``
custom VJP).  The TPU kernel drew its bits from the on-chip PRNG; here they
come from Philox4x32-10 (Salmon et al., SC'11), a counter-based generator
that is the same function on the card (csrc/philox.cuh) and in plain
PyTorch (``philox4x32_reference``):

- key = the two uint32 seed words;
- counter = (global iteration, sample row, lane group j // 4, stream);
  stream 0 gives the four u1 uniforms of a lane group, stream 1 the four u2.

So a draw depends on (seed, iteration, row, lane) only: never on the chunk,
the launch geometry or the device, which is the step-indexed contract of
the reference's fused engine (fused_advi.py:465-473).  Uniforms take the
top 23 bits by the mantissa trick and normals are
``sqrt(-2 log(u1 + 2^-24)) * cos(2 pi u2)``, the reference's Box-Muller.

Every wrapper takes the plain PyTorch version for a tensor on the CPU and
launches the kernel for a CUDA tensor; there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple, Union

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


def philox4x32_reference(counter, key: Tuple[int, int]):
    """Philox4x32-10 of four counter words (int64 tensors or ints holding
    uint32 values, broadcast together) under a two-word key; ints go to
    the device of the tensor words."""
    device = next((c.device for c in counter if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=device) for c in counter)
    )
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) float32 from uint32 bits: (bits >> 9) | 0x3F800000 lies in
    [1, 2) as a float32."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(-2.0 * torch.log(u1 + TINY_F32)) * torch.cos(
        TWO_PI_F32 * u2
    )


def philox_normals_reference(
    seed: Tuple[int, int], it: int, n: int, d: int, device=None
) -> torch.Tensor:
    """(n, d) standard normals of iteration ``it``: element (i, j) comes from
    counter (it, i, j // 4, stream) at position j % 4 of the output words."""
    groups = -(-d // 4)
    row = torch.arange(n, dtype=torch.int64, device=device).view(n, 1)
    grp = torch.arange(groups, dtype=torch.int64, device=device).view(1, groups)
    c0 = torch.tensor(it & _MASK32, dtype=torch.int64, device=device)
    words1 = philox4x32_reference((c0, row, grp, 0), seed)
    words2 = philox4x32_reference((c0, row, grp, 1), seed)
    bits1 = torch.stack(words1, dim=-1).reshape(n, 4 * groups)[:, :d]
    bits2 = torch.stack(words2, dim=-1).reshape(n, 4 * groups)[:, :d]
    return box_muller(uniform01(bits1), uniform01(bits2))


# ---------------------------------------------------------------------------
# K7a: the mean-field sampler
# ---------------------------------------------------------------------------


def meanfield_sample_reference(
    seed: Tuple[int, int], it: int, location: torch.Tensor,
    scale_diag: torch.Tensor, n: int,
):
    """Plain version of the kernel: z = u * sigma + m; returns (z, u)."""
    u = philox_normals_reference(
        seed, it, n, location.shape[0], device=location.device
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
       ctypes.c_uint32, ctypes.c_void_p]
)


def meanfield_sample_cuda(
    seed: Tuple[int, int], it: int, location: torch.Tensor,
    scale_diag: torch.Tensor, n: int,
):
    """Launch csrc/meanfield_sample.cu on the current stream; returns (z, u).
    Adds one to ``meanfield_sample_cuda.launches`` per launch."""
    if not location.is_cuda:
        raise ValueError(f"meanfield_sample_cuda needs GPU tensors, got {location.device}")
    d = location.shape[0]
    check_f32("location", location, (d,), location.device)
    check_f32("scale_diag", scale_diag, (d,), location.device)
    fn = _build.function("meanfield_sample", "meanfield_sample", _SAMPLE_ARGTYPES)
    z = torch.empty((n, d), dtype=torch.float32, device=location.device)
    u = torch.empty((n, d), dtype=torch.float32, device=location.device)
    if n == 0:
        return z, u
    with torch.cuda.device(location.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            location.data_ptr(), scale_diag.data_ptr(), z.data_ptr(),
            u.data_ptr(), n, d, seed[0], seed[1], it & _MASK32, stream,
        )
    _build.check(err, "meanfield_sample launch")
    meanfield_sample_cuda.launches += 1
    return z, u


meanfield_sample_cuda.launches = 0


def meanfield_sample_raw(seed, it, location, scale_diag, n):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if location.is_cuda:
        return meanfield_sample_cuda(seed, it, location, scale_diag, n)
    if location.device.type == "cpu":
        return meanfield_sample_reference(seed, it, location, scale_diag, n)
    raise ValueError(f"no sampler for device {location.device}")


class _MeanFieldSample(torch.autograd.Function):
    """z = u * sigma + m with dz/dm = 1 and dz/dsigma = u (the reference's
    ``_mf_bwd``: the backward is two reductions, outside the kernel)."""

    @staticmethod
    def forward(ctx, location, scale_diag, seed, it, n):
        z, u = meanfield_sample_raw(seed, it, location, scale_diag, n)
        ctx.save_for_backward(u)
        ctx.mark_non_differentiable(u)
        return z, u

    @staticmethod
    def backward(ctx, ct_z, ct_u):
        (u,) = ctx.saved_tensors
        return ct_z.sum(dim=0), (ct_z * u).sum(dim=0), None, None, None


def meanfield_sample(
    seed: Tuple[int, int], it: int, location: torch.Tensor,
    scale_diag: torch.Tensor, n: int,
):
    """Fused z = u * sigma + m; returns (z, u), differentiable in (m, sigma)."""
    return _MeanFieldSample.apply(location, scale_diag, tuple(seed), int(it), int(n))


def normal_moments_ok(u: torch.Tensor, sigmas: float = 5.0) -> bool:
    """Mean and variance of iid N(0, 1) draws within ``sigmas`` standard
    errors (used by the tests and the chip check)."""
    m = u.numel()
    mean = float(u.double().mean())
    var = float(u.double().var())
    return abs(mean) < sigmas / math.sqrt(m) and abs(var - 1.0) < sigmas * math.sqrt(2.0 / m)
