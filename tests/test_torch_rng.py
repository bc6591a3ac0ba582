"""The port's step-indexed Philox normals, plain version
(advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels): known answers,
an independent pure-Python implementation, the counter contract and moments.
The CUDA kernels draw the same bits; tests/test_torch_kernels.py holds them
to this plain version on a card."""

import math

import numpy as np
import pytest
import torch

from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    PhiloxKey,
    as_key,
    box_muller,
    normal_moments_ok,
    philox4x32_reference,
    philox_normals_reference,
    seed_words,
    uniform01,
)

torch.set_num_threads(1)

M32 = 0xFFFFFFFF

# Random123 kat_vectors, philox4x32_10: (counter, key) -> output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def philox_python(ctr, key):
    """Philox4x32-10 on Python ints (independent of the tensor version)."""
    c = list(ctr)
    k0, k1 = key
    for _ in range(10):
        p0 = 0xD2511F53 * c[0]
        p1 = 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & M32, p1 & M32,
             ((p0 >> 32) ^ c[3] ^ k1) & M32, p0 & M32]
        k0 = (k0 + 0x9E3779B9) & M32
        k1 = (k1 + 0xBB67AE85) & M32
    return tuple(c)


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = philox4x32_reference(tuple(torch.tensor(c) for c in ctr), key)
    assert tuple(int(w) for w in got) == want
    assert philox_python(ctr, key) == want


def test_philox_matches_pure_python():
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2**32, size=(4, 64), dtype=np.uint64).astype(np.int64)
    key = tuple(int(k) for k in rng.integers(0, 2**32, size=2, dtype=np.uint64))
    got = philox4x32_reference(tuple(torch.from_numpy(c) for c in ctr), key)
    got = torch.stack(got, dim=1).tolist()
    for i in range(ctr.shape[1]):
        assert tuple(got[i]) == philox_python(tuple(int(c) for c in ctr[:, i]), key)


def test_uniform01_mantissa_trick():
    bits = torch.tensor([0, 511, 512, M32, 0x80000000], dtype=torch.int64)
    u = uniform01(bits)
    assert u.dtype == torch.float32
    assert u.tolist() == [0.0, 0.0, 2.0**-23, 1.0 - 2.0**-23, 0.5]


def test_normals_follow_the_counter_layout():
    """Element (i, j) of iteration it is Box-Muller of words j % 4 of the
    counters (it, i, j // 4, 0) and (it, i, j // 4, 1)."""
    seed, it, n, d = (12345, 678), 9, 3, 10
    u = philox_normals_reference(seed, it, n, d)
    for i in range(n):
        for j in range(d):
            a = philox_python((it, i, j // 4, 0), seed)[j % 4]
            b = philox_python((it, i, j // 4, 1), seed)[j % 4]
            want = box_muller(uniform01(torch.tensor(a)), uniform01(torch.tensor(b)))
            assert u[i, j] == want


def test_normals_are_step_indexed_and_deterministic():
    seed = seed_words(7)
    a = philox_normals_reference(seed, 5, 10, 62)
    assert torch.equal(a, philox_normals_reference(seed, 5, 10, 62))
    # rows and lanes do not depend on the block drawn
    assert torch.equal(a[:4, :30], philox_normals_reference(seed, 5, 4, 30))
    b = philox_normals_reference(seed, 6, 10, 62)
    assert not torch.any(a == b)
    c = philox_normals_reference(seed_words(8), 5, 10, 62)
    assert not torch.any(a == c)


def test_normal_moments_within_five_sigma():
    u = philox_normals_reference(seed_words(3), 0, 1000, 100)
    assert u.numel() == 10**5
    assert normal_moments_ok(u, sigmas=5.0)
    assert float(u.abs().max()) < math.sqrt(-2.0 * math.log(2.0**-24)) + 1e-4


def test_seed_words():
    assert seed_words(5) == (5, 0)
    assert seed_words(2**40 + 3) == (3, 2**8)
    assert seed_words((1, 2**32 + 2)) == (1, 2)
    assert seed_words(PhiloxKey((4, 5), 9)) == (4, 5)
    g1 = torch.Generator().manual_seed(0)
    g2 = torch.Generator().manual_seed(0)
    assert seed_words(g1) == seed_words(g2)
    assert as_key(5) == PhiloxKey((5, 0), 0)
    with pytest.raises(ValueError):
        seed_words((1, 2, 3))
