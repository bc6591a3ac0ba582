"""K7b, the full-rank sampler, on the CPU: its plain version against the JAX
package's ``_fullrank_kernel`` formula, and the plan that cuts the kernel's
product over the card's blocks (``fullrank_plan``).

The JAX kernel draws its normals from the TPU's PRNG, which has no CPU
lowering, so both sides take the same numpy u and C and the comparison is
of the product that follows the draws (``_fullrank_kernel``:
``u @ scale.T + loc``).  The kernel itself runs only on a card
(tests/test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    FR_STEP,
    FR_TILE,
    fullrank_affine_reference,
    fullrank_plan,
    fullrank_sample_reference,
    seed_words,
)

torch.set_num_threads(1)

H100_SMS = 132
# ragged shapes: n and d off every tile and step multiple, then bench_large's
# second shape
SHAPES = [(n, d) for n in (1, 3, 7, 33, 300) for d in (1, 5, 33, 62, 100, 1000)] + [
    (128, 2048)]


def _rel(a, b) -> float:
    """Norm-wise relative difference ||a - b||_F / ||b||_F, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _factor_nan_above(rng, d):
    """A lower-triangular factor with NaN above the diagonal: any read of the
    upper triangle shows."""
    C = np.tril(rng.standard_normal((d, d)) / np.sqrt(d)) + np.eye(d)
    C[np.triu_indices(d, 1)] = np.nan
    return C.astype(np.float32)


@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_version_matches_jax_fullrank_kernel_formula(n, d):
    """The plain product against ``_fullrank_kernel``'s ``u @ scale.T + loc``
    (JAX on the CPU, its scale the triangle) on the same numpy u and C:
    norm-wise within 1e-6, the two float32 sums over d taken in other orders.
    The upper triangle holds NaN and z stays finite."""
    rng = np.random.default_rng(n * 4099 + d)
    u = rng.standard_normal((n, d)).astype(np.float32)
    C = _factor_nan_above(rng, d)
    loc = rng.standard_normal(d).astype(np.float32)
    want = jnp.dot(jnp.asarray(u), jnp.asarray(np.tril(C)).T,
                   preferred_element_type=jnp.float32) + jnp.asarray(loc)
    got = fullrank_affine_reference(torch.from_numpy(u), torch.from_numpy(loc),
                                    torch.from_numpy(C))
    assert torch.isfinite(got).all()
    assert _rel(got.numpy(), want) <= 1e-6
    # the sampler's plain version is that product of its own draws
    z, ud = fullrank_sample_reference(seed_words(7), 3, torch.from_numpy(loc),
                                      torch.from_numpy(C), n)
    assert torch.equal(z, fullrank_affine_reference(ud, torch.from_numpy(loc),
                                                    torch.from_numpy(C)))


def _segments(plan):
    """The plan's segments, block by block, from its table."""
    words = plan.table.tolist()
    head = (plan.blocks + 4) & ~3
    offsets = words[:plan.blocks + 1]
    segs = [tuple(words[head + 8 * s: head + 8 * s + 8]) for s in range(offsets[-1])]
    return [segs[offsets[b]:offsets[b + 1]] for b in range(plan.blocks)]


@pytest.mark.parametrize("sms", [H100_SMS, 7])
@pytest.mark.parametrize("n,d", SHAPES + [(256, 1024)])
def test_plan_covers_the_triangle_once_and_balances_the_blocks(n, d, sms):
    """Every (row tile, column tile, step) of the triangle lies in exactly one
    segment; a split tile's pieces are numbered 0.. in block order and own
    distinct workspace slots; and the longest block takes at most 1.25x the
    mean (stream-K: the blocks differ by at most one step, and each takes at
    least four)."""
    plan = fullrank_plan(n, d, sms)
    row_tiles, col_tiles = -(-n // FR_TILE), -(-d // FR_TILE)
    assert plan.tiles == row_tiles * col_tiles and 1 <= plan.blocks <= sms
    need = {(FR_TILE * i, FR_TILE * j, s) for i in range(row_tiles) for j in range(col_tiles)
            for s in range(-(-min(d, FR_TILE * (j + 1)) // FR_STEP))}
    seen, pieces, slots, steps = [], {}, set(), []
    for segs in _segments(plan):
        steps.append(sum(s1 - s0 for _, _, s0, s1, *_ in segs))
        for row0, col0, s0, s1, tile, piece, npieces, slot in segs:
            assert 0 <= s0 < s1
            assert tile == (col0 // FR_TILE) * row_tiles + row0 // FR_TILE
            seen += [(row0, col0, s) for s in range(s0, s1)]
            pieces.setdefault(tile, []).append((piece, npieces, slot))
            if npieces > 1:
                slots.add(slot + piece)
    assert len(seen) == len(set(seen)) and set(seen) == need
    for tile, ps in pieces.items():
        assert [p for p, _, _ in ps] == list(range(len(ps)))
        assert all(np_ == len(ps) for _, np_, _ in ps) and len({s for *_, s in ps}) == 1
    assert len(slots) == plan.slots
    mean = len(need) / plan.blocks
    assert max(steps) - min(steps) <= 1 and max(steps) <= 1.25 * mean


@pytest.mark.parametrize("n,d,sms", [(256, 1024, H100_SMS), (300, 100, H100_SMS),
                                     (33, 1000, 7), (7, 62, H100_SMS)])
def test_plan_sums_in_piece_order_give_the_product(n, d, sms):
    """The kernel's sum, taken as the plan lays it out (each piece's partial
    over its steps, the pieces of a tile added in piece order, then m),
    against the plain version: norm-wise within 1e-6."""
    rng = np.random.default_rng(d)
    u = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    C = torch.from_numpy(_factor_nan_above(rng, d))
    loc = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    L = torch.tril(C)
    parts = {}
    for segs in _segments(fullrank_plan(n, d, sms)):
        for row0, col0, s0, s1, tile, piece, _, _ in segs:
            k0, k1 = FR_STEP * s0, min(d, FR_STEP * s1)
            rows, cols = slice(row0, row0 + FR_TILE), slice(col0, col0 + FR_TILE)
            parts.setdefault((row0, col0), {})[piece] = u[rows, k0:k1] @ L[cols, k0:k1].T
    z = torch.empty(n, d)
    for (row0, col0), ps in parts.items():
        acc = ps[0]
        for q in range(1, len(ps)):
            acc = acc + ps[q]
        z[row0:row0 + FR_TILE, col0:col0 + FR_TILE] = acc + loc[col0:col0 + FR_TILE]
    assert torch.isfinite(z).all()
    assert _rel(z.numpy(), fullrank_affine_reference(u, loc, C).numpy()) <= 1e-6
