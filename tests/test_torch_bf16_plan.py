"""The bfloat16 sampling product's host side on the CPU: the route the
wrapper picks by shape (``bf16_route``), the stream-K plan its kernel walks
(K7b's ``fullrank_plan`` with each tile's epilogue counted as
``BF16_TILE_COST`` steps), and the kernel's order of sums taken as the plan
lays it out, against the plain version and JAX's mixed-precision product.

The kernel itself (csrc/fullrank_bf16.cu) runs only on a card
(tests/test_torch_kernels.py); what it relies on from the plan is checked
here: every (tile, step) of the range's triangle once, a cut tile's pieces
numbered in block order with distinct workspace slots, and a cut tile's
piece 0 the last segment of its block (the piece that adds the others).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedvi_jl_tpu_torch.ops.cuda.location_scale_kernels import (
    BF16_TILE_COST,
    FR_STEP,
    FR_TILE,
    bf16_round,
    bf16_route,
    fullrank_bf16_reference,
    fullrank_plan,
)

torch.set_num_threads(1)

H100_SMS = 132
# the card test's shapes (tests/test_torch_kernels.py FR_SAMPLE_SHAPES)
SHAPES = [(256, 1024), (10, 62), (33, 5)] + [
    (n, d) for n in (1, 3, 7, 33, 300) for d in (1, 5, 33, 62, 100, 1000)
    if (n, d) != (33, 5)] + [(128, 2048)]


def _cut_ranges(d):
    """The card test's column ranges: halves, a ragged third, the last
    column, all but the first."""
    out = [(0, d // 2), (d // 2, d - d // 2), (d // 3, d // 3 + 1), (d - 1, 1), (1, d - 1)]
    return [(c0, nc) for c0, nc in out if nc > 0 and c0 + nc <= d]


def _segments(plan):
    """The plan's segments, block by block, from its table."""
    words = plan.table.tolist()
    head = (plan.blocks + 4) & ~3
    offsets = words[:plan.blocks + 1]
    segs = [tuple(words[head + 8 * s: head + 8 * s + 8]) for s in range(offsets[-1])]
    return [segs[offsets[b]:offsets[b + 1]] for b in range(plan.blocks)]


@pytest.mark.parametrize("n,d,aligned,route", [
    (256, 1024, True, "tma"), (128, 2048, True, "tma"), (300, 100, True, "tma"),
    (1, 4, True, "tma"), (256, 1024, False, "loads"), (10, 62, True, "loads"),
    (33, 5, True, "loads"), (7, 33, True, "loads"), (3, 1, True, "loads"),
    (0, 1024, True, None), (0, 62, False, None)])
def test_route_is_a_function_of_the_shape(n, d, aligned, route):
    """TMA where a row of d floats is whole 16-byte units and both operands
    start on 16 bytes, the warpgroups' own loads otherwise, nothing for no
    draws."""
    assert bf16_route(n, d, aligned) == route


@pytest.mark.parametrize("n,d", SHAPES)
def test_plan_covers_each_range_once_and_piece_zero_ends_its_block(n, d):
    """Over the whole width and each column range: every (row tile, column
    tile, step) of the range's triangle in exactly one segment; a cut tile's
    pieces numbered 0.. in block order with their own workspace slots; a
    cut tile's piece 0 the last segment of its block; no more blocks than
    SMs."""
    for cols in [(0, d)] + _cut_ranges(d):
        col0, ncols = cols
        end = col0 + ncols
        plan = fullrank_plan(n, d, H100_SMS, col0, ncols, BF16_TILE_COST)
        row_tiles, col_tiles = -(-n // FR_TILE), -(-ncols // FR_TILE)
        assert plan.tiles == row_tiles * col_tiles and 1 <= plan.blocks <= H100_SMS
        need = {(FR_TILE * i, col0 + FR_TILE * j, s) for i in range(row_tiles)
                for j in range(col_tiles)
                for s in range(-(-min(end, col0 + FR_TILE * (j + 1)) // FR_STEP))}
        seen, pieces, slots = [], {}, set()
        for b, segs in enumerate(_segments(plan)):
            for k, (row0, c0, s0, s1, tile, piece, npieces, slot) in enumerate(segs):
                assert 0 <= s0 < s1, cols
                assert tile == ((c0 - col0) // FR_TILE) * row_tiles + row0 // FR_TILE
                seen += [(row0, c0, s) for s in range(s0, s1)]
                pieces.setdefault(tile, []).append((b, piece, npieces, slot))
                if npieces > 1:
                    slots.add(slot + piece)
                    if piece == 0:
                        assert k == len(segs) - 1, (cols, b)
        assert len(seen) == len(set(seen)) and set(seen) == need, cols
        for tile, ps in pieces.items():
            assert [p for _, p, _, _ in ps] == list(range(len(ps)))
            assert [b for b, *_ in ps] == sorted(b for b, *_ in ps)
            assert all(np_ == len(ps) for _, _, np_, _ in ps)
            assert len({s for *_, s in ps}) == 1
        assert len(slots) == plan.slots


@pytest.mark.parametrize("n,d", [(256, 1024), (128, 2048), (300, 1000), (33, 62)])
def test_plan_balances_steps_with_each_tiles_epilogue(n, d):
    """Each block's range, its steps plus BF16_TILE_COST a tile it starts,
    is within one step and one tile's cost of the mean; without the cost
    the plan is K7b's own."""
    plan = fullrank_plan(n, d, H100_SMS, tile_cost=BF16_TILE_COST)
    loads = []
    for segs in _segments(plan):
        loads.append(sum(s1 - s0 + (BF16_TILE_COST if piece == 0 else 0)
                         for _, _, s0, s1, _, piece, _, _ in segs))
    mean = sum(loads) / len(loads)
    assert max(loads) <= mean + 1 + BF16_TILE_COST
    assert torch.equal(fullrank_plan(n, d, H100_SMS, tile_cost=0).table,
                       fullrank_plan(n, d, H100_SMS).table)


def _factor_nan_above(rng, d):
    C = np.tril(rng.standard_normal((d, d)) / np.sqrt(d)) + np.eye(d)
    C[np.triu_indices(d, 1)] = np.nan
    return C.astype(np.float32)


def _kernel_order(u, C, loc, plan, col0, ncols):
    """z as the kernel sums it: each step's bf16 products in float32 into
    fresh sums, steps to warpgroup step % 2 in the block's order, each group's
    sums added step by step, the two groups' sums added group 0's first at
    the end of a piece, a cut tile's pieces added in piece order, then m."""
    n, d = u.shape
    ub, L = bf16_round(u), bf16_round(torch.tril(torch.nan_to_num(C, nan=0.0)))
    z = torch.zeros(n, ncols)
    parts = {}
    for segs in _segments(plan):
        unit = 0
        for row0, c0, s0, s1, tile, piece, _, _ in segs:
            rows, cols = slice(row0, row0 + FR_TILE), slice(c0, c0 + FR_TILE)
            group = [torch.zeros(min(n, row0 + FR_TILE) - row0, min(d, c0 + FR_TILE) - c0)
                     for _ in range(2)]
            for s in range(s0, s1):
                k = slice(FR_STEP * s, min(d, FR_STEP * (s + 1)))
                group[unit % 2] = group[unit % 2] + ub[rows, k] @ L[cols, k].T
                unit += 1
            parts.setdefault((row0, c0), {})[piece] = group[0] + group[1]
    for (row0, c0), ps in parts.items():
        acc = ps[0]
        for q in range(1, len(ps)):
            acc = acc + ps[q]
        w = min(col0 + ncols, c0 + FR_TILE) - c0
        z[row0:row0 + FR_TILE, c0 - col0:c0 - col0 + w] = acc[:, :w] + loc[c0:c0 + w]
    return z


@pytest.mark.parametrize("n,d,cols", [(256, 1024, None), (128, 2048, (1024, 1024)),
                                      (300, 100, (33, 34)), (33, 62, None),
                                      (7, 1000, (1, 999))])
def test_kernel_order_of_sums_matches_plain_version_and_jax(n, d, cols):
    """The kernel's sum, taken in the plan's order, against the plain
    version and JAX's ``jnp.matmul(bf16(u), bf16(tril C)^T,
    preferred_element_type=float32) + m`` on the same numpy inputs (NaN
    above C's diagonal, never read): norm-wise within 1e-6, the same bf16
    products summed in other orders."""
    rng = np.random.default_rng(n * 7919 + d)
    u = rng.standard_normal((n, d)).astype(np.float32)
    C = _factor_nan_above(rng, d)
    loc = rng.standard_normal(d).astype(np.float32)
    col0, ncols = cols if cols is not None else (0, d)
    plan = fullrank_plan(n, d, H100_SMS, col0, ncols, BF16_TILE_COST)
    ut, Ct, lt = torch.from_numpy(u), torch.from_numpy(C), torch.from_numpy(loc)
    got = _kernel_order(ut, Ct, lt, plan, col0, ncols)
    want = fullrank_bf16_reference(ut, lt, Ct, cols)
    L = np.tril(np.nan_to_num(C))[col0:col0 + ncols]
    jax_z = np.asarray(jnp.matmul(jnp.asarray(u).astype(jnp.bfloat16),
                                  jnp.asarray(L).T.astype(jnp.bfloat16),
                                  preferred_element_type=jnp.float32)) + loc[col0:col0 + ncols]
    assert torch.isfinite(got).all()
    for ref in (want.numpy(), jax_z):
        err = np.linalg.norm(got.numpy().astype(np.float64) - ref) / np.linalg.norm(ref)
        assert err <= 1e-6


@pytest.mark.parametrize("d", [5, 62, 100, 128])
def test_packed_factor_is_contiguous_for_the_kernels(d):
    """The sampling kernels read the factor through a raw pointer (their
    wrappers refuse a view): the packed layout's unpacked factor is
    contiguous also where d is not a whole number of tiles, and equals the
    dense layout's."""
    import advancedvi_jl_tpu_torch as avt

    L = torch.tril(torch.randn(d, d, generator=torch.Generator().manual_seed(d)))
    loc = torch.zeros(d)
    fp = avt.FullRankGaussian(loc, L, compute_dtype="bfloat16", layout="packed")._factor()
    fd = avt.FullRankGaussian(loc, L, compute_dtype="bfloat16")._factor()
    assert fp.is_contiguous() and torch.equal(fp, fd)
