"""``int4_matmul``'s launch geometry, a pure function of the shapes.

The wrapper picks the body (mma.sync at decode rows, wgmma past them, the
CUDA cores for f32), the wgmma row tile and whether one block folds every
split of K in order or each split is a block of its own with an ordered
reduce. A row's bits rest on one thing here: the split points of K are the
same whatever the row count, so every route adds a row's split sums in the
same order. The card tests hold the routes to each other bitwise; these
tests hold the choice itself, on the CPU.
"""

import pytest
import torch

from cake_tpu_torch.ops.int4_matmul import (
    BLOCK_K,
    DECODE_ROWS,
    FOLD_TILES,
    SCRATCH_BYTES,
    SMS,
    WG_COLS,
    WIDE_TILE,
    plan,
    scratch_rows,
    split_steps,
)

# Llama-3-8B's five int4 projections, (in, out, group).
LLAMA3 = {
    "wqkv": (4096, 6144, 128),
    "wo": (4096, 4096, 128),
    "w_gu": (4096, 28672, 128),
    "w_down": (14336, 4096, 128),
    "lm_head": (4096, 128256, 128),
}
# Small shapes of the card tests: ragged K steps, half strips, groups that
# divide the 64-row K step, a multiple of it, and one that does neither.
SMALL = [(1024, 384, 32), (1024, 512, 64), (2048, 640, 128), (64, 128, 16), (96, 48, 24),
         (2048, 640, 256), (64, 32, 8)]
SHAPES = list(LLAMA3.values()) + SMALL
ROWS = [1, 2, 8, 16, 17, 31, 32, 33, 64, 65, 100, 128, 129, 256, 300, 480, 3840]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:2])) + f"g{s[2]}")
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=str)
def test_split_points_do_not_depend_on_the_rows(shape, dtype):
    in_dim, out_dim, group = shape
    per = split_steps(in_dim, out_dim)
    plans = [plan(rows, in_dim, out_dim, dtype, group) for rows in ROWS]
    assert {(p.per, p.splits) for p in plans} == {(per, _cdiv(_cdiv(in_dim, BLOCK_K), per))}


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:2])) + f"g{s[2]}")
def test_route_by_rows_and_dtype(shape, rows):
    in_dim, out_dim, group = shape
    assert plan(rows, in_dim, out_dim, torch.float32, group).route == "CUDA cores"
    for dtype in (torch.bfloat16, torch.float16):
        p = plan(rows, in_dim, out_dim, dtype, group)
        # The wgmma body takes groups of 16 rows or more that align with
        # the K steps only.
        if rows <= DECODE_ROWS or group < 16 or (group % BLOCK_K and BLOCK_K % group):
            assert (p.route, p.tile, p.fold) == ("mma.sync", 0, False)
            continue
        assert p.route == "wgmma"
        assert p.tile in FOLD_TILES + (WIDE_TILE,)
        # The wide tile only where K is not split: a fold's running total
        # doubles the accumulators.
        assert p.tile != WIDE_TILE or p.splits == 1
        assert not p.fold or p.tile in FOLD_TILES
        # Folding only where several splits meet and the blocks fill at
        # least half the card.
        blocks = _cdiv(rows, p.tile) * _cdiv(out_dim, WG_COLS)
        assert p.fold == (p.splits > 1 and 2 * blocks >= SMS)
        # The smallest tile that holds every row, or the widest there is.
        holding = [t for t in FOLD_TILES if t >= rows]
        if holding:
            assert p.tile == min(holding)
        else:
            assert p.tile == (WIDE_TILE if p.splits == 1 else max(FOLD_TILES))


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:2])) + f"g{s[2]}")
def test_scratch_only_for_split_blocks(shape, rows):
    in_dim, out_dim, group = shape
    for dtype in (torch.bfloat16, torch.float32):
        p = plan(rows, in_dim, out_dim, dtype, group)
        chunk = scratch_rows(p, rows, out_dim)
        if p.splits == 1 or p.fold:
            assert chunk == 0
        else:
            # Every row in one pass where the partials fit, else chunks
            # that keep them under SCRATCH_BYTES (at least 16 rows).
            assert chunk >= min(rows, 16)
            assert chunk >= rows or chunk == 16 or 4 * p.splits * chunk * out_dim <= SCRATCH_BYTES


# The Llama-3-8B plans at the rows chip_smoke.py times (1, 8, 256, and the
# engine's 3840-row prefill window): (route, tile, fold).
PINNED = {
    1: {name: ("mma.sync", 0, False) for name in LLAMA3},
    8: {name: ("mma.sync", 0, False) for name in LLAMA3},
    256: {"wqkv": ("wgmma", 128, True), "wo": ("wgmma", 128, False),
          "w_gu": ("wgmma", 128, True), "w_down": ("wgmma", 128, False),
          "lm_head": ("wgmma", 256, False)},
    3840: {"wqkv": ("wgmma", 128, True), "wo": ("wgmma", 128, True),
           "w_gu": ("wgmma", 128, True), "w_down": ("wgmma", 128, True),
           "lm_head": ("wgmma", 256, False)},
}


@pytest.mark.parametrize("rows", sorted(PINNED))
@pytest.mark.parametrize("name", sorted(LLAMA3))
def test_llama3_plans(name, rows):
    in_dim, out_dim, group = LLAMA3[name]
    p = plan(rows, in_dim, out_dim, torch.bfloat16, group)
    assert (p.route, p.tile, p.fold) == PINNED[rows][name]
