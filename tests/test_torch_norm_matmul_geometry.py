"""``fused_norm_matmul``'s launch geometry, a pure function of the shapes.

The wrapper's ``plan`` picks the body (the GEMV for f32, swap AB on wgmma
for decode rows, the warp-specialized wgmma body for prefill rows), its
tile, the split of K and the ring's depth. A row's bits rest on two things
here: the body changes only at a fixed row count, and the split points of K
depend on (hidden, out) alone, so within a body a row's sums run over the
same steps in the same order whatever rows share the call. The card tests hold the bodies to that bitwise; these tests hold
the choice itself, on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cake_tpu_torch.ops.fused_norm_matmul import (
    BLOCK_K,
    DECODE_ROWS,
    MAX_ROWS,
    MAX_SPLITS,
    MAX_STAGES,
    ROW_TILES,
    SA_COLS,
    SMEM_CAP,
    SMS,
    WS_ROWS,
    Plan,
    _run,
    fused_norm_matmul_plain,
    plan,
    smem_bytes,
    split_steps,
)

# Llama-3-8B's three norm sites, (hidden, out).
LLAMA3 = {"wqkv": (4096, 6144), "w_gu": (4096, 28672), "lm_head": (4096, 128256)}
# The card tests' shapes: ragged last strips, a hidden that ends mid-K-step.
SMALL = [(512, 384), (512, 200), (512, 17000), (512, 40000), (520, 1000), (256, 256), (64, 64)]
SHAPES = list(LLAMA3.values()) + SMALL
HALF = [torch.bfloat16, torch.float16]
ALL_ROWS = range(1, MAX_ROWS + 1)


def _cdiv(a, b):
    return -(-a // b)


def _body(rows, dtype):
    if dtype == torch.float32:
        return "gemv"
    return "swap_ab" if rows <= DECODE_ROWS else "warp_specialized"


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", HALF + [torch.float32], ids=str)
def test_body_at_every_row_count(shape, dtype):
    """The body changes with the dtype and at DECODE_ROWS only; swap AB's
    row tile is the smallest product width that holds every row."""
    hidden, out_dim = shape
    for rows in ALL_ROWS:
        p = plan(rows, hidden, out_dim, dtype)
        assert p.body == _body(rows, dtype), rows
        assert p.route == ("CUDA cores" if p.body == "gemv" else "wgmma")
        if p.body == "swap_ab":
            assert p.tile == min(t for t in ROW_TILES if t >= rows)
        if p.body == "gemv":
            assert (p.tile, p.stages) == (0, 0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", HALF + [torch.float32], ids=str)
def test_split_of_k_does_not_change_with_the_rows(shape, dtype):
    """Within each body one split of K for every row count: swap AB's is
    split_steps's, the others' one split over all of K."""
    hidden, out_dim = shape
    steps = _cdiv(hidden, BLOCK_K)
    by_body = {}
    for rows in ALL_ROWS:
        p = plan(rows, hidden, out_dim, dtype)
        by_body.setdefault(p.body, set()).add((p.per, p.splits))
    for body, splits in by_body.items():
        assert len(splits) == 1, (body, splits)
        per, n = splits.pop()
        if body == "swap_ab":
            assert per == split_steps(hidden, out_dim)
        else:
            assert per == steps
        assert n == _cdiv(steps, per) and 1 <= n <= MAX_SPLITS


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", HALF + [torch.float32], ids=str)
def test_shared_memory_within_a_block(shape, dtype):
    hidden, out_dim = shape
    for rows in ALL_ROWS:
        p = plan(rows, hidden, out_dim, dtype)
        assert smem_bytes(p, rows, hidden, dtype) <= SMEM_CAP, (rows, p)
        assert p.body == "gemv" or 2 <= p.stages <= MAX_STAGES


@pytest.mark.parametrize("name", sorted(LLAMA3))
def test_swap_ab_blocks_cover_the_card_at_llama3_sites(name):
    """At decode rows every Llama-3-8B site has at least a block an SM:
    wqkv's 48 strips by splitting K, w_gu's and lm_head's by their strips."""
    hidden, out_dim = LLAMA3[name]
    for rows in range(1, DECODE_ROWS + 1):
        p = plan(rows, hidden, out_dim, torch.bfloat16)
        assert _cdiv(out_dim, SA_COLS) * p.splits >= SMS, (rows, p)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_fills_the_card_as_far_as_the_steps_allow(shape):
    """Swap AB splits K until its blocks give every SM two, within
    MAX_SPLITS and the K steps there are."""
    hidden, out_dim = shape
    strips, steps = _cdiv(out_dim, SA_COLS), _cdiv(hidden, BLOCK_K)
    p = plan(8, hidden, out_dim, torch.bfloat16)
    wanted = min(MAX_SPLITS, steps, max(1, 2 * SMS // strips))
    assert p.splits == _cdiv(steps, _cdiv(steps, wanted))
    assert strips * p.splits >= min(SMS, strips * _cdiv(steps, _cdiv(steps, wanted)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_prefill_tile_is_the_widest_that_fills_the_card(shape):
    hidden, out_dim = shape
    for rows in range(DECODE_ROWS + 1, MAX_ROWS + 1):
        p = plan(rows, hidden, out_dim, torch.bfloat16)
        wide = _cdiv(rows, WS_ROWS) * _cdiv(out_dim, 256) >= SMS
        assert p.tile == (256 if wide else 128), rows


# The Llama-3-8B plans at the rows chip_smoke.py times: (body, tile, splits).
PINNED = {
    1: {"wqkv": ("swap_ab", 8, 5), "w_gu": ("swap_ab", 8, 1), "lm_head": ("swap_ab", 8, 1)},
    4: {"wqkv": ("swap_ab", 8, 5), "w_gu": ("swap_ab", 8, 1), "lm_head": ("swap_ab", 8, 1)},
    8: {"wqkv": ("swap_ab", 8, 5), "w_gu": ("swap_ab", 8, 1), "lm_head": ("swap_ab", 8, 1)},
    16: {"wqkv": ("swap_ab", 16, 5), "w_gu": ("swap_ab", 16, 1), "lm_head": ("swap_ab", 16, 1)},
    64: {"wqkv": ("swap_ab", 64, 5), "w_gu": ("swap_ab", 64, 1), "lm_head": ("swap_ab", 64, 1)},
    128: {"wqkv": ("warp_specialized", 128, 1), "w_gu": ("warp_specialized", 128, 1),
          "lm_head": ("warp_specialized", 256, 1)},
    256: {"wqkv": ("warp_specialized", 128, 1), "w_gu": ("warp_specialized", 256, 1),
          "lm_head": ("warp_specialized", 256, 1)},
}


@pytest.mark.parametrize("rows", sorted(PINNED))
@pytest.mark.parametrize("name", sorted(LLAMA3))
def test_llama3_plans(name, rows):
    hidden, out_dim = LLAMA3[name]
    p = plan(rows, hidden, out_dim, torch.bfloat16)
    assert (p.body, p.tile, p.splits) == PINNED[rows][name]


@pytest.mark.parametrize(
    "rows,hidden,out_dim,dtype",
    [
        (0, 512, 384, torch.bfloat16),
        (MAX_ROWS + 1, 512, 384, torch.bfloat16),
        (8, 512, 384, torch.int8),
        (8, 512, 384, torch.float64),
        (8, 516, 384, torch.bfloat16),  # hidden not a multiple of 8
        (8, 512, 380, torch.float16),  # out not a multiple of 8
        (8, 510, 384, torch.float32),  # hidden not a multiple of 4
        (8, 30000, 384, torch.float32),  # the GEMV's staged row past its shared memory
    ],
)
def test_plan_refuses_what_the_kernel_does_not_take(rows, hidden, out_dim, dtype):
    with pytest.raises(ValueError):
        plan(rows, hidden, out_dim, dtype)


@pytest.mark.parametrize("rows", [1, 8, 64, 200])
def test_run_on_the_cpu_is_the_plain_version(rows):
    """_run hands a tensor on the CPU to the plain version, whatever the
    plan (on the card it launches the plan's body)."""
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((rows, 64), dtype=np.float32))
    nw = torch.from_numpy(rng.standard_normal(64, dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 48), dtype=np.float32))
    want = fused_norm_matmul_plain(x, nw, w, eps=1e-5, offset=True)
    for p in (plan(rows, 64, 48, torch.bfloat16), Plan("warp_specialized", 256, 1, 1, 4)):
        got = _run(x, nw, w, dataclasses.replace(p), eps=1e-5, offset=True)
        assert torch.equal(got, want)
