"""The grouped expert GEMM's pure-Python parts, on the CPU: ``plan()`` and
the tile list the kernel builds on the device from the group offsets.

``ops/moe.grouped_matmul`` launches ``csrc/moe_grouped.cu`` on the card;
its geometry comes from :func:`moe.plan`, and each block finds its work
items from ``offsets`` by the arithmetic :func:`moe.tile_items` repeats on
the host. Here:

  * the body, tile and instruction depend on (K, N, dtype, quant) alone,
    never on the rows or the group layout (the experts count sets only the
    ring's depth), and the ring fits the block's shared memory;
  * the tile list covers every row of every group exactly once a column
    strip, over random layouts of up to 128 experts with empty groups, in
    both wgmma bodies, never stores past a group's end or past M, and has
    no more items than the bound the host sizes the grid by.
"""

import inspect
import random

import pytest
import torch

from cake_tpu_torch.ops import moe

SHAPES = [(4096, 14336), (14336, 4096), (2048, 768), (768, 2048), (2048, 1408), (96, 48),
          (128, 96), (32, 8), (4096 + 32, 1024)]


def _offsets(sizes):
    out = [0]
    for n in sizes:
        out.append(out[-1] + n)
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16], ids=str)
def test_plan_depends_on_k_n_dtype_quant_alone(dtype, quant):
    assert list(inspect.signature(moe.plan).parameters) == ["k", "n", "dtype", "quant", "experts"]
    for k, n in SHAPES:
        if quant and n % 16:
            continue
        plans = [moe.plan(k, n, dtype, quant, e) for e in (1, 2, 8, 60, 128, 256)]
        assert len({(p.body, p.tile, p.instruction, p.route) for p in plans}) == 1, (k, n)
        p = plans[0]
        if dtype == torch.float32:
            assert (p.body, p.route, p.stages) == ("f32", "CUDA cores", 0)
        elif quant:
            assert (p.body, p.tile) == ("swap_ab", moe.SA_COLS)
            assert p.instruction.startswith(f"wgmma m64n{moe.PAIR_ROWS}k16")
        else:
            assert p.body == "warp_specialized" and p.tile == (256 if n >= 512 else 128)
            assert p.instruction.startswith(f"wgmma m64n{p.tile}k16")


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("experts", [1, 8, 128, 512])
def test_the_ring_fits_shared_memory(experts, quant):
    for k, n in SHAPES:
        if quant and n % 16:
            continue
        p = moe.plan(k, n, torch.bfloat16, quant, experts)
        assert 2 <= p.stages <= moe.MAX_STAGES
        # the kernel's dynamic shared memory: the ring, the 1024-byte
        # alignment, the offsets and their prefix; its 1 KB of static
        # shared memory besides
        smem = p.stages * moe.stage_bytes(p.tile, quant) + 1024 + 8 * (experts + 1)
        assert smem + 1024 <= moe.SMEM_CAP


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 32"):
        moe.plan(48, 64, torch.bfloat16, False, 4)
    with pytest.raises(ValueError, match="of 8"):
        moe.plan(64, 60, torch.bfloat16, False, 4)
    with pytest.raises(ValueError, match="of 16"):
        moe.plan(64, 40, torch.bfloat16, True, 4)
    with pytest.raises(TypeError):
        moe.plan(64, 64, torch.int8, False, 4)
    with pytest.raises(ValueError, match="no room"):
        moe.plan(64, 64, torch.bfloat16, False, 60000)


def _layouts(seed: int, n: int):
    """Random group layouts: up to 128 experts, empty groups, groups of one
    row, groups around the 128- and 256-row boundaries."""
    rng = random.Random(seed)
    for _ in range(n):
        e = rng.choice([1, 2, 3, 8, 60, 128])
        sizes = []
        for _ in range(e):
            kind = rng.random()
            if kind < 0.3:
                sizes.append(0)
            elif kind < 0.4:
                sizes.append(1)
            elif kind < 0.6:
                sizes.append(rng.choice([127, 128, 129, 255, 256, 257]))
            else:
                sizes.append(rng.randrange(0, 700))
        yield sizes


@pytest.mark.parametrize("quant", [False, True], ids=["warp_specialized", "swap_ab"])
@pytest.mark.parametrize("n", [8 * 16, 768, 1408, 4096])
def test_the_tile_list_covers_every_row_once_a_strip(n, quant):
    for sizes in _layouts(n + quant, 12):
        offs = _offsets(sizes)
        m = offs[-1]
        p = moe.plan(64, n, torch.bfloat16, quant, len(sizes))
        entries = moe.tile_items(torch.tensor(offs, dtype=torch.int32), n, p)
        strips = -(-n // p.tile)
        items = sorted({t for t, *_ in entries})
        assert items == list(range(len(items)))
        assert len(items) <= moe.item_bound(m, n, len(sizes), p)
        assert len(items) == strips * sum(-(-s // moe.PAIR_ROWS) for s in sizes)
        stored = {c: [0] * m for c in range(0, n, p.tile)}
        last = (-1, -1)
        for t, e, r0, rows, rend, n0 in entries:
            assert offs[e] <= r0 and rend == offs[e + 1] and 0 <= n0 < n and n0 % p.tile == 0
            assert rows == (moe.ROW_TILE if p.body == "warp_specialized" else moe.PAIR_ROWS)
            # expert by expert, a strip's row pairs side by side
            assert (e, n0) >= last
            last = (e, n0)
            for r in range(r0, min(r0 + rows, rend)):
                assert r < m
                stored[n0][r] += 1
        assert all(count == [1] * m for count in stored.values()), sizes


def test_the_item_prefix_counts_row_pairs():
    sizes = [3162, 48, 759, 0, 8, 80, 2273, 1094]
    assert moe.item_prefix(_offsets(sizes)) == [0, 13, 14, 17, 17, 18, 19, 28, 33]
    # a row's item and rows are the same whatever follows its group
    p = moe.plan(4096, 14336, torch.bfloat16, False, 8)
    a = [x for x in moe.tile_items(_offsets(sizes), 14336, p) if x[1] == 1]
    b = [x for x in moe.tile_items(_offsets(sizes[:2] + [5000] + sizes[3:]), 14336, p)
         if x[1] == 1]
    assert [x[2:] for x in a] == [x[2:] for x in b]
