"""K4-bwd's row plan (``mmf_tpu_torch.ops.layernorm.bwd_row_plan`` and
``bwd_row_run``): the grid of the LayerNorm backward's kernel and the run
of rows each block takes, as the kernel computes them. Plain Python: it
runs on the CPU."""

import pytest

from mmf_tpu_torch.ops import layernorm as L

# the rows the main paths' training steps run K4-bwd at (B=64 unless
# said): LXMERT's masked VQA2 (20 tokens, 36 regions), MMBT at B=32,
# ViLBERT's regions (100) and text (128), MMFT (114), VinVL (170),
# VisualBERT and UNITER (228), M4C at B=128 (182), ViLT (617), and heads
# at 24-96 rows; and the edges of the grid: one row, an SM's worth of
# blocks and two (132 and 264 on an H100), the parent kernel's pass of
# 2112 rows, 2304 +- 1
ROWS = [1280, 2304, 4192, 6400, 8192, 7296, 10880, 14592, 23296, 39488,
        24, 64, 96, 1, 131, 132, 133, 263, 264, 265, 2111, 2112, 2113,
        2303, 2305]
# (SMs, blocks an SM holds, rows a block takes at once): the H100 at the
# main paths' widths (one block an SM, tiles of 8 rows), at narrow widths
# (more blocks an SM) and over 8192 columns (a block a row), and a smaller
# card with rows of 4 warps
CARDS = [(132, 1, 8), (132, 3, 8), (132, 2, 1), (16, 1, 2)]


@pytest.mark.parametrize("sms,per_sm,tile", CARDS)
@pytest.mark.parametrize("rows", ROWS)
def test_row_plan_covers_every_row_once(rows, sms, per_sm, tile):
    """Every row exactly once, in contiguous runs balanced within one
    row; a block on every SM whenever rows >= SMs; the grid within what
    the card holds at once; below that a block a tile, up to 16; the
    partials summed in groups of up to 16 blocks."""
    grid, group = L.bwd_row_plan(rows, sms, per_sm, tile)
    assert 1 <= grid <= min(rows, sms * per_sm)
    if rows >= sms:
        assert grid >= sms
        if per_sm == 1:  # no SM can take a second block
            assert grid == sms
    else:
        assert grid == min(-(-rows // tile), 16)
    runs = [L.bwd_row_run(b, rows, grid) for b in range(grid)]
    row = 0
    for start, count in runs:
        assert start == row and count >= 1
        row += count
    assert row == rows
    counts = [count for _, count in runs]
    assert max(counts) - min(counts) <= 1
    assert group == min(grid, 16)
