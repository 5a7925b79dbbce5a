"""The ``sw_main`` kernel's partition of a block, held on the CPU.

``sw_main_partition`` below mirrors ``sw_main_launch``'s grid and the
kernel's lane columns (``kernels/csrc/sw_step.cu``).  These tests hold
it to cover every cell of a block exactly once and to give every
updated column its western and eastern neighbours inside its warp, and
hold its constants to those the CUDA source compiles with; and they
hold ``chip_smoke.py``'s small sw_main check blocks to cut warps and
strips short.  The kernel itself runs on the card only
(``python3 chip_smoke.py --check sw``).
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = ROOT / "mpi4jax_tpu_torch" / "kernels" / "csrc" / "sw_step.cu"

# sw_main's partition (the constexpr values of the same names in
# sw_step.cu): warps of a block side by side in x, the columns a warp
# updates, the rows a block walks down
MAIN_WARPS = 4
MAIN_COLS = 30
MAIN_TY = 4

# (rows, cols) of whole blocks, ghost rings included: the bench block
# (3600x1800 interior), chip_smoke's three small cases, and odd sizes
BLOCKS = [(1804, 3604), (49, 101), (65, 147), (13, 37), (40, 32), (9, 129),
          (1, 1), (5, 30), (8, 121)]


def sw_main_partition(rows, cols):
    """The ``sw_main`` kernel's work on a ``(rows, cols)`` block, as
    ``sw_main_launch`` lays it out.

    Returns ``(grid, warps)``: the grid's blocks in x and y, and one
    ``(rows, columns, updating)`` per warp that updates a column (a warp
    east of the block returns at once): the range of rows it walks down
    (after a prologue step at the row above), the column of each of its
    32 lanes (lane 0 one west of its first updated column, so -1 for the
    first warp, lane 31 one east of its last), and the lanes that update
    their column.  An updating lane takes its western neighbours from
    lane - 1 and its eastern ones from lane + 1.
    """
    per_block = MAIN_WARPS * MAIN_COLS
    grid = (-(-cols // per_block), -(-rows // MAIN_TY))
    warps = []
    for by in range(grid[1]):
        r0 = by * MAIN_TY
        for bx in range(grid[0]):
            for w in range(MAIN_WARPS):
                base = (bx * MAIN_WARPS + w) * MAIN_COLS
                if base >= cols:
                    continue
                columns = [base - 1 + lane for lane in range(32)]
                updating = [lane for lane in range(1, MAIN_COLS + 1)
                            if columns[lane] < cols]
                warps.append((range(r0, min(r0 + MAIN_TY, rows)), columns,
                              updating))
    return grid, warps


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # its run sits behind __main__
    return module


@pytest.mark.parametrize("rows, cols", BLOCKS)
def test_partition_covers_every_cell_once(rows, cols):
    grid, warps = sw_main_partition(rows, cols)
    count = np.zeros((rows, cols), dtype=np.int64)
    for r, columns, updating in warps:
        for lane in updating:
            count[r.start:r.stop, columns[lane]] += 1
    assert (count == 1).all(), np.argwhere(count != 1)[:5]
    per_block = MAIN_WARPS * MAIN_COLS
    assert grid == (-(-cols // per_block), -(-rows // MAIN_TY))


@pytest.mark.parametrize("rows, cols", BLOCKS)
def test_neighbours_come_from_inside_the_warp(rows, cols):
    _, warps = sw_main_partition(rows, cols)
    for _, columns, updating in warps:
        assert len(columns) == 32
        for lane in updating:
            c = columns[lane]
            assert 0 <= c < cols
            assert 1 <= lane < 31
            assert columns[lane - 1] == c - 1
            assert columns[lane + 1] == c + 1


@pytest.mark.parametrize("name", ["MAIN_WARPS", "MAIN_COLS", "MAIN_TY"])
def test_constants_match_the_cuda_source(name):
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert found == [str(globals()[name])]


def test_check_blocks_cut_warps_and_strips_short():
    # the small sw_main checks end a strip and a warp part-way, so the
    # kernel's edge handling runs on the card
    smoke = _chip_smoke()
    assert smoke.SW_CHECK_CASES
    for _, (ny_l, nx_l), _, _, _ in smoke.SW_CHECK_CASES:
        rows, cols = ny_l + 4, nx_l + 4
        assert rows % MAIN_TY and cols % MAIN_COLS, (rows, cols)
        _, warps = sw_main_partition(rows, cols)
        assert len(warps[-1][2]) < MAIN_COLS
        assert len(warps[-1][0]) < MAIN_TY
