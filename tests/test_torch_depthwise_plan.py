"""The depthwise kernel's launch plan on the CPU (``dw_plan``): the route
each shape takes, every output covered once by the grid, the bands and the
runs, the halo tile's rows and columns (SAME borders included) and the
shared memory.  The kernel itself runs only on a card
(tests/test_torch_gpu.py::test_depthwise_conv_kernel_bit_exact); here its
index math, mirrored by ``_block_threads`` and ``_tile_box`` below, is held
against the plain conv by staging each block's tile from x with zeros
outside, as TMA does.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import counts, reset_counts
from repro_torch.kernels import depthwise_conv as dw
from repro_torch.kernels.ref import conv2d_same_nhwc, same_pads
from repro_torch.kernels.tiling import SMEM_BUDGET

# (x (B, H, W, CIN), COUT, stride, the slice dw_plan should pick):
# mobilenetv2-cifar's seven depthwise layers at 32 slots and its x2 case
MOBILENETV2 = [((32, 32, 32, 96), 96, 1, 96), ((32, 32, 32, 96), 96, 2, 96),
               ((32, 16, 16, 144), 144, 1, 48),
               ((32, 16, 16, 144), 144, 2, 48),
               ((32, 8, 8, 192), 192, 1, 96), ((32, 8, 8, 192), 192, 2, 96),
               ((32, 4, 4, 384), 384, 1, 128),
               ((32, 16, 16, 48), 96, 1, 96)]
# tile shapes off the main path: odd planes (SAME (1, 1) at stride 2), a
# multiplier at stride 2, a plane shorter than a run, ragged bands
TILE_OTHER = [((2, 9, 7, 32), 64, 2), ((3, 5, 6, 16), 16, 1),
              ((1, 3, 3, 128), 128, 2), ((2, 11, 13, 48), 48, 1),
              ((1, 8, 8, 16), 32, 2)]
# (x, COUT, KH, stride): the general route
GENERAL = [((3, 7, 9, 5), 5, 3, 2), ((2, 8, 8, 6), 12, 3, 1),
           ((2, 8, 8, 24), 24, 3, 1), ((1, 8, 8, 16), 48, 3, 1),
           ((1, 8, 8, 16), 16, 5, 1), ((1, 9, 9, 16), 16, 3, 3)]
TILE_SHAPES = [s[:3] for s in MOBILENETV2] + TILE_OTHER


def _block_threads(plan, OH, N, block):
    """``dw_tile_kernel``'s index math (csrc/depthwise_conv.cu; keep the
    two in step) for block ``(bx, by, bz)``, over its threads: arrays
    ``(oy, ox0, o0, active)``, a thread's output row, the first output
    column of its run (``plan.cols`` columns, those below OW stored), its
    first output channel (16 of them) and whether it works (a row past OH
    or a group past COUT does not)."""
    bx, by, _ = block
    groups = plan.slice // 16
    t = np.arange(plan.threads)
    g, y = t % groups, t // groups % plan.rows
    oy = by * plan.rows + y
    ox0 = t // (groups * plan.rows) * plan.cols
    o0 = (bx * groups + g) * 16
    return oy, ox0, o0, (oy < OH) & (o0 < N)


def _tile_box(plan, H, W, stride, block):
    """The input a ``dw_tile_kernel`` block's TMA load stages (the
    launcher's tensor map and the kernel's box origin): ``(rows, cols,
    chans)`` ranges of x's H, W and C; parts outside the tensor land as
    zeros, the SAME padding."""
    bx, by, _ = block
    (pt, _), (pl, _) = same_pads(H, W, 3, 3, stride)[0]
    box_c, box_w, box_h = plan.box
    iy0 = by * plan.rows * stride - pt
    return (range(iy0, iy0 + box_h), range(-pl, -pl + box_w),
            range(bx * box_c, (bx + 1) * box_c))


def _blocks(plan):
    return [(bx, by, bz) for bz in range(plan.grid[2])
            for by in range(plan.grid[1]) for bx in range(plan.grid[0])]


@pytest.mark.parametrize('case', MOBILENETV2, ids=str)
def test_dw_plan_takes_the_tile_route_at_mobilenetv2(case):
    """Every mobilenetv2-cifar layer (and the x2 case) takes the tile
    route with the slice that splits COUT's 16-byte groups evenly."""
    (B, H, W, C), n, stride, slice_ = case
    p = dw.dw_plan(B, H, W, C, n, 3, 3, stride)
    assert p.route == 'tile'
    assert p.slice == slice_ and n % p.slice == 0
    assert p.cols in dw.DW_COLS and p.threads <= dw.DW_MAX_THREADS


@pytest.mark.parametrize('case', GENERAL, ids=str)
def test_dw_plan_takes_the_general_route_elsewhere(case):
    """Odd channel counts, a multiplier of 3, a 5x5 kernel and stride 3
    go to the general kernel, one thread a pixel's four channels."""
    (B, H, W, C), n, k, stride = case
    p = dw.dw_plan(B, H, W, C, n, k, k, stride)
    (_, _), (oh, ow) = same_pads(H, W, k, k, stride)
    assert p.route == 'general'
    assert p.grid[0] * p.threads >= B * oh * ow * -(-n // 4)


@pytest.mark.parametrize('shape', TILE_SHAPES, ids=str)
def test_dw_plan_covers_every_output_once(shape):
    """The grid's slices, bands and runs cover every (b, oy, ox) and
    16-channel group exactly once; no thread works past OH or COUT."""
    (B, H, W, C), n, stride = shape
    p = dw.dw_plan(B, H, W, C, n, 3, 3, stride)
    (_, _), (oh, ow) = same_pads(H, W, 3, 3, stride)
    hits = np.zeros((B, oh, ow, n // 16), int)
    k = np.arange(p.cols)
    for bx, by, bz in _blocks(p):
        oy, ox0, o0, act = _block_threads(p, oh, n, (bx, by, bz))
        assert (oy[act] < oh).all() and (o0[act] < n).all()
        ox = ox0[act][:, None] + k[None, :]
        keep = ox < ow
        rows = np.broadcast_to(oy[act][:, None], ox.shape)[keep]
        grp = np.broadcast_to((o0[act] // 16)[:, None], ox.shape)[keep]
        np.add.at(hits, (bz, rows, ox[keep], grp), 1)
    assert (hits == 1).all()


@pytest.mark.parametrize('shape', TILE_SHAPES, ids=str)
def test_dw_tile_box_holds_every_tap_with_same_borders(shape):
    """Each block's box covers every tap of its outputs; staged from x
    with zeros outside the tensor (TMA's fill), the taps the kernel reads
    (tile row y*S + i, column ox*S + j, byte g*16/mult + k/mult) give the
    SAME conv's accumulator exactly, the (0, 1) border at stride 2 on an
    even plane and the (1, 1) one on an odd plane included.  Blocks of the
    first two images."""
    (B, H, W, C), n, stride = shape
    p = dw.dw_plan(B, H, W, C, n, 3, 3, stride)
    mult = n // C
    (_, _), (oh, ow) = same_pads(H, W, 3, 3, stride)
    rng = np.random.default_rng(sum(shape[0]) + n)
    b_used = min(B, 2)
    x = rng.integers(-128, 128, (b_used, H, W, C)).astype(np.int64)
    w = rng.integers(-128, 128, (3, 3, 1, n)).astype(np.int64)
    want = conv2d_same_nhwc(torch.from_numpy(x).double(),
                            torch.from_numpy(w).double(), stride,
                            groups=C).numpy()
    box_c, box_w, box_h = p.box
    for bx, by, bz in _blocks(p):
        if bz >= b_used:
            continue
        rows, cols, chans = _tile_box(p, H, W, stride, (bx, by, bz))
        assert (len(rows), len(cols), len(chans)) == (box_h, box_w, box_c)
        tile = np.zeros((box_h, box_w, box_c), np.int64)
        r_in = [r for r in rows if 0 <= r < H]
        c_in = [c for c in cols if 0 <= c < W]
        k_in = [k for k in chans if k < C]
        if r_in and c_in and k_in:
            tile[r_in[0] - rows.start:r_in[-1] - rows.start + 1,
                 c_in[0] - cols.start:c_in[-1] - cols.start + 1,
                 :len(k_in)] = x[bz, r_in[0]:r_in[-1] + 1,
                                 c_in[0]:c_in[-1] + 1, k_in[0]:k_in[-1] + 1]
        oy, ox0, o0, act = _block_threads(p, oh, n, (bx, by, bz))
        y = oy - by * p.rows
        for t in np.flatnonzero(act):
            ch = o0[t] + np.arange(16)
            byte = (o0[t] - bx * p.slice) // mult + np.arange(16) // mult
            for kcol in range(p.cols):
                ox = ox0[t] + kcol
                col0 = ox * stride             # the window's first column
                assert col0 + 2 < box_w and y[t] * stride + 2 < box_h
                if ox >= ow:
                    continue
                acc = sum(tile[y[t] * stride + i, col0 + j, byte] *
                          w[i, j, 0, ch] for i in range(3) for j in range(3))
                np.testing.assert_array_equal(acc, want[bz, oy[t], ox, ch])


@pytest.mark.parametrize('shape', TILE_SHAPES, ids=str)
def test_dw_plan_fits_the_card(shape):
    """Shared memory is the kernel's layout, within the budget, two blocks
    an SM at least; the box is the band's rows and the columns its runs
    reach, within TMA's 256; the band is the tallest of at most 256
    threads that keeps DW_MIN_BLOCKS blocks."""
    (B, H, W, C), n, stride = shape
    p = dw.dw_plan(B, H, W, C, n, 3, 3, stride)
    (_, _), (oh, ow) = same_pads(H, W, 3, 3, stride)
    assert p.smem_bytes == dw.dw_smem_bytes(*p.box) <= SMEM_BUDGET
    assert 2 * (p.smem_bytes + 1024) <= 228 * 1024     # an SM's, 1 KB a block
    assert max(p.box[1:]) <= dw.DW_MAX_BOX
    assert p.box[2] == (p.rows - 1) * stride + 3
    assert p.box[1] == (-(-ow // p.cols) * p.cols - 1) * stride + 3
    assert p.box[0] == p.slice // (n // C)
    lanes = p.slice // 16 * -(-ow // p.cols)
    assert p.threads == lanes * p.rows <= dw.DW_MAX_THREADS
    slices = p.grid[0]
    assert p.grid == (slices, -(-oh // p.rows), B)
    assert p.rows == 1 or slices * B * p.grid[1] >= dw.DW_MIN_BLOCKS
    assert p.rows >= oh or 2 * p.threads > dw.DW_MAX_THREADS or \
        slices * B * -(-oh // (2 * p.rows)) < dw.DW_MIN_BLOCKS


# (x, COUT, stride, groups, cols, rows): plans the tile kernel cannot run
REFUSED = [((32, 32, 32, 96), 96, 1, 8, 4, 8),     # 256+ threads
           ((32, 16, 16, 48), 96, 1, 3, 2, 1),     # a slice that splits
           ((32, 8, 8, 192), 192, 1, 9, 2, 1),     # over 128 channels
           ((32, 8, 8, 192), 192, 1, 4, 8, 1),     # a run not built
           ((1, 8, 600, 16), 16, 1, 1, 4, 1)]      # a box over 256 wide


@pytest.mark.parametrize('case', REFUSED, ids=str)
def test_dw_tile_plan_refuses_what_the_kernel_cannot_run(case):
    """dw_tile_plan returns None for the plans the C launcher would refuse:
    over 256 threads, a slice the multiplier splits or over 8 groups, a run
    the kernel is not built for, a box dimension over TMA's 256."""
    (B, H, W, C), n, stride, groups, cols, rows = case
    assert dw.dw_tile_plan(B, H, W, C, n, stride, groups=groups, cols=cols,
                           rows=rows) is None


def test_dw_route_follows_alignment_and_qmax():
    """The tile route needs x and w on 16 bytes and, for an int8 output, a
    whole-number qmax up to 127; anything else takes the general route."""
    x = torch.zeros((2, 8, 8, 32), dtype=torch.int8)
    w = torch.zeros((3, 3, 1, 32), dtype=torch.int8)
    assert dw.dw_route(x, w, 1) == 'tile'
    assert dw.dw_route(x, w, 2, 0.5, 127.0) == 'tile'
    assert dw.dw_route(x, w, 1, 0.5, 127.5) == 'general'
    assert dw.dw_route(x, w, 1, None, 127.5) == 'tile'
    buf = torch.zeros(x.numel() + 1, dtype=torch.int8)
    assert dw.dw_route(buf[1:].view(x.shape), w, 1) == 'general'
    wbuf = torch.zeros(w.numel() + 1, dtype=torch.int8)
    assert dw.dw_route(x, wbuf[1:].view(w.shape), 1) == 'general'
    assert dw.dw_route(x[..., :24].contiguous(),
                       torch.zeros((3, 3, 1, 24), dtype=torch.int8),
                       1) == 'general'


def test_reset_counts_zeroes_the_routes():
    dw.depthwise_conv.launches_by_route['tile'] += 3
    reset_counts()
    assert dw.depthwise_conv.launches_by_route == {'tile': 0, 'general': 0}
    assert counts()['depthwise_conv'] == {'launches': 0, 'plain_calls': 0}
