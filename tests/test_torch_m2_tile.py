"""B6 from shared-memory tiles (``m2_tile_kernel`` in csrc/deband.cu) on the
CPU: the kernel's staging of a tile of frame pairs at plane-clamped
coordinates and its reads of the four taps at unclamped tile indices,
emulated in plain torch, against ``deband_m2_center_ref``; its split of a
plane's (pair, tile) items over a persistent grid; the predicate that sends
a range past the tiles to ``m2_kernel``.  The kernel itself is held against
the plain version on the card, in tests/test_torch_card.py and
chip_smoke.py.

Tolerance: all integer, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from vszip_tpu_torch import _build
from vszip_tpu_torch.kernels import deband as kd
from vszip_tpu_torch.ops.deband import _mode_center

LIMIT = 50  # the largest range whose tiles fit a block's shared memory


def _m2_tile_emulation(x, key, blur_first, rmax, thr, y0, x0):
    """``m2_tile_kernel`` on the tile whose first output pixel is (y0, x0):
    each pair of frames staged as one tile of 32-bit positions at clamped
    coordinates (rows y0 - rmax .., columns x0 - pad ..; frame f low, f+1
    high, the last frame twice when N is odd), each pixel's key decoded into
    two tile offsets, the taps read at the centre's tile index plus and
    minus them and split back into the two frames.  Returns the pixels'
    (rows, columns) in the plane and their (N, P) centres."""
    n, h, w = x.shape
    rows, cols = kd.m2_tile_shape(rmax)
    pad = (cols - kd.M2_TILE_X) // 2
    yy = (torch.arange(rows) + y0 - rmax).clamp(0, h - 1)
    xx = (torch.arange(cols) + x0 - pad).clamp(0, w - 1)
    staged = x.to(torch.int64)[:, yy][:, :, xx].reshape(n, rows * cols)
    lo, hi = staged[0::2], staged[torch.arange(1, n + 1, 2).clamp(max=n - 1)]
    pairs = lo | hi << 16
    py, px = torch.meshgrid(torch.arange(y0, min(y0 + kd.M2_TILE_Y, h)),
                            torch.arange(x0, min(x0 + kd.M2_TILE_X, w)), indexing="ij")
    py, px = py.reshape(-1), px.reshape(-1)
    na = 2 * rmax + 1
    k = key[py, px]
    assert bool(((k >= 0) & (k < na * na)).all())
    v1, v2 = k // na - rmax, k % na - rmax
    ci = (py - y0 + rmax) * cols + pad + (px - x0)
    o1, o2 = v2 * cols + v1, v2 - v1 * cols
    assert int(max(o1.abs().max(), o2.abs().max())) < 1 << 15  # two int16 a pixel
    def frames(v):  # (pairs, P) 32-bit positions -> (N, P) samples
        return torch.stack([v & 0xffff, v >> 16], 1).reshape(-1, v.shape[1])[:n].to(torch.int32)

    c = frames(pairs[:, ci])
    taps = [frames(pairs[:, ci + o]) for o in (o1, -o1, o2, -o2)]
    return py, px, _mode_center(2, blur_first, True, c, *taps, thr, 0, 0)


@pytest.mark.parametrize("rmax", [0, 1, 15, LIMIT])
@pytest.mark.parametrize("shape", [(2, 150, 170), (1, 20, 30), (3, 64, 129)], ids=str)
def test_tile_staging_equals_plain_at_the_corners(shape, rmax):
    # tile origins at all four corners of the plane (the last ones partial),
    # keys over the whole alphabet so that taps past the edges clamp
    n, h, w = shape
    rng = np.random.default_rng(rmax * 7 + h)
    x = torch.from_numpy(rng.integers(0, 1 << 16, shape, dtype=np.uint16))
    na = 2 * rmax + 1
    key = torch.from_numpy(rng.integers(0, na * na, (h, w), dtype=np.int32))
    last_y = (h - 1) // kd.M2_TILE_Y * kd.M2_TILE_Y
    last_x = (w - 1) // kd.M2_TILE_X * kd.M2_TILE_X
    for bf in (True, False):
        want = kd.deband_m2_center_ref(x, key, bf, rmax, 12337)
        for y0, x0 in ((0, 0), (0, last_x), (last_y, 0), (last_y, last_x)):
            py, px, got = _m2_tile_emulation(x, key, bf, rmax, 12337, y0, x0)
            assert torch.equal(got, want[:, py, px]), (bf, y0, x0)


GROUP = 4  # csrc/deband.cu kM2Group: pairs of frames an item takes from one tile


@pytest.mark.parametrize("tiles,n,blocks", [(510, 64, 396), (135, 64, 396), (1, 1, 1),
                                            (3, 2, 7), (135, 63, 132), (7, 11, 5)], ids=str)
def test_persistent_grid_takes_every_pair_once(tiles, n, blocks):
    # block b of G takes items b, b + G, ... of the (group of GROUP pairs,
    # tile) items, tiles inner, and each item's pairs in turn: every (tile,
    # pair) once, blocks' item counts differ by at most one, and at each
    # step the blocks hold G consecutive items: the same few groups of
    # frames on neighbouring tiles
    pairs = (n + 1) // 2
    groups = -(-pairs // GROUP)
    total = tiles * groups
    g = min(blocks, total)
    items = [list(range(b, total, g)) for b in range(g)]
    taken = [(it % tiles, 2 * ((it // tiles) * GROUP + s)) for b in items for it in b
             for s in range(GROUP) if (it // tiles) * GROUP + s < pairs]
    assert sorted(taken) == sorted((t, 2 * p) for t in range(tiles) for p in range(pairs))
    sizes = {len(b) for b in items}
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    for j in range(min(sizes)):
        assert len({items[b][j] // tiles for b in range(g)}) <= g // tiles + 2


@pytest.mark.parametrize("rmax,on_chip", [(0, True), (1, True), (15, True), (LIMIT, True),
                                          (LIMIT + 1, False), (200, False)], ids=str)
def test_m2_takes_device_memory_taps_past_the_tiles(rmax, on_chip):
    # (64 + 2 rmax) x (64 + 2 pad) positions, pad = rmax rounded up to 8,
    # 8 bytes each (a tile of 32-bit pairs and two of 16-bit frames) within
    # 227 KB; past that the wrapper takes m2_kernel
    rows, cols = kd.m2_tile_shape(rmax)
    assert cols % 8 == 0 and cols >= kd.M2_TILE_X + 2 * rmax
    assert kd.m2_on_chip(rmax) is on_chip
    assert (rows * cols * 8 <= _build.MAX_SMEM_BYTES) is on_chip
