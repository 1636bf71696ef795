"""B11's decomposition (``luma_warp_kernel`` in csrc/xpsnr.cu) on the CPU: a
warp per 64x64 block (or per a few blocks down a column strip), each lane
on two adjacent columns read as one word where ``pair_loads`` allows, the
Laplacian split by rows (H of the centre row less V of the rows above and
below, each row's left and right neighbours taken from the next lanes, the
shuffles, and at the block's sides from the halo columns of lanes 0 and 31;
rows past the plane read clamped), the halo rows, and the per-lane partial
sums in the accumulator widths the kernel states, emulated in NumPy and
held against ``luma_stats_ref`` at the full uint16 range; the grid's warps
over (frame, strip, column); and the pair-load rule on both sides.  The
kernel itself is held against the plain version on the card, in
tests/test_torch_card.py and chip_smoke.py.

Tolerance: all integer, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from vszip_tpu_torch.kernels import xpsnr as kx

B = 64
U32 = 1 << 32


def _lane_cols(plane, y, x, pair):
    """Row y of (n, h, w) `plane` at each lane's columns x and x+1 (x:
    (nbw, 32)), 0 past the row or outside [0, h): one word of both where
    `pair` (little-endian, as the kernel's 2- or 4-byte load), else one
    element each.  Returns two (n, nbw, 32) arrays."""
    n, h, w = plane.shape
    zero = np.zeros((n,) + x.shape, dtype=np.int64)
    if not 0 <= y < h:
        return zero, zero.copy()
    row = plane[:, y]
    if pair:
        bits = 8 * plane.itemsize
        words = row.view({2: np.uint32, 1: np.uint16}[plane.itemsize]).astype(np.int64)
        word = np.where(x < w, words[:, np.minimum(x, w - 1) // 2], 0)
        return word & ((1 << bits) - 1), word >> bits
    r = row.astype(np.int64)
    a = np.where(x < w, r[:, np.minimum(x, w - 1)], 0)
    b = np.where(x + 1 < w, r[:, np.minimum(x + 1, w - 1)], 0)
    return a, b


def _halo(plane, y, x0):
    """Lane 0's column x0-1 and lane 31's x0+64 of row y, 0 where none:
    (n, nbw, 32), zero on the other lanes."""
    n, h, w = plane.shape
    out = np.zeros((n, len(x0), 32), dtype=np.int64)
    if 0 <= y < h:
        for lane, hx in ((0, x0 - 1), (31, x0 + B)):
            ok = (hx >= 0) & (hx < w)
            out[:, :, lane] = np.where(ok, plane[:, y, np.clip(hx, 0, w - 1)], 0)
    return out


def _part(a, b, halo):
    """A row's (ca, cb, ha, hb, va, vb) as the kernel's ``part``: l from the
    lane before (__shfl_up_sync of b), r from the lane after
    (__shfl_down_sync of a), lanes 0 and 31's from the halo; H = 12c -
    2(l + r) and V = 2c + l + r at each column."""
    left = np.roll(b, 1, axis=-1)
    right = np.roll(a, -1, axis=-1)
    left[..., 0] = halo[..., 0]
    right[..., 31] = halo[..., 31]
    return (a, b, 12 * a - 2 * (left + b), 12 * b - 2 * (a + right), 2 * a + left + b,
            2 * b + a + right)


def warp_emulation(org, rec, order, temporal, blocks_per_warp=1):
    """``luma_warp_kernel`` on (n, h, w) planes: every warp's walk down its
    strip, one row a step, the lanes' partials checked against the widths
    the kernel keeps them in, one warp sum per block.  Returns (sse, sa, ta)
    (n, nbh, nbw) int64 and the largest lane partials of sa and ta."""
    n, h, w = org.shape
    nbh, nbw = -(-h // B), -(-w // B)
    pair = kx.pair_loads(w, org.itemsize)
    x0 = np.arange(nbw) * B
    x = x0[:, None] + 2 * np.arange(32)[None, :]
    lap_a, lap_b = (x >= 1) & (x <= w - 2), x + 1 <= w - 2
    zeros = np.zeros_like(org)
    p1 = np.concatenate([zeros[:1], org[:-1]]) if temporal else zeros
    p2 = np.concatenate([zeros[:2], org[:-2]])[:n] if temporal and order == 2 else zeros
    out = np.zeros((3, n, nbh, nbw), dtype=np.int64)
    peak = [0, 0]

    def org_row(y):  # rows past the plane read clamped (the Laplacian leaves them out)
        y = min(max(y, 0), h - 1)
        return _part(*_lane_cols(org, y, x, pair), _halo(org, y, x0))

    for s in range(0, nbh, blocks_per_warp):
        y0, yend = s * B, min(h, (s + blocks_per_warp) * B)
        up, mid = org_row(y0 - 1), org_row(y0)
        sse = np.zeros((n, nbw, 32), dtype=np.int64)  # 64 bits a lane
        sa = np.zeros_like(sse)  # 32 bits a lane
        ta = np.zeros_like(sse)  # 32 bits a lane
        for y in range(y0, yend):
            dn = org_row(y + 1)
            ra, rb = _lane_cols(rec, y, x, pair)
            for c, r in ((mid[0], ra), (mid[1], rb)):
                sq = (c - r) ** 2
                assert sq.max() < U32  # one pixel's square: a u32 product
                sse += sq
            if 1 <= y <= h - 2:
                fa = mid[2] - up[4] - dn[4]  # H(y) - V(y-1) - V(y+1)
                fb = mid[3] - up[5] - dn[5]
                sa += np.where(lap_a, np.abs(fa), 0) + np.where(lap_b, np.abs(fb), 0)
            if temporal:
                for c, q1, q2 in zip(mid[:2], _lane_cols(p1, y, x, pair),
                                     _lane_cols(p2, y, x, pair)):
                    t = c - (q1 if order == 1 else 2 * q1) + (q2 if order == 2 else 0)
                    ta += np.abs(t)
            up, mid = mid, dn
            if y + 1 == yend or (y + 1) % B == 0:
                assert sa.max() < U32 and ta.max() < U32
                peak = [max(peak[0], int(sa.max())), max(peak[1], int(ta.max()))]
                blk = y // B
                for k, v in enumerate((sse, sa, ta)):
                    out[k, :, blk] = v.sum(-1)  # the warp's sum, in 64 bits
                sse[:], sa[:], ta[:] = 0, 0, 0
    return out, peak


def _ref(org, rec, order, temporal):
    got = kx.luma_stats_ref(torch.from_numpy(org), torch.from_numpy(rec), order, temporal)
    return np.stack([g.numpy() for g in got])


def _noise(shape, dtype, peak, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, peak, shape).astype(dtype) for _ in range(2))


def _extreme(shape, dtype, peak):
    """The accumulators' largest sums: org at peak - 1 on even rows and
    columns, 0 elsewhere, inverted on odd frames; rec the inverse."""
    n, h, w = shape
    dots = (np.arange(h)[:, None] % 2 == 0) & (np.arange(w)[None, :] % 2 == 0)
    odd = (np.arange(n) % 2 == 1)[:, None, None]
    org = np.where(dots ^ odd, peak - 1, 0)
    return org.astype(dtype), (peak - 1 - org).astype(dtype)


@pytest.mark.parametrize("dtype,peak", [(np.uint16, 65536), (np.uint16, 1024),
                                        (np.uint8, 256)], ids=str)
@pytest.mark.parametrize("shape", [(3, 130, 66), (2, 70, 131), (1, 3, 5), (3, 2, 2),
                                   (2, 65, 130), (1, 64, 64)], ids=str)
def test_warp_walk_equals_plain(shape, dtype, peak):
    org, rec = _noise(shape, dtype, peak, sum(shape))
    for order, temporal in ((1, True), (2, True), (1, False)):
        got, _ = warp_emulation(org, rec, order, temporal)
        np.testing.assert_array_equal(got, _ref(org, rec, order, temporal))


@pytest.mark.parametrize("blocks_per_warp", [2, 3])
def test_strips_of_several_blocks_equal_plain(blocks_per_warp):
    # a warp that walks on into the next block keeps its window: the rows
    # it crosses are the next block's halo rows
    org, rec = _noise((3, 200, 130), np.uint16, 65536, blocks_per_warp)
    for order in (1, 2):
        got, _ = warp_emulation(org, rec, order, True, blocks_per_warp)
        np.testing.assert_array_equal(got, _ref(org, rec, order, True))


@pytest.mark.parametrize("dtype,peak", [(np.uint16, 65536), (np.uint8, 256)], ids=str)
def test_accumulators_hold_the_largest_sums(dtype, peak):
    # at the stated bounds: a pixel's |Laplacian| reaches 12 (peak - 1) and
    # |org - 2 p1 + p2| 2 (peak - 1); a lane's 128 pixels a block stay in 32
    # bits, and the kernel still equals the plain version
    shape = (3, 128, 192)
    org, rec = _extreme(shape, dtype, peak)
    got, (sa_max, ta_max) = warp_emulation(org, rec, 2, True)
    np.testing.assert_array_equal(got, _ref(org, rec, 2, True))
    m = peak - 1
    lap = kx.lap_map(torch.from_numpy(org)).numpy()
    assert lap.max() == 12 * m
    assert np.abs(org[2].astype(np.int64) - 2 * org[1] + org[0]).max() == 2 * m
    assert 0 < sa_max <= 128 * 12 * m < U32 and 0 < ta_max <= 128 * 2 * m < U32


@pytest.mark.parametrize("blocks_per_warp", [1, 2, 4])
@pytest.mark.parametrize("n,nbh,nbw", [(32, 17, 30), (1, 1, 1), (3, 5, 2)])
def test_grid_takes_every_block_once(n, nbh, nbw, blocks_per_warp):
    # warp g: column g % nbw, strip (g // nbw) % strips, frame g // (nbw *
    # strips); the strips of a column cover its blocks once; frames in order
    strips = -(-nbh // blocks_per_warp)
    taken = []
    for g in range(n * strips * nbw):
        bx, s, i = g % nbw, g // nbw % strips, g // nbw // strips
        taken += [(i, by, bx) for by in range(s * blocks_per_warp,
                                              min(nbh, (s + 1) * blocks_per_warp))]
    assert taken == sorted(taken, key=lambda t: (t[0], t[1] // blocks_per_warp, t[2], t[1]))
    assert sorted(taken) == [(i, by, bx) for i in range(n) for by in range(nbh)
                             for bx in range(nbw)]


@pytest.mark.parametrize("w,elem,ptrs,pair", [(1920, 2, (0, 256), True), (130, 1, (0, 2), True),
                                              (131, 2, (0, 0), False), (130, 2, (2, 0), False),
                                              (130, 2, (4, 0), True), (130, 1, (1, 0), False)])
def test_pair_loads_need_even_rows_on_their_pairs(w, elem, ptrs, pair):
    assert kx.pair_loads(w, elem, *ptrs) is pair
