"""B12's decomposition (``chroma_strip_kernel`` and ``chroma_block_kernel``
in csrc/xpsnr.cu) on the CPU: each lane's ``lane_columns`` adjacent columns
of a row as the kernel loads them (one 8-byte word where ``wide_loads``
allows, else one element a column; 0 past the row), the lane sums at the
widths the kernel states (uint16 squares in 64 bits, uint8 ones a row at a
time in 32 bits), the segmented ``__shfl_xor_sync`` reduction over a
block's ``strip_group`` lanes, the grid's walk over (plane, frame, block-row
strip, column strip) with the first lane of each group writing, and the
block path (a warp per block, lanes striding its columns), emulated in
NumPy and held against ``chroma_sse_ref``; and the two-plane plain version
against the one-plane one.  The kernels themselves are held against the
plain versions on the card, in tests/test_torch_card.py and chip_smoke.py.

Tolerance: all integer, so every comparison is exact.
"""

import re

import numpy as np
import pytest
import torch

from vszip_tpu_torch import _build
from vszip_tpu_torch.kernels import xpsnr as kx

# kStripRows: block rows a warp walks down its strip, as the source sets it
STRIP_ROWS = int(re.search(r"constexpr int kStripRows = (\d+);",
                           _build.source("xpsnr").read_text()).group(1))
U19, U32 = 1 << 19, 1 << 32
SHAPES = [(3, 70, 131), (2, 67, 256), (1, 40, 96), (2, 33, 130), (1, 5, 9)]
BLOCKS = [(32, 32), (64, 32), (16, 16), (64, 64), (32, 64), (8, 16), (3, 7)]
DTYPES = [(np.uint8, 256), (np.uint16, 1024), (np.uint16, 65536)]


def _ceil(a, b):
    return -(-a // b)


def lane_words(plane, lanes, wide):
    """Each lane's columns of every row of (n, h, w) `plane` as one 8-byte
    word (element c at bit 8 * itemsize * c), for `lanes` lanes from column
    0: the row's bytes read 8 at a time where `wide`, else one element a
    column packed; 0 past the row.  (n, h, lanes) uint64."""
    n, h, w = plane.shape
    cols = kx.lane_columns(plane.itemsize)
    x = np.arange(lanes) * cols
    if wide:
        assert w % cols == 0
        words = np.ascontiguousarray(plane).view(np.uint64)  # (n, h, w / cols)
        return np.where(x < w, words[..., np.minimum(x // cols, words.shape[-1] - 1)],
                        np.uint64(0))
    out = np.zeros((n, h, lanes), dtype=np.uint64)
    for c in range(cols):
        col = np.where(x + c < w, plane[..., np.minimum(x + c, w - 1)], 0).astype(np.uint64)
        out |= col << np.uint64(8 * plane.itemsize * c)
    return out


def lane_sse(wo, wr, itemsize):
    """``lane_sse``: a lane's squared differences of one row from its two
    words, exact at the kernel's widths.  (n, h, lanes) int64."""
    bits = 8 * itemsize
    mask = np.uint64((1 << bits) - 1)
    acc = np.zeros(wo.shape, dtype=np.int64)
    row = np.zeros(wo.shape, dtype=np.int64)  # uint8: the row's sum in 32 bits
    for c in range(64 // bits):
        s = np.uint64(bits * c)
        d = ((wo >> s) & mask).astype(np.int64) - ((wr >> s) & mask).astype(np.int64)
        sq = d * d
        assert sq.max() < U32  # a 32x32->64 multiply-add's product
        if itemsize == 2:
            acc += sq
        else:
            row += sq
    assert row.max() < U19  # eight uint8 squares
    return acc + row


def butterfly(acc, group):
    """``__shfl_xor_sync`` over lanes (last axis, 32 a warp) in groups of
    `group`: every lane of a group ends with the group's sum."""
    lane = np.arange(acc.shape[-1])
    m = group // 2
    while m:
        acc = acc + acc[..., lane ^ m]
        m //= 2
    return acc


def strip_emulation(orgs, recs, by, bx, wide):
    """``chroma_strip_kernel`` on the pairs of (n, h, w) planes: (planes, n,
    nbh, nbw) int64, every block written once by the grid's warps in order."""
    n, h, w = orgs[0].shape
    group = kx.strip_group(bx, orgs[0].itemsize)
    assert group
    per = 32 // group
    nbh, nbw = _ceil(h, by), _ceil(w, bx)
    sx, sy = _ceil(nbw, per), _ceil(nbh, STRIP_ROWS)
    # each plane's lanes: block-row sums of their rows (rows past the plane
    # load nothing), then reduced within each group
    reduced = []
    for o, r in zip(orgs, recs):
        rows = lane_sse(lane_words(o, 32 * sx, wide), lane_words(r, 32 * sx, wide), o.itemsize)
        rows = np.pad(rows, ((0, 0), (0, nbh * by - h), (0, 0)))
        acc = rows.reshape(n, nbh, by, sx, 32).sum(2)  # (n, nbh, sx, 32) int64
        reduced.append(butterfly(acc, group))
    out = np.full((len(orgs), n, nbh, nbw), -1, dtype=np.int64)
    lane = np.arange(32)
    for g in range(len(orgs) * n * sy * sx):
        cs, s, i, p = g % sx, g // sx % sy, g // sx // sy % n, g // sx // sy // n
        bxi = cs * per + lane // group
        lead = (lane % group == 0) & (bxi < nbw)
        for b in range(s * STRIP_ROWS, min(nbh, (s + 1) * STRIP_ROWS)):
            assert (out[p, i, b, bxi[lead]] == -1).all()  # written once
            out[p, i, b, bxi[lead]] = reduced[p][i, b, cs, lane[lead]]
    return out


def block_emulation(orgs, recs, by, bx):
    """``chroma_block_kernel``: warp g on block g of the (planes, n, nbh,
    nbw) output, lane l on the block's columns l, l + 32, ..., one warp
    reduction."""
    n, h, w = orgs[0].shape
    nbh, nbw = _ceil(h, by), _ceil(w, bx)
    out = []
    for o, r in zip(orgs, recs):
        d = o.astype(np.int64) - r.astype(np.int64)
        sq = np.pad(d * d, ((0, 0), (0, nbh * by - h), (0, nbw * bx - w)))
        sq = sq.reshape(n, nbh, by, nbw, bx).sum(2)  # (n, nbh, nbw, bx)
        sq = np.pad(sq, ((0, 0), (0, 0), (0, 0), (0, -bx % 32)))
        lanes = sq.reshape(n, nbh, nbw, -1, 32).sum(3)  # lane l's columns
        out.append(butterfly(lanes, 32)[..., 0])  # lane 0 writes
    return np.stack(out)


def emulation(orgs, recs, by, bx, offsets=(0, 0, 0, 0)):
    """The launch: the strip path where the block fits a lane group, 8-byte
    loads where ``wide_loads`` allows for planes at byte `offsets` from an
    8-byte boundary; else the block path."""
    w, elem = orgs[0].shape[2], orgs[0].itemsize
    if kx.strip_group(bx, elem):
        wide = kx.wide_loads(w, elem, *offsets[:2 * len(orgs)])
        return strip_emulation(orgs, recs, by, bx, wide)
    return block_emulation(orgs, recs, by, bx)


def _ref(orgs, recs, by, bx):
    return np.stack([kx.chroma_sse_ref(torch.from_numpy(o), torch.from_numpy(r), by, bx).numpy()
                     for o, r in zip(orgs, recs)])


def _noise(shape, dtype, peak, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, peak, shape).astype(dtype) for _ in range(4)]


@pytest.mark.parametrize("dtype,peak", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_launch_equals_plain(shape, dtype, peak):
    ou, ru, ov, rv = _noise(shape, dtype, peak, sum(shape))
    for by, bx in BLOCKS:
        got = emulation((ou, ov), (ru, rv), by, bx)
        np.testing.assert_array_equal(got, _ref((ou, ov), (ru, rv), by, bx))
        got = emulation((ou,), (ru,), by, bx)
        np.testing.assert_array_equal(got, _ref((ou,), (ru,), by, bx))


@pytest.mark.parametrize("dtype,peak", DTYPES, ids=str)
@pytest.mark.parametrize("by,bx", BLOCKS, ids=str)
def test_both_load_widths_equal_plain(by, bx, dtype, peak):
    # an even row: 8-byte loads with the planes on 8 bytes, element loads
    # with a plane off them; the words are the same
    shape = (2, 37, 128)
    ou, ru, ov, rv = _noise(shape, dtype, peak, by * bx)
    want = _ref((ou, ov), (ru, rv), by, bx)
    for offsets in ((0, 0, 0, 0), (0, 0, 2, 0)):
        np.testing.assert_array_equal(emulation((ou, ov), (ru, rv), by, bx, offsets), want)
    for wide in (True, False):
        assert (lane_words(ou, 40, wide) == lane_words(ou, 40, not wide)).all()


@pytest.mark.parametrize("dtype,peak", DTYPES, ids=str)
def test_extreme_differences_stay_exact(dtype, peak):
    # org at peak - 1 and rec at 0 everywhere: every square at its largest
    shape = (2, 130, 256)
    org = np.full(shape, peak - 1, dtype=dtype)
    rec = np.zeros(shape, dtype=dtype)
    for by, bx in BLOCKS + [(1080, 1920)]:
        got = emulation((org, org), (rec, rec), by, bx)
        np.testing.assert_array_equal(got, _ref((org, org), (rec, rec), by, bx))
        assert got[0, 0, 0, 0] == min(by, 130) * min(bx, 256) * (peak - 1) ** 2


@pytest.mark.parametrize("dtype,peak", DTYPES[::2], ids=str)
def test_two_plane_plain_version_stacks_the_one_plane_one(dtype, peak):
    planes = [torch.from_numpy(p) for p in _noise((3, 41, 77), dtype, peak, 3)]
    for by, bx in BLOCKS:
        uv = kx.chroma_sse_uv_ref(*planes, by, bx)
        assert uv.dtype == torch.float64 and uv.shape[0] == 2
        assert torch.equal(uv[0], kx.chroma_sse_ref(planes[0], planes[1], by, bx))
        assert torch.equal(uv[1], kx.chroma_sse_ref(planes[2], planes[3], by, bx))
        # on the CPU the wrappers are their plain versions
        assert torch.equal(kx.chroma_sse_uv(*planes, by, bx), uv)
        assert torch.equal(kx.chroma_sse(planes[2], planes[3], by, bx), uv[1])


@pytest.mark.parametrize("bx,elem,group", [(32, 2, 8), (64, 2, 16), (16, 2, 4), (128, 2, 32),
                                           (4, 2, 1), (256, 2, 0), (12, 2, 0), (7, 2, 0),
                                           (2, 2, 0), (32, 1, 4), (16, 1, 2), (64, 1, 8),
                                           (8, 1, 1), (256, 1, 32), (512, 1, 0), (24, 1, 0),
                                           (4, 1, 0)])
def test_strip_group_takes_power_of_two_lane_groups(bx, elem, group):
    assert kx.strip_group(bx, elem) == group


@pytest.mark.parametrize("w,elem,ptrs,wide", [(960, 2, (0, 256, 8, 1024), True),
                                              (960, 1, (0, 8), True), (962, 2, (0, 0), False),
                                              (131, 2, (0, 0), False), (964, 1, (0, 0), False),
                                              (960, 2, (0, 0, 4, 0), False),
                                              (960, 1, (0, 1), False)])
def test_wide_loads_need_whole_lanes_on_eight_bytes(w, elem, ptrs, wide):
    assert kx.wide_loads(w, elem, *ptrs) is wide


@pytest.mark.parametrize("n,nbh,nbw,group", [(32, 17, 30, 8), (1, 1, 1, 8), (3, 5, 9, 4),
                                             (2, 3, 3, 32), (2, 4, 7, 1)])
def test_grid_takes_every_block_once(n, nbh, nbw, group):
    # warp g: column strip g % sx, block-row strip (g // sx) % sy, frame
    # (g // (sx * sy)) % n, plane g // (sx * sy * n); lead lanes of its groups
    per = 32 // group
    sx, sy = _ceil(nbw, per), _ceil(nbh, STRIP_ROWS)
    taken = []
    for g in range(2 * n * sy * sx):
        cs, s, i, p = g % sx, g // sx % sy, g // sx // sy % n, g // sx // sy // n
        for b in range(s * STRIP_ROWS, min(nbh, (s + 1) * STRIP_ROWS)):
            taken += [(p, i, b, cs * per + k) for k in range(per) if cs * per + k < nbw]
    # in order of plane, frame, strip of block rows, column, block row
    assert taken == sorted(taken, key=lambda t: (t[0], t[1], t[2] // STRIP_ROWS, t[3], t[2]))
    assert sorted(taken) == [(p, i, b, x) for p in range(2) for i in range(n)
                             for b in range(nbh) for x in range(nbw)]
