"""B1 in one launch (``ct_blur_kernel`` in csrc/boxblur.cu) on the CPU: its
band plan and its vertical walk, emulated in NumPy step for step (each
band's rows from its own input rows under the hybrid mirror, the ring of
input rows filled by groups of copies ahead of the group that reads them,
every read checked against the row the slot must hold and its copy having
landed), then the horizontal pass of the plain version, against the plain
``ct_blur_int_ref``; the shape rule ``ct_blur_fused_shape`` at its edges; and
``ct_blur_bands``' bands, halo rows and waves.  The kernel itself is held
against the plain version on the card, in tests/test_torch_card.py.

Tolerance: all integer, so every comparison is bit-exact.
"""

import numpy as np
import pytest
import torch

from vszip_tpu_torch import _build
from vszip_tpu_torch.kernels import boxblur as kt


def _band_walk(x, radius, y0, y1, s0, s1, ring_rows):
    """One band's quantised vertical rows y0 .. y1-1 of the frames `x` (n, h,
    w) as ``ct_blur_kernel``'s threads compute them: the input rows s0 .. s1
    enter a ring of `ring_rows` slots in copy groups (the warm-up rows, then
    CT_FUSED_WARPS rows a group), CT_FUSED_AHEAD + 1 groups issued ahead and
    each later one after a group's vertical phase; a group lands when it is
    waited for, and each read must find its row landed in its slot (except
    the updates after the band's last row, whose sums the kernel never
    uses)."""
    n, h, w = x.shape
    r, k, R = radius, 2 * radius + 1, ring_rows
    G, D = kt.CT_FUSED_WARPS, kt.CT_FUSED_AHEAD
    m = kt.ct_blur_multiplier(r)
    top = y0 == 0
    wu = y0 + r + 1 - s0
    ring = np.zeros((R, n, w), dtype=np.int64)
    held = [None] * R  # (row, landed)
    groups = []
    state = {"row": s0, "slot": 0}

    def copy(rows):
        slots = []
        for _ in range(rows):
            if state["row"] <= s1:
                ring[state["slot"]] = x[:, state["row"]]
                held[state["slot"]] = (state["row"], False)
                slots.append(state["slot"])
            state["row"] += 1
            state["slot"] = (state["slot"] + 1) % R
        groups.append(slots)

    def wait(k):
        for s in groups[k]:
            held[s] = (held[s][0], True)

    def read(slot, row, used=True):
        assert 0 <= slot < R
        if used:
            assert held[slot] == (row, True), (slot, row, held[slot])
        return ring[slot]

    copy(wu)
    for _ in range(D + 1):
        copy(G)
    wait(0)
    wx = np.zeros((n, w), dtype=np.int64)
    for s in range(wu):
        wx += (2 if top and s > 0 else 1) * read(s, s0 + s)
    out = np.zeros((n, y1 - y0, w), dtype=np.int64)
    ls, ts = wu, (R - r if top else 0)
    for g, Y in enumerate(range(y0, y1, G)):
        wait(g + 1)
        for j in range(G):  # rows past y1 too: their sums are never used
            y = Y + j
            if y < y1:
                out[:, y - y0] = ((2 * wx + k) * m) >> 32
            lead_row = y + r + 1 if y + r + 1 <= h - 1 else y
            trail_row = y - r if y >= r else r - y
            if Y >= r and Y + G + r <= h - 1:
                lslot, tslot = ls, ts          # the steady group: no row mirrors
            else:
                lslot = ls if y + r + 1 <= h - 1 else (y - s0) % R
                tslot = ts if y >= r else (r - y - s0) % R
            used = y + 1 < y1
            lead = read(lslot, lead_row, used)
            trail = read(tslot, trail_row, used)
            wx = (wx + lead - trail) & 0xFFFFFFFF
            ls, ts = (ls + 1) % R, (ts + 1) % R
        copy(G)  # after the vertical phase, into this group's trail slots
    return out


def _fused(x, radius, bands):
    """``ct_blur_kernel`` on `x` (n, h, w): each band's vertical walk, then
    the horizontal pass (plain, ``h_fixed_ref``) of its rows."""
    n, h, w = x.shape
    shape = kt.ct_blur_fused_shape(w, radius, x.dtype.itemsize)
    assert shape is not None
    ring_rows = shape[2]
    v = np.full((n, h, w), -1, dtype=np.int64)
    for y0, y1, s0, s1 in kt.ct_blur_band_rows(h, radius, bands):
        v[:, y0:y1] = _band_walk(x.astype(np.int64), radius, y0, y1, s0, s1, ring_rows)
    assert (v >= 0).all() and (v <= np.iinfo(x.dtype).max).all()
    return kt.h_fixed_ref(torch.from_numpy(v.astype(x.dtype)), radius).numpy()


# heights from 2r + 1, around the groups of 8 and the ring, bands ending a
# group early; every band count the plan allows at the smaller heights
CASES = [(1, 3, 1), (1, 4, 2), (1, 17, 8), (2, 5, 1), (2, 40, 13), (3, 7, 1), (3, 100, 25),
         (5, 11, 1), (5, 64, 10), (7, 15, 1), (7, 45, 5), (13, 27, 1), (13, 28, 2), (13, 55, 3),
         (13, 97, 2), (13, 270, 5), (16, 33, 1), (19, 120, 3), (22, 45, 1), (22, 46, 2),
         (22, 300, 6)]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=lambda d: d.__name__)
@pytest.mark.parametrize("radius,h,bands", CASES, ids=str)
def test_band_walk_matches_plain(radius, h, bands, dtype):
    assert bands <= h // (radius + 1)
    rng = np.random.default_rng(radius * 1000 + h * 10 + bands)
    w = 2 * radius + 3
    x = rng.integers(0, np.iinfo(dtype).max + 1, (2, h, w), dtype=dtype)
    want = kt.ct_blur_int_ref(torch.from_numpy(x), radius).numpy()
    np.testing.assert_array_equal(_fused(x, radius, bands), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=lambda d: d.__name__)
@pytest.mark.parametrize("radius,h", [(1, 1080), (13, 540), (22, 1080)], ids=str)
def test_band_walk_matches_plain_at_the_extremes(radius, h, dtype):
    """All-0 and all-max frames, the bands of 64 frames on 132 blocks."""
    bands = kt.ct_blur_bands(64, h, radius, 132)
    for v in (0, np.iinfo(dtype).max):
        x = np.full((1, h, radius + 1), v, dtype=dtype)
        want = kt.ct_blur_int_ref(torch.from_numpy(x), radius).numpy()
        np.testing.assert_array_equal(_fused(x, radius, bands), want)


@pytest.mark.parametrize("h,radius", [(1080, 13), (540, 13), (1080, 22), (540, 22), (1080, 1),
                                      (2160, 13), (3, 1), (45, 22), (1079, 7)], ids=str)
@pytest.mark.parametrize("n,blocks", [(64, 132), (1, 132), (3, 264), (64, 1), (200, 132)],
                         ids=str)
def test_bands_cover_every_row_once_within_the_halo_share(h, radius, n, blocks):
    bands = kt.ct_blur_bands(n, h, radius, blocks)
    rows = kt.ct_blur_band_rows(h, radius, bands)
    assert [y for y0, y1, _, _ in rows for y in range(y0, y1)] == list(range(h))
    for y0, y1, s0, s1 in rows:
        assert y1 - y0 >= radius + 1
        assert s0 == (0 if y0 == 0 else y0 - radius) and s1 == min(y1 - 1 + radius, h - 1)
    halo = sum(s1 + 1 - s0 for _, _, s0, s1 in rows) - h
    assert halo == (bands - 1) * 2 * radius
    assert halo <= kt.CT_HALO_SHARE * h


@pytest.mark.parametrize("h", [1080, 540])
def test_bands_at_1080p_fill_their_last_wave(h):
    """64 frames of 1080p luma or chroma on the 132 SMs of an H100, one
    block an SM: 2 bands a frame, one wave of 128 blocks (97%), 2.4% and
    4.8% of the rows read twice."""
    bands = kt.ct_blur_bands(64, h, 13, 132)
    blocks = 64 * bands
    assert bands == 2 and blocks / (132 * -(-blocks // 132)) >= 0.9
    assert (bands - 1) * 2 * 13 / h <= kt.CT_HALO_SHARE


def _widest(radius, elem_bytes):
    w = radius
    while kt.ct_blur_fused_shape(w + 1, radius, elem_bytes) is not None:
        w += 1
    return w


@pytest.mark.parametrize("w,radius,elem_bytes,shape", [
    # the benchmark's planes: luma in 3 chunks a lane, chroma in 2
    (1920, 13, 2, (28, 3, 43, 2000, 229152)), (960, 13, 2, (28, 2, 43, 1040, 115872)),
    (1920, 13, 1, (28, 3, 43, 2000, 114592)), (1, 1, 2, (4, 1, 19, 32, 1360)),
    # two chunks a vertical thread: 2048 uint16 samples at r 1
    (2048, 1, 2, (4, 22, 19, 2080, 144416)), (2049, 1, 2, None),
    # the shared memory of the ring and the two sets of row buffers (uint16)
    (1947, 13, 2, (28, 3, 43, 2016, 232416)), (1948, 13, 2, None), (1920, 14, 2, None),
    (1480, 22, 2, (48, 2, 61, 1616, 232304)), (1481, 22, 2, None),
    # the register pass's rule (uint8: 2566 at r 13)
    (2566, 13, 1, (28, 3, 43, 2640, 153040)), (2567, 13, 1, None),
    # past the comptime path, past the row's width (the quirk)
    (1920, 23, 2, None), (100, 23, 1, None), (12, 13, 2, None),
    (13, 13, 2, (28, 1, 43, 96, 4480)),
], ids=str)
def test_fused_shape_at_its_edges(w, radius, elem_bytes, shape):
    assert kt.ct_blur_fused_shape(w, radius, elem_bytes) == shape
    if shape is not None:
        slots, chunks, ring, rowbuf, smem = shape
        assert kt.h_fixed_warp_shape(w, radius, 1)[:3] == (slots, kt.H_WARP_RUNS[
            [s for s, _ in kt.H_WARP_RUNS].index(slots)][1], chunks)
        assert smem <= _build.MAX_SMEM_BYTES and rowbuf % 16 == 0
        assert ring == 2 * radius + 1 + kt.CT_FUSED_WARPS * (kt.CT_FUSED_AHEAD + 1)


@pytest.mark.parametrize("radius,elem_bytes,widest", [(1, 2, 2048), (13, 2, 1947), (22, 2, 1480),
                                                      (1, 1, 2110), (13, 1, 2566),
                                                      (22, 1, 2836)], ids=str)
def test_fused_shape_takes_every_width_up_to_its_widest(radius, elem_bytes, widest):
    assert _widest(radius, elem_bytes) == widest
    assert all(kt.ct_blur_fused_shape(w, radius, elem_bytes) is not None
               for w in range(radius, widest + 1))
    assert kt.ct_blur_fused_shape(radius - 1, radius, elem_bytes) is None


@pytest.mark.parametrize("radius", range(1, kt.CT_MAX_RADIUS + 1))
def test_multiplier_on_every_numerator(radius):
    """``ct_blur_kernel``'s quantiser, the high word of (2W + k) * m, equals
    (2W + k) // (2k) for every column sum W of a uint16 (or uint8) plane."""
    k = 2 * radius + 1
    m = kt.ct_blur_multiplier(radius)
    num = 2 * np.arange(k * 65535 + 1, dtype=np.int64) + k
    assert m < 1 << 32 and num[-1] < 1 << 32
    np.testing.assert_array_equal((num * m) >> 32, num // (2 * k))
