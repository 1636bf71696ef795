"""B7's decomposition (``clahe8_chunk_kernel`` in csrc/clahe.cu) on the CPU:
the kernel's split of a plane into the blocks' runs of (frame, band) items,
its 16-byte chunks with their byte tail, the per-column cell table a thread
fills for its chunk (each LUT's byte offset, to which the pixel's byte times
4 is or-ed), the cell row followed by additions, and its bit tricks
(LUT bytes as floats by 2^23, trunc by an add of 2^23 rounding towards
zero, the bytes packed into words), emulated in NumPy and plain torch and
held against ``clahe8_lookup_ref``; and the kernel's size rules on both
sides.  The kernel itself is held against the plain version on the card,
in tests/test_torch_card.py and chip_smoke.py.

Tolerance: exact.  The blend is strict f32, one rounding per operation, as
in the kernel (built without FMA contraction) and the plain version.
"""

import numpy as np
import pytest
import torch

from vszip_tpu_torch.kernels import clahe as kc
from vszip_tpu_torch.ops.clahe import _cells_8bit

TWO23 = np.float32(8388608.0)


def _inputs(shape, tiles_x, tiles_y, seed):
    """A plane, a random packed table and the op's fractions for it."""
    n, h, w = shape
    tile_h, tile_w = h // tiles_y, w // tiles_x
    (ty1r, _, tx1r, _), ya, xa = _cells_8bit(h, w, tile_h, tile_w, tiles_y, tiles_x)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    tab = rng.integers(-2**31, 2**31, (n, len(ty1r), len(tx1r) * 256), dtype=np.int64)
    return x, tab.astype(np.int32), ya, xa, tile_h, tile_w


def runs(n, h, by, blocks):
    """The launcher's split: at most one block per band of `by` rows, whole
    bands a block, each block a contiguous run of the n*h rows, cut into
    one (frame, first row, end row) segment per frame it reaches."""
    rows = n * h
    bands = -(-rows // by)
    blocks = min(blocks, bands)
    per = -(-bands // blocks) * by
    out = []
    for b in range(-(-rows // per)):
        r, r1, segs = b * per, min(rows, (b + 1) * per), []
        while r < r1:
            f, ys = divmod(r, h)
            ye = min(h, r1 - f * h)
            segs.append((f, ys, ye))
            r = f * h + ye
        out.append(segs)
    return out


def column_table(c0, w, tile_w, xa):
    """A thread's registers for the chunk at column c0: each column's cell
    as a byte offset (its cell times the 1 KB of a packed LUT) by one
    division and then additions, xa and 1 - xa; cell 0 and fractions 0 past
    the row."""
    twh = tile_w // 2
    cell, rem = divmod(c0 + twh, tile_w)
    col, fx = [], []
    for j in range(kc.CHUNK):
        inside = c0 + j < w
        col.append(cell * 1024 if inside else 0)
        fx.append(xa[0, c0 + twh + j] if inside else np.float32(0))
        rem += 1
        if rem == tile_w:
            rem, cell = 0, cell + 1
    fx = np.array(fx, dtype=np.float32)
    return np.array(col, dtype=np.int64), fx, np.float32(1) - fx


def chunk_words(row, c0, w, vec):
    """The chunk's 16 bytes as four little-endian words, as ``load_chunk``
    reads them: `vec` bytes an access, only accesses inside the row."""
    buf = np.zeros(kc.CHUNK, dtype=np.uint8)
    for i in range(0, kc.CHUNK, vec):
        if i < w - c0:
            got = row[c0 + i:c0 + i + vec]
            assert vec == 1 or len(got) == vec  # the row ends on an access's edge
            buf[i:i + len(got)] = got
    return buf.view("<u4")


def lut(word, k):
    """LUT byte k of packed words as floats: the bits of 2^23 + b, less 2^23."""
    bits = ((word >> np.uint32(8 * k)) & np.uint32(255)) | np.uint32(0x4B000000)
    return bits.view(np.float32) - TWO23


def trunc_low_byte(r):
    """The low byte of the bits of r + 2^23 rounded towards zero (exact in
    f64, then down to the f32 grid, whose step is 1 there)."""
    assert (r >= 0).all() and (r < 2**23).all()
    z = np.floor(r.astype(np.float64) + 2.0**23).astype(np.float32)
    return (z.view(np.uint32) & np.uint32(255)).astype(np.uint8)


def emulate(x, tab, ya, xa, tile_h, tile_w, blocks):
    """``clahe8_chunk_kernel`` on a grid of `blocks` blocks: each block's
    segments (each stages its frame's table), each thread's chunks and
    rows."""
    n, h, w = x.shape
    bx, by = kc.block_shape(w)
    vec = kc.chunk_vector(w)
    rx_n = tab.shape[2] // 256
    out = np.full(x.shape, -1, dtype=np.int32)
    for segs in runs(n, h, by, blocks):
        for f, ys, ye in segs:
            table = tab[f].reshape(-1).view(np.uint32)  # the frame's table, staged
            for tid in range(bx * by):
                tx, ty = tid % bx, tid // bx
                for cc in range(tx, -(-w // kc.CHUNK), bx):
                    c0 = cc * kc.CHUNK
                    col, fx, ofx = column_table(c0, w, tile_w, xa)
                    y = ys + ty
                    if y >= ye:
                        continue
                    py = y + tile_h // 2
                    cr, crem = divmod(py, tile_h)
                    offs = col + cr * rx_n * 1024  # the LUTs' byte offsets in the table
                    for y in range(y, ye, by):
                        fy = ya.reshape(-1)[py]
                        oya = np.float32(1) - fy
                        words = chunk_words(x[f, y], c0, w, vec)
                        v4 = words.view(np.uint8).astype(np.int64) * 4  # byte j times 4
                        assert not (offs & 0x3FC).any()  # so the or is the sum
                        word = table[(offs | v4) // 4]
                        t1 = lut(word, 0) * ofx + lut(word, 1) * fx
                        t2 = lut(word, 2) * ofx + lut(word, 3) * fx
                        res = t1 * oya + t2 * fy
                        q = trunc_low_byte(res + np.float32(0.5))
                        packed = q.view("<u4")  # four outputs a word, as the byte permutes
                        k = min(kc.CHUNK, w - c0)
                        assert (out[f, y, c0:c0 + k] == -1).all()
                        out[f, y, c0:c0 + k] = packed.view(np.uint8)[:k]
                        py += by
                        crem += by
                        while crem >= tile_h:
                            crem -= tile_h
                            offs = offs + rx_n * 1024
    return out


@pytest.mark.parametrize("shape,tiles,blocks", [
    ((2, 37, 77), (3, 2), 5),      # a byte tail (77 = 4 x 16 + 13), runs across frames
    ((1, 20, 300), (60, 4), 3),    # tiles of 5 columns: three or four cells a chunk; 4-byte words
    ((3, 9, 96), (2, 3), 2),       # 16-byte words, whole chunks
    ((2, 11, 40), (5, 1), 64),     # 8-byte words; more blocks than bands
    ((1, 6, 8200), (3, 2), 1),     # past 512 chunks: a thread takes two chunks of a row
], ids=str)
def test_chunks_equal_plain(shape, tiles, blocks):
    x, tab, ya, xa, th, tw = _inputs(shape, *tiles, seed=sum(shape))
    got = emulate(x, tab, ya, xa, th, tw, blocks)
    want = kc.clahe8_lookup_ref(torch.from_numpy(x), torch.from_numpy(tab),
                                torch.from_numpy(ya), torch.from_numpy(xa), th, tw)
    assert (got >= 0).all()
    np.testing.assert_array_equal(got.astype(np.uint8), want.numpy())


@pytest.mark.parametrize("tile_w", [1, 2, 5, 7, 15, 16, 17, 640])
@pytest.mark.parametrize("w", [13, 77, 300, 1920])
def test_column_table_is_the_division(tile_w, w):
    # the cell offsets by additions equal (px // tile_w) * 1024 at every
    # column, the fractions are xa and 1 - xa rounded once, as the plain
    # version's oxa
    twh = tile_w // 2
    rx_n = -(-(w + twh) // tile_w)
    xa = np.random.default_rng(w + tile_w).random((1, rx_n * tile_w)).astype(np.float32)
    for c0 in range(0, w, kc.CHUNK):
        col, fx, ofx = column_table(c0, w, tile_w, xa)
        c = np.arange(c0, min(w, c0 + kc.CHUNK))
        k = len(c)
        np.testing.assert_array_equal(col[:k], (c + twh) // tile_w * 1024)
        np.testing.assert_array_equal(fx[:k], xa[0, c + twh])
        np.testing.assert_array_equal(ofx[:k], np.float32(1) - xa[0, c + twh])
        assert (col[k:] == 0).all()


def test_float_tricks_are_exact():
    # every byte value through the 2^23 trick, and trunc(r + 0.5) through
    # the round-towards-zero add over [0.5, 256) and its float neighbours
    words = np.arange(256, dtype=np.uint32) * np.uint32(0x01010101)
    for k in range(4):
        np.testing.assert_array_equal(lut(words, k), np.arange(256, dtype=np.float32))
    r = np.linspace(0.0, 255.0, 200001, dtype=np.float32)
    r = np.concatenate([r, np.nextafter(r, np.float32(0)), np.nextafter(r, np.float32(300)),
                        np.arange(256, dtype=np.float32)])
    r = r[r >= 0] + np.float32(0.5)
    np.testing.assert_array_equal(trunc_low_byte(r), np.trunc(r).astype(np.int64) & 255)


@pytest.mark.parametrize("n,h,by,blocks", [(64, 1080, 4, 132), (64, 1080, 4, 396),
                                           (3, 7, 32, 9), (1, 1, 4, 4), (5, 100, 3, 7),
                                           (2, 540, 8, 1000)])
def test_runs_take_every_row_once(n, h, by, blocks):
    # each block a contiguous run of whole bands (the last one ragged), every
    # row once; at the bench's shape (64 frames of 1080p, 120 x 4 threads, a
    # block or three an SM) a block stages one or two frames' tables
    got = runs(n, h, by, blocks)
    rows = [f * h + y for segs in got for f, ys, ye in segs for y in range(ys, ye)]
    assert rows == list(range(n * h))
    lengths = [sum(ye - ys for f, ys, ye in segs) for segs in got]
    assert all(k == lengths[0] and k % by == 0 for k in lengths[:-1]) and len(got) <= blocks
    if (n, h) == (64, 1080):
        assert max(len(segs) for segs in got) == 2


@pytest.mark.parametrize("w,shape", [(1920, (120, 4)), (960, (60, 8)), (1936, (121, 1)),
                                     (16, (1, 32)), (1, (1, 32)), (300, (19, 5)),
                                     (8192, (512, 1)), (9000, (512, 1))])
def test_block_shape_leaves_fewest_lanes_idle(w, shape):
    # all the row's chunks up to 512 threads across; of the row counts that
    # fit, the one whose last warp idles the smallest share, the smallest such
    bx, by = kc.block_shape(w)
    assert (bx, by) == shape and bx * by <= kc.MAX_THREADS
    idle = [(-(-bx * k // 32) * 32 - bx * k) / (-(-bx * k // 32) * 32)
            for k in range(1, kc.MAX_THREADS // bx + 1)]
    assert idle[by - 1] == min(idle) and min(idle) not in idle[:by - 1]


@pytest.mark.parametrize("cells,on_chip", [((4, 4), True), ((9, 9), True), ((8, 12), True),
                                           ((10, 10), False), ((17, 17), False),
                                           ((41, 61), False)])
def test_table_goes_to_shared_memory_up_to_96_kb(cells, on_chip):
    # 3x3 tiles at 1080p: 16 KB; 8x8: 81 KB; 96 KB exactly (8 x 12 cells)
    # still fits; 10x10 cells and more read from device memory
    assert kc.table_on_chip(*cells) is on_chip
    assert (cells[0] * cells[1] * 1024 <= 96 * 1024) is on_chip


@pytest.mark.parametrize("w,ptrs,vec", [(1920, (0, 256), 16), (1000, (0, 0), 8), (300, (0,), 4),
                                        (77, (0,), 1), (1920, (8, 0), 8), (1920, (4, 0), 4),
                                        (1920, (0, 1), 1), (13, (0,), 1)])
def test_chunk_vector_fits_width_and_planes(w, ptrs, vec):
    assert kc.chunk_vector(w, *ptrs) == vec
