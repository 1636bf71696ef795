"""``h_fixed``'s register design (``h_fixed_kernel<T, kSlots, kChunks>`` in
csrc/boxblur.cu, one warp a row) on the CPU: its walk emulated in NumPy step
for step (the row buffer with its mirrored margins and stale samples past
them, the lanes' runs of 2r + 1 samples in chunks of registers with idle
slots and chunks, the shuffles between lanes, the alternating forward and
backward slides, W(0) from lane l0's first run, the output's low 32 bits)
against the plain version ``h_fixed_ref``; and the shape rule
``h_fixed_warp_shape`` at its edges.  The kernel itself is held against the
plain version on the card, in tests/test_torch_card.py.

Tolerance: all integer, so every comparison is bit-exact.
"""

import numpy as np
import pytest
import torch

from vszip_tpu_torch.kernels import boxblur as kt

MASK = 0xFFFFFFFF


def _mirror_periodic(k, n):
    k %= 2 * n
    return k if k < n else 2 * n - 1 - k


def _warp_walk(x, radius, passes, seed=0):
    """``h_fixed_kernel<T, kSlots, kChunks>`` on the rows of `x` (rows, w):
    uint32 arithmetic kept in int64 and masked; lanes on axis 1.  Samples
    the kernel never writes (the buffer past the margins, idle chunks) start
    as noise, as stale shared memory and registers would."""
    rng = np.random.default_rng(seed)
    rows, w = x.shape
    bits = 8 * x.dtype.itemsize
    slots, chunks_max, chunks, l0, a = kt.h_fixed_warp_shape(w, radius, passes)
    r, n = radius, 2 * radius + 1
    padl = -(-a // 16) * 16
    buf = rng.integers(0, 1 << bits, (rows, 32 * chunks_max * slots + 64)).astype(np.int64)
    buf[:, padl:padl + w] = x
    pr = passes * r
    for j in range(2 * pr):
        u = -1 - j if j < pr else w + j - pr
        buf[:, padl + u] = buf[:, padl + _mirror_periodic(u, w)]
    c0 = chunks_max - chunks
    base = np.arange(32) * chunks * n - a + padl
    regs = rng.integers(0, 1 << bits, (rows, 32, chunks_max, slots)).astype(np.int64)
    for c in range(c0, chunks_max):
        for i in range(slots):
            regs[:, :, c, i] = buf[:, base + (c - c0) * n + i] if i < n else 0
    inv = ((1 << 32) + r) // (2 * r + 1)
    inv2 = inv >> 16

    def k0_of(w0):
        return (((w0 * inv + (1 << 31)) >> 16) - inv2 * w0) & MASK

    def out_bits(k0, wx):
        o = ((k0[:, None] + inv2 * wx) & MASK) >> 16
        return o & 0xFF if bits == 8 else o

    def shfl_down(v):  # lane 31 reads its own
        return np.concatenate([v[:, 1:], v[:, 31:]], axis=1)

    def shfl_up(v):  # lane 0 reads its own
        return np.concatenate([v[:, :1], v[:, :-1]], axis=1)

    for p in range(passes):
        if p % 2 == 0:
            wx = regs[:, :, c0].sum(axis=2) & MASK
            ends = shfl_down(regs[:, :, c0])
            k0 = k0_of(wx[:, l0])
            for c in range(c0, chunks_max):
                for i in range(slots):
                    lead = regs[:, :, c + 1, i] if c + 1 < chunks_max else ends[:, :, i]
                    o = out_bits(k0, wx)
                    wx = (wx + lead - regs[:, :, c, i]) & MASK
                    if i < n:
                        regs[:, :, c, i] = o
        else:
            first = regs[:, l0, c0]
            k0 = k0_of(2 * first[:, :r].sum(axis=1) + first[:, r])
            wx = regs[:, :, -1].sum(axis=2) & MASK
            ends = shfl_up(regs[:, :, -1])
            if c0 > 0:
                regs[:, :, c0 - 1] = ends
            for c in range(chunks_max - 1, c0 - 1, -1):
                for i in range(slots - 1, -1, -1):
                    trail = ends[:, :, i] if c == 0 else regs[:, :, c - 1, i]
                    o = out_bits(k0, wx)
                    wx = (wx + trail - regs[:, :, c, i]) & MASK
                    if i < n:
                        regs[:, :, c, i] = o
    shift = r if passes % 2 else 0
    for c in range(c0, chunks_max):
        for i in range(n):
            buf[:, base + (c - c0) * n + shift + i] = regs[:, :, c, i]
    return buf[:, padl:padl + w]


def _largest_w(radius, passes):
    w = radius
    while kt.h_fixed_in_registers(w + 1, radius, passes):
        w += 1
    return w


# every run of H_WARP_RUNS at its smallest and largest radius, the 1080p
# planes, the narrowest rows, widths at each run's capacity, passes 1-6
CASES = [(1920, 13, 5), (960, 13, 5), (1920, 13, 1), (960, 13, 1), (1920, 22, 1),
         (1920, 23, 1), (1, 1, 1), (2, 1, 4), (33, 2, 6), (77, 3, 3), (100, 4, 5),
         (300, 7, 2), (500, 8, 6), (129, 11, 3), (40, 12, 2), (13, 13, 2), (70, 14, 3),
         (640, 15, 4), (40, 20, 3), (23, 23, 1), (24, 16, 6)]
CASES += [(_largest_w(r, p), r, p) for r, p in ((1, 1), (2, 5), (7, 2), (8, 3), (13, 5),
                                                 (13, 1), (14, 2), (16, 1), (23, 6))]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=lambda d: d.__name__)
@pytest.mark.parametrize("w,radius,passes", CASES, ids=str)
def test_warp_walk_matches_plain(w, radius, passes, dtype):
    rng = np.random.default_rng(w * 100 + radius * 10 + passes)
    x = rng.integers(0, np.iinfo(dtype).max + 1, (3, w), dtype=dtype)
    want = kt.h_fixed_ref(torch.from_numpy(x)[None], radius, passes)[0].numpy()
    np.testing.assert_array_equal(_warp_walk(x, radius, passes), want)


@pytest.mark.parametrize("w,radius,passes,shape", [
    # the benchmark's planes: luma in 3 chunks, chroma in 2
    (1920, 13, 5, (28, 3, 3, 1, 94)), (960, 13, 5, (28, 3, 2, 1, 67)),
    (1920, 13, 1, (28, 3, 3, 0, 13)), (1920, 23, 1, (48, 2, 2, 0, 23)),
    # n = 2r + 1 picks the first run whose slots take it
    (100, 1, 1, (4, 22, 2, 0, 1)), (100, 2, 1, (8, 13, 1, 0, 2)),
    (100, 3, 1, (8, 13, 1, 0, 3)), (100, 4, 1, (16, 8, 1, 0, 4)),
    (100, 8, 1, (24, 4, 1, 0, 8)), (100, 12, 1, (28, 3, 1, 0, 12)),
    (100, 14, 1, (32, 3, 1, 0, 14)), (100, 16, 1, (48, 2, 1, 0, 16)),
    # past the runs, past the row's width (the quirk), past the capacity
    (1920, 24, 1, None), (10, 11, 1, None), (3840, 13, 1, None), (2567, 13, 1, None),
    (2566, 13, 1, (28, 3, 3, 0, 13)), (2434, 13, 5, None), (2433, 13, 5, (28, 3, 3, 1, 94)),
], ids=str)
def test_warp_shape_at_its_edges(w, radius, passes, shape):
    assert kt.h_fixed_warp_shape(w, radius, passes) == shape
    assert kt.h_fixed_in_registers(w, radius, passes) is (shape is not None)
