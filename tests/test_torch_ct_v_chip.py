"""B1's vertical stage on chip (``ct_v_chip`` in csrc/boxblur.cu) on the CPU:
its walk, emulated in plain torch step for step (the hybrid mirror's slide,
the ring of input rows and its copies ahead), against the plain
window sums and, quantised, against the JAX package's comptime path and its
Pallas kernel (interpret mode); the wrapper's multiply-high quantiser; the
predicate that sends radii past the ring to the column walk.  The kernel
itself is held against the plain version on the card, in
tests/test_torch_card.py and chip_smoke.py.

Tolerance: all integer, so every comparison is bit-exact.
"""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as plmod
import jax.numpy as jnp

from vszip_tpu.kernels import boxblur_pallas as kp
from vszip_tpu.ops.boxblur import _ct_blur_int
from vszip_tpu_torch.kernels import boxblur as kt


@pytest.fixture
def interpret(monkeypatch):
    orig = plmod.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(kp.pl, "pallas_call", interp_call)


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)


AHEAD_GROUPS, GROUP_ROWS = 4, 4  # csrc/boxblur.cu kAheadGroups, kGroupRows


def _ct_v_walk(x, radius):
    """``ct_v_chip_kernel``'s walk in plain torch: the hybrid mirror's window
    sums of every column, the input rows entering a ring of 2r + 1 +
    V_CHIP_AHEAD_ROWS slots by groups of 4 rows, 4 groups ahead of the step
    that reads them, and every output row slid from the one before it (the
    kernel's steady and edge steps)."""
    n, h, w = x.shape
    xi = x.to(torch.int64)
    r, R = radius, 2 * radius + 1
    R0 = R + kt.V_CHIP_AHEAD_ROWS
    out = torch.empty((n, h, w), dtype=torch.int64)
    ring = torch.full((R0, n, w), -(1 << 40), dtype=torch.int64)

    def issue(g):
        for s in range(g * GROUP_ROWS, (g + 1) * GROUP_ROWS):
            if s < h:
                ring[s % R0] = xi[:, s]

    for g in range(AHEAD_GROUPS):
        issue(g)
    wx = torch.zeros((n, w), dtype=torch.int64)
    for s in range(h + r + 1):
        if s % GROUP_ROWS == 0 and s < h:
            issue(s // GROUP_ROWS + AHEAD_GROUPS)
        c0, t0 = s % R0, (s - R) % R0
        if s <= r:  # W(0)
            wx = wx + (2 if s > 0 else 1) * ring[c0]
            continue
        y = s - r - 1
        out[:, y] = wx
        lead = ring[c0] if s < h else ring[(c0 - r - 1) % R0]
        trail = ring[t0] if y >= r else ring[R - s]
        wx = wx + lead - trail
    return out


def _extremes_and_noise(h, w, seed):
    """uint8 and uint16 planes at 0, at their maximum and random."""
    planes = {}
    for dtype in (np.uint8, np.uint16):
        top = np.iinfo(dtype).max
        planes[dtype] = np.stack([np.zeros((h, w), dtype), np.full((h, w), top, dtype),
                                  _rand((h, w), dtype, seed)])
    return planes


@pytest.mark.parametrize("radius", range(1, 41))
def test_ct_v_walk_equals_hybrid_window_sums(radius):
    # every height from the least (2r + 1) to 2r + 40
    for h in range(2 * radius + 1, 2 * radius + 41):
        for x in _extremes_and_noise(h, 3, radius * 1000 + h).values():
            xt = torch.from_numpy(x)
            assert torch.equal(_ct_v_walk(xt, radius),
                               kt._hybrid_window_sums(xt, radius).to(torch.int64)), h


@pytest.mark.parametrize("radius,h", [(1, 1080), (2, 1081), (13, 1080), (13, 437), (40, 1300),
                                      (200, 1300)], ids=str)
def test_ct_v_walk_on_tall_planes(radius, h):
    # the ring wraps many times; the bottom rows read it back past the wrap
    x = torch.from_numpy(_rand((2, h, 5), np.uint16, h))
    assert torch.equal(_ct_v_walk(x, radius),
                       kt._hybrid_window_sums(x, radius).to(torch.int64))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=str)
def test_ct_v_walk_matches_jax_ct_blur_int(dtype, interpret):
    # the walk, quantised by the wrapper's multiplier, then the one runtime
    # horizontal pass: the JAX package's comptime path and its Pallas kernel
    r = 13
    x = _rand((2, 2 * r + 31, 70), dtype, 13)
    xt = torch.from_numpy(x)
    m, s = kt.quantizer(r)
    q = ((2 * _ct_v_walk(xt, r) + 2 * r + 1) * m) >> s
    got = kt.h_fixed_ref(q.to(xt.dtype), r).numpy()
    np.testing.assert_array_equal(got, np.asarray(_ct_blur_int(jnp.asarray(x), r)))
    np.testing.assert_array_equal(got, np.asarray(kp.ct_blur_int_pallas(jnp.asarray(x), r)))


def test_quantizer_is_exact_up_to_the_largest_numerator():
    # (n * m) >> s == n // (2k) for every n = q*2k - 1 and q*2k up to
    # N_max = k * 131071 and N_max itself, every radius the chip takes; and
    # m < 2^29, n < 2^28, so the kernel's 32x32->64 product holds it
    radii = [r for r in range(1, 1000) if kt.v_fixed_on_chip(r, 1)]
    assert radii[-1] == 897
    for r in radii:
        k = 2 * r + 1
        d, n_max = 2 * k, k * 131071
        m, s = kt.quantizer(r)
        assert m < 1 << 29 and n_max < 1 << 28 and s < 64
        q = np.arange(1, n_max // d + 1, dtype=np.uint64) * np.uint64(d)
        n = np.concatenate([q - np.uint64(1), q, np.array([n_max], np.uint64)])
        n = n[n <= n_max]
        np.testing.assert_array_equal((n * np.uint64(m)) >> np.uint64(s), n // np.uint64(d),
                                      err_msg=f"r {r}")


@pytest.mark.parametrize("radius", [1, 2, 13])
def test_quantizer_on_every_numerator(radius):
    k = 2 * radius + 1
    m, s = kt.quantizer(radius)
    n = np.arange(0, k * 131071 + 1, dtype=np.uint64)
    np.testing.assert_array_equal((n * np.uint64(m)) >> np.uint64(s), n // np.uint64(2 * k))


@pytest.mark.parametrize("radius,on_chip", [(1, True), (13, True), (896, True), (897, True),
                                            (898, False), (2000, False)], ids=str)
def test_ct_v_takes_the_column_walk_past_its_ring(radius, on_chip):
    # ct_v_chip keeps 2r + 21 rows of 128 bytes per warp, v_chip's one-pass
    # ring; past 227 KB no kernel takes B1's vertical stage (the op's
    # comptime path stops at r 22), so ct_blur_int raises there on either
    # device, before it reads the plane
    assert kt.v_fixed_on_chip(radius, 1) is on_chip
    x = torch.zeros((1, 2 * radius + 1, 3), dtype=torch.uint16)
    if on_chip:
        assert torch.equal(kt.ct_blur_int(x, radius), x)
    else:
        with pytest.raises(ValueError, match="radius <= 897"):
            kt.ct_blur_int(x, radius)
