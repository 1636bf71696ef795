"""The CUDA kernels on the card: each against its plain PyTorch version, the
slice (BoxBlur, Limiter, Deband, CLAHE, EEDI3, XPSNR, SSIMULACRA2, Compress,
Checkmate, CombMask, CombMaskMT, BilateralDither, MosquitoNR, Bilateral and
the plain filters) on the card against the port's CPU path, the streaming
runtime against resident calls, ImageRead on the card against a CPU read,
``run_sharded`` and ``process_stream`` over a two-entry mesh on cuda:0
against resident calls, the benchmark's 5-pass BoxBlur and MosquitoNR at
1080p against their plain references (MosquitoNR's stage spans and plane
counters with it), the launch and variant counters, and the wrappers' input
checks.  Every test here needs an NVIDIA GPU and skips
without one.  This file imports no JAX (the card's machine has none), so it
runs there on its own, without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

Tolerance: bit-exact everywhere, floats included (Deband m6's soft blend,
CLAHE's blend, EEDI3's costs, DP and interpolation, SSIMULACRA2's band
partials): those kernels build without FMA contraction and round each
product and sum as the plain torch ops do, so EEDI3's outputs and direction
paths are equal, not close.  XPSNR's block sums are exact integers.  Where
the card's result is compared with the CPU's through a torch reduction in
f64 (B13's fold, XPSNR's weighted sums and log10), rtol 1e-12 on the sums
and XPSNR's props; the SSIMULACRA2 score, ``100 - 10 s^0.63`` of those
sums, within rtol 1e-9 on a linear input (the fold's f64 rounding grows
through the power; measured 3.6e-12 on the H100) and 1e-6 on a non-linear
one (torch's f32 ``pow`` in the sRGB EOTF may round its last bit
differently on the two devices).  Bilateral's algorithm 2 kernel equals its
plain version on the card bit for bit (both take CUDA's ``expf``); the op on
the card is held to its contract against the CPU, not bit for bit: CUDA's
``expf`` and torch's CPU ``exp`` round differently, so integer planes may
differ by 1 LSB (algorithm 2 on under 1% of pixels), f32 within rtol 1e-5 /
atol 1e-6 (algorithm 1: 3e-5 / 3e-6), f16 within one ulp.  The plain filters' integer planes and props are bit-exact,
their f64 props within rtol 1e-12; streamed runs equal resident ones on the
card bit for bit.
"""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import vszip_tpu_torch as vt
from portbench.reference import boxblur as boxblur_ref
from portbench.reference import boxblur_rt
from portbench.reference import mosquito_nr as mosquito_ref
from portbench.traffic import frames as bench_frames
from vszip_tpu_torch import trace
from vszip_tpu_torch.kernels import bilateral as kbl
from vszip_tpu_torch.kernels import bilateral_dither as kbd
from vszip_tpu_torch.kernels import boxblur as kb
from vszip_tpu_torch.kernels import checkmate as kk
from vszip_tpu_torch.kernels import comb_mask as km
from vszip_tpu_torch.kernels import compress as kz
from vszip_tpu_torch.kernels import clahe as kc
from vszip_tpu_torch.kernels import deband as kd
from vszip_tpu_torch.kernels import eedi3 as ke
from vszip_tpu_torch.kernels import mosquito_nr as kmn
from vszip_tpu_torch.kernels import ssim as ks
from vszip_tpu_torch.kernels import xpsnr as kx
from vszip_tpu_torch.ops.clahe import _cells_8bit
from vszip_tpu_torch.ops.eedi3 import _pad_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bits(t):
    """`t` as integers holding its bit pattern: floats by their IEEE bits, so
    -0.0 is not +0.0; integers widened (torch lacks uint16 kernels on some
    devices)."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t.to(torch.int64)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.float64], ids=str)
def test_same_compares_floats_bit_for_bit(dtype):
    # on the CPU: torch.equal holds -0.0 equal to +0.0; _same does not
    pos = torch.tensor([0.0, 1.5, -2.0], dtype=dtype)
    neg = torch.tensor([-0.0, 1.5, -2.0], dtype=dtype)
    assert torch.equal(pos, neg) and not _same(pos, neg)
    assert _same(neg, neg.clone()) and not _same(pos, pos.to(torch.float64 if dtype != torch.float64
                                                              else torch.float32))
    nan = torch.tensor([float("nan")], dtype=dtype)
    assert not torch.equal(nan, nan) and _same(nan, nan.clone())


def _rand(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, torch.iinfo(dtype).max + 1, shape, generator=g,
                         device=device, dtype=torch.int32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("shape", [(2, 33, 77), (1, 7, 13), (3, 540, 960)], ids=str)
def test_kernels_match_plain(cuda, shape, dtype):
    x = _rand(shape, dtype, cuda)
    for r in (1, 3, 13, 22, 23, 40):
        if 2 * r >= min(shape[1:]):
            continue
        if r <= 22:
            assert _same(kb.ct_blur_int(x, r), kb.ct_blur_int_ref(x, r))
        for p in (1, 2, 5):
            assert _same(kb.rt_blur_h(x, r, p), kb.h_fixed_ref(x, r, p))
            assert _same(kb.rt_blur_v_multi(x, r, p), kb.v_fixed_ref(x, r, p))
        assert _same(kb.rt_blur_v(x, r), kb.v_fixed_ref(x, r))


# v_chip (B3, B4) runs one warp per 128-byte strip (64 uint16 or 128 uint8
# columns), copies rows 16 ahead in groups of 4 (16-byte copies where rows
# are 16-byte aligned, else element loads), and keeps rings of 2r+1 rows per
# pass and 2r+21 for the input; past 6 passes or 227 KB of rings the
# wrapper takes the column walk v_fixed
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("w", [1, 2, 7, 8, 9, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1920, 1921,
                               3840])
def test_v_fixed_matches_plain_at_strip_widths(cuda, dtype, w):
    x = _rand((3 if w % 2 else 1, 40, w), dtype, cuda, seed=w)
    for r in (1, 13, 19):
        for p in range(1, 8):
            assert _same(kb.rt_blur_v_multi(x, r, p), kb.v_fixed_ref(x, r, p)), (r, p)
        assert _same(kb.rt_blur_v(x, r), kb.v_fixed_ref(x, r)), r


# heights at 2r+1 and 2r+2, around the input ring (2r+21 rows), where every
# pass of 5 first runs without a mirror ((5+1)(r+1)-1), at 1080 and 2160;
# radii 1, 13, 23, 100 and the largest with 2r < h (the walk past 1 pass)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("r,h", [(1, 3), (1, 4), (1, 22), (1, 23), (1, 24), (13, 27), (13, 28),
                                 (13, 46), (13, 47), (13, 48), (13, 83), (13, 84), (13, 1080),
                                 (23, 47), (23, 48), (23, 67), (23, 1080), (23, 2160),
                                 (100, 201), (100, 202), (100, 1080), (539, 1080),
                                 (1079, 2160)], ids=str)
def test_v_fixed_matches_plain_at_heights(cuda, dtype, r, h):
    x = _rand((3 if h % 2 else 1, h, 144), dtype, cuda, seed=h + r)
    for p in range(1, 7):
        assert _same(kb.rt_blur_v_multi(x, r, p), kb.v_fixed_ref(x, r, p)), p


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("r,passes,on_chip", [(897, 1, True), (898, 1, False), (179, 5, True),
                                              (180, 5, False), (149, 6, True), (150, 6, False),
                                              (13, 6, True), (13, 7, False)], ids=str)
def test_v_fixed_matches_plain_on_both_sides_of_the_walk(cuda, dtype, r, passes, on_chip):
    x = _rand((2, 2 * r + 2, 144), dtype, cuda, seed=r + passes)
    assert kb.v_fixed_on_chip(r, passes) is on_chip
    assert _same(kb.rt_blur_v_multi(x, r, passes), kb.v_fixed_ref(x, r, passes))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
def test_v_fixed_takes_planes_off_16_byte_alignment(cuda, dtype):
    """A plane that starts one element past an aligned address: rows of 256
    bytes, but element loads and stores."""
    x = _offset(_rand((3, 60, 256 // dtype.itemsize), dtype, cuda, seed=7))
    assert x.is_contiguous() and x.data_ptr() % 16
    for r, p in ((1, 1), (13, 5), (23, 1), (29, 6)):
        assert _same(kb.rt_blur_v_multi(x, r, p), kb.v_fixed_ref(x, r, p)), (r, p)


# B1's vertical stage on chip (ct_v_chip): one warp per 128-byte strip, as
# v_chip, with the hybrid mirror's slide and the multiply-high quantiser,
# up to r = 897 (its ring); ct_blur_int raises past that
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("w", [1, 2, 63, 64, 65, 127, 128, 129, 1920, 1921])
def test_ct_blur_int_matches_plain_at_strip_widths(cuda, dtype, w):
    x = _rand((3 if w % 2 else 1, 40, w), dtype, cuda, seed=w)
    for r in (1, 13, 19):
        assert _same(kb.ct_blur_int(x, r), kb.ct_blur_int_ref(x, r)), r


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("r,h", [(1, 3), (1, 4), (1, 5), (1, 1080), (1, 1081), (13, 27), (13, 28),
                                 (13, 29), (13, 1080), (13, 2160), (23, 47), (23, 48), (23, 49),
                                 (23, 1080), (100, 201), (100, 203), (100, 1601), (539, 1080)],
                         ids=str)
def test_ct_blur_int_matches_plain_at_heights(cuda, dtype, r, h):
    for n in (1, 3):
        x = _rand((n, h, 144), dtype, cuda, seed=h + r + n)
        assert _same(kb.ct_blur_int(x, r), kb.ct_blur_int_ref(x, r)), n


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("value", ["zero", "max"])
def test_ct_blur_int_at_the_extremes(cuda, dtype, value):
    top = 0 if value == "zero" else torch.iinfo(dtype).max
    for r, h in ((1, 3), (13, 1080), (897, 1797)):
        x = torch.full((2, h, 130), top, dtype=dtype, device=cuda)
        assert _same(kb.ct_blur_int(x, r), kb.ct_blur_int_ref(x, r)), r


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("h", [1795, 1798])
def test_ct_blur_int_matches_plain_at_its_largest_ring(cuda, dtype, h):
    x = _rand((2, h, 144), dtype, cuda, seed=897 + h)
    assert _same(kb.ct_blur_int(x, 897), kb.ct_blur_int_ref(x, 897))


def test_ct_blur_int_raises_past_its_ring(cuda):
    x = _rand((1, 1800, 144), torch.uint16, cuda)
    trace.reset_launches()
    with pytest.raises(ValueError, match="radius <= 897"):
        kb.ct_blur_int(x, 898)
    assert kb.LAUNCHES["ct_blur_int"] == 0


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
def test_ct_blur_int_takes_planes_off_16_byte_alignment(cuda, dtype):
    x = _offset(_rand((3, 60, 256 // dtype.itemsize), dtype, cuda, seed=8))
    assert x.is_contiguous() and x.data_ptr() % 16
    for r in (1, 13, 29):
        assert _same(kb.ct_blur_int(x, r), kb.ct_blur_int_ref(x, r)), r


@pytest.mark.parametrize("r", [13, 897])
def test_ct_blur_int_counts_one_launch_a_call(cuda, r):
    x = _rand((1, 2 * r + 3, 64), torch.uint16, cuda, seed=r)
    trace.reset_launches()
    kb.ct_blur_int(x, r)
    kb.ct_blur_int(x, r)
    assert kb.LAUNCHES == {"ct_blur_int": 2, "rt_blur_h": 0, "rt_blur_v_multi": 0,
                           "rt_blur_v": 0}


# B1 in one launch (ct_blur_kernel) where ct_blur_fused_shape takes the
# plane (r <= 22, the register pass's row, a 16-byte chunk a thread, the
# ring and row buffers in a block's shared memory), else its two stages;
# each call counts the variant it took
def _ct_blur_matches_plain(x, r):
    trace.reset_launches()
    got = kb.ct_blur_int(x, r)
    fused = kb.ct_blur_fused_shape(x.shape[2], r, x.element_size()) is not None
    assert kb.VARIANTS["ct_fused"] == int(fused) and kb.VARIANTS["ct_two_stage"] == int(not fused)
    assert kb.VARIANTS["h_fixed_warp"] + kb.VARIANTS["h_fixed_shared"] == int(not fused)
    return _same(got, kb.ct_blur_int_ref(x, r)), fused


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("r", range(1, 23))
def test_ct_blur_fused_matches_plain_at_every_radius(cuda, dtype, r):
    """1080p uint16 rows past r 13 take two stages: the ring and the row
    buffers would pass a block's shared memory."""
    for n, h, w in ((3, 2 * r + 1, 200), (2, 1080, 1920), (5, 97, 960)):
        x = _rand((n, h, w), dtype, cuda, seed=r * 7 + h)
        same, fused = _ct_blur_matches_plain(x, r)
        assert same and fused == (w < 1920 or r <= 13 or dtype == torch.uint8), (n, h, w)


def _widest_fused(r, elem_bytes):
    w = r
    while kb.ct_blur_fused_shape(w + 1, r, elem_bytes) is not None:
        w += 1
    return w


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("r", [1, 2, 13, 22])
def test_ct_blur_fused_at_the_widths_of_its_rule(cuda, dtype, r):
    """The widest row the rule takes and one wider (two stages), rows
    narrower than r (two stages: the comptime quirk), widths 1-33 and odd
    widths."""
    widest = _widest_fused(r, dtype.itemsize)
    for w in sorted({widest, widest + 1, *range(1, 34), 99, 257, 1001, 1919}):
        x = _rand((2, 2 * r + 3, w), dtype, cuda, seed=w + r)
        same, fused = _ct_blur_matches_plain(x, r)
        assert same and fused == (r <= w <= widest), w


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("r,h", [(1, 3), (1, 4), (1, 17), (1, 1080), (13, 27), (13, 28), (13, 29),
                                 (13, 43), (13, 44), (13, 100), (13, 540), (13, 1080), (13, 1081),
                                 (22, 45), (22, 46), (22, 300), (22, 1079)], ids=str)
def test_ct_blur_fused_at_heights(cuda, dtype, r, h):
    """Heights from 2r + 1; 1, 3 and 64 frames, so 1 to 5 bands a frame and
    bands that end a group of 8 rows early."""
    for n in (1, 3, 64):
        x = _rand((n, h, 136), dtype, cuda, seed=h + r + n)
        same, fused = _ct_blur_matches_plain(x, r)
        assert same and fused, n


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
def test_ct_blur_fused_takes_planes_off_16_bytes(cuda, dtype):
    """Planes one element past 16 bytes, and rows that are not a whole
    number of 16-byte chunks: element loads and stores."""
    for n, h, w, r in ((3, 60, 128, 13), (2, 61, 130, 7), (2, 540, 960, 13), (1, 1080, 1920, 13),
                       (2, 45, 1001, 22)):
        x = _offset(_rand((n, h, w), dtype, cuda, seed=w))
        assert x.is_contiguous() and x.data_ptr() % 16
        same, fused = _ct_blur_matches_plain(x, r)
        assert same and fused, (h, w, r)
        same, fused = _ct_blur_matches_plain(_rand((n, h, w + 3), dtype, cuda, seed=w), r)
        assert same and fused, (h, w + 3, r)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("value", ["zero", "max"])
def test_ct_blur_fused_at_the_extremes(cuda, dtype, value):
    top = 0 if value == "zero" else torch.iinfo(dtype).max
    for r, (n, h, w) in ((1, (2, 3, 64)), (13, (4, 1080, 1920)), (13, (4, 540, 960)),
                         (22, (2, 1080, 1480))):
        x = torch.full((n, h, w), top, dtype=dtype, device=cuda)
        same, fused = _ct_blur_matches_plain(x, r)
        assert same and fused, r


@pytest.mark.parametrize("case", ["ring", "rowbuf", "rowbuf16", "bands", "slots", "chunks",
                                  "radius", "wide"])
def test_ct_blur_refuses_shapes_that_do_not_hold_the_planes(cuda, case):
    """vz_ct_blur checks the shape it is given (ct_fused_holds): the rule's
    shape for 2 frames of 64 x 200 uint16 at r 13 in 2 bands runs and equals
    the plain version; a ring a row short, row buffers too short or off 16
    cells, bands under r + 1 rows, another run's slots, more chunks than the
    run has, 2r >= h, or a row past 2 * 128 chunks each raise."""
    h, w, r = 64, 200, 13
    slots, chunks, ring, rowbuf, _ = kb.ct_blur_fused_shape(w, r, 2)
    good = dict(w=w, r=r, bands=2, slots=slots, chunks=chunks, ring=ring, rowbuf=rowbuf)
    bad = {**good, **{"ring": {"ring": ring - 1}, "rowbuf": {"rowbuf": rowbuf - 16},
                      "rowbuf16": {"rowbuf": rowbuf + 8}, "bands": {"bands": h // (r + 1) + 1},
                      "slots": {"slots": 32}, "chunks": {"chunks": 4},
                      "radius": {"r": 32}, "wide": {"w": 2056}}[case]}

    def launch(a):
        x = _rand((2, h, a["w"]), torch.uint16, cuda, seed=5)
        out = torch.zeros_like(x)
        kb._CT_BLUR(x.device, x.data_ptr(), out.data_ptr(), 2, 2, h, a["w"], a["r"], a["bands"],
                    a["slots"], a["chunks"], a["ring"], a["rowbuf"], kb.ct_blur_multiplier(a["r"]))
        return x, out
    x, out = launch(good)
    assert _same(out, kb.ct_blur_int_ref(x, r))
    with pytest.raises(RuntimeError, match="^vszip_tpu_torch: vz_ct_blur failed with CUDA "
                       "error 1$"):
        launch(bad)


def test_boxblur_1080p_matches_the_benchmark_reference_in_one_launch_a_plane(cuda):
    """The benchmark's r 13 configuration, 8 frames of its seeded 1080p
    YUV420P16 pictures, through the op: bit for bit the comptime-path
    reference (``portbench/reference/boxblur.py``), every plane in one
    ``ct_blur_kernel`` launch."""
    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "portbench/configs/boxblur_r13_yuv420p16_1080p.json").read_text())
    planes = bench_frames.make_planes(2**31 + 25, 8, [tuple(s) for s in cfg["planes"]],
                                      cfg["bits"], cuda)
    clip = vt.Clip.from_planes(planes, vt.get_format(cfg["format"]))
    trace.reset_launches()
    got = vt.boxblur(clip, **cfg["args"])
    torch.cuda.synchronize()
    assert {k: n for k, n in kb.LAUNCHES.items() if n} == {"ct_blur_int": 3}
    assert {k: n for k, n in kb.VARIANTS.items() if n} == {"ct_fused": 3}
    want = boxblur_ref.run(planes, cfg)
    for g, w in zip(got.planes, want):
        assert g.is_cuda and _same(g, w)


def test_axis_radius_limits_are_per_axis(cuda):
    # a wide, short plane: the H window fits, the V window would not
    x = _rand((1, 9, 200), torch.uint16, cuda)
    assert _same(kb.rt_blur_h(x, 30, 2), kb.h_fixed_ref(x, 30, 2))
    with pytest.raises(ValueError, match="do not take radius"):
        kb.rt_blur_v(x, 30)


@pytest.mark.parametrize("width", [16, 8, 3])
def test_comptime_quirk_window_wider_than_row(cuda, width):
    # hpasses=0 skips the hradius check, so the H window may pass the row's
    # width; the mirror then repeats as NumPy's 'symmetric' pad does
    x = _rand((2, 64, width), torch.uint16, cuda)
    assert _same(kb.ct_blur_int(x, 10), kb.ct_blur_int_ref(x, 10))
    assert _same(kb.rt_blur_h(x, 10, 3), kb.h_fixed_ref(x, 10, 3))


@pytest.mark.parametrize("args", [
    {"hradius": 13, "vradius": 13},
    {"hradius": 13, "hpasses": 5, "vradius": 13, "vpasses": 5},
    {"hradius": 23, "vradius": 23},
    {"hradius": 4, "vradius": 9},
    {"hradius": 5, "vradius": 5, "hpasses": 0},
], ids=str)
def test_boxblur_on_card_matches_cpu(cuda, args):
    rng = np.random.default_rng(3)
    fmt = vt.get_format("YUV420P16")
    planes = [rng.integers(0, 1 << 16, (2,) + fmt.plane_dims(192, 128, p)[::-1],
                           dtype=np.uint16) for p in range(3)]
    cpu = vt.Clip.from_planes(planes, fmt, device="cpu")
    trace.reset_launches()
    got = vt.limiter(vt.boxblur(cpu.to(cuda), **args), tv_range=True)
    assert sum(kb.LAUNCHES.values()) > 0
    want = vt.limiter(vt.boxblur(cpu, **args), tv_range=True)
    for g, w in zip(got.planes, want.planes):
        assert g.is_cuda and _same(g.cpu(), w)


def test_boxblur_5pass_1080p_matches_the_benchmark_reference_through_v_chip_and_warp_h_fixed(
        cuda):
    """The benchmark's 5-pass configuration, 8 frames of its seeded 1080p
    YUV420P16 pictures, through the op: bit for bit the runtime-path
    reference (``portbench/reference/boxblur_rt.py``), with every plane's
    vertical passes on chip (``v_chip``) and horizontal ones one warp a row
    in registers (``h_fixed_warp``), none in the block design."""
    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "portbench/configs/boxblur_r13_5pass_yuv420p16_1080p.json")
                     .read_text())
    planes = bench_frames.make_planes(2**31 + 99, 8, [tuple(s) for s in cfg["planes"]],
                                      cfg["bits"], cuda)
    clip = vt.Clip.from_planes(planes, vt.get_format(cfg["format"]))
    trace.reset_launches()
    got = vt.boxblur(clip, **cfg["args"])
    torch.cuda.synchronize()
    assert {k: n for k, n in kb.LAUNCHES.items() if n} == {"rt_blur_h": 3, "rt_blur_v_multi": 3}
    assert kb.VARIANTS == {"ct_fused": 0, "ct_two_stage": 0, "v_chip": 3, "v_fixed": 0,
                           "h_fixed_warp": 3, "h_fixed_shared": 0, "h_fixed_scratch": 0}
    want = boxblur_rt.run(planes, cfg)
    for g, w in zip(got.planes, want):
        assert g.is_cuda and _same(g, w)


def test_mosquito_nr_1080p_matches_the_benchmark_reference_with_its_stage_spans(cuda):
    """The benchmark's MosquitoNR configuration, 8 frames of its seeded 1080p
    YUV420P16 pictures, through the op: bit for bit the plain reference
    (``portbench/reference/mosquito_nr.py``), chroma passed through; one plane
    smoothed (one launch of the smoothing kernel) and restored, none mixed;
    both stage spans under ``trace.collect()``.  Under the profiler, over
    three calls, the device operations pair with launches inside the two
    stage ranges, and the two stage metrics add up to a call's busy device
    time (at 8 frames the host's launches leave gaps between the
    operations)."""
    from portbench.metrics import restore_stage_ms, smooth_stage_ms
    from portbench.trace import _records

    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "portbench/configs/mosquito_nr_yuv420p16_1080p.json").read_text())
    planes = bench_frames.make_planes(2**31 + 26, 8, [tuple(s) for s in cfg["planes"]],
                                      cfg["bits"], cuda)
    clip = vt.Clip.from_planes(planes, vt.get_format(cfg["format"]))
    mosquito = importlib.import_module("vszip_tpu_torch.ops.mosquito_nr")
    trace.reset_launches()
    with trace.collect() as t:
        got = vt.mosquito_nr(clip, **cfg["args"])
        torch.cuda.synchronize()
    assert mosquito.PLANES == {"mosquito_nr_smoothed": 1, "mosquito_nr_restored": 1,
                               "mosquito_nr_mixed": 0}
    assert kmn.LAUNCHES == {"mosquito_nr_smooth": 1}
    names = [s[0] for s in t.spans]
    assert names.count("vszip.op.mosquito_nr.smooth") == 1
    assert names.count("vszip.op.mosquito_nr.restore") == 1
    want = mosquito_ref.run(planes, cfg)
    for g, w in zip(got.planes, want):
        assert g.is_cuda and _same(g, w)
    assert all(torch.equal(g, x) for g, x in zip(got.planes[1:], planes[1:]))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("portbench.traced"):
            for _ in range(3):
                with torch.profiler.record_function("portbench.op"):
                    vt.mosquito_nr(clip, **cfg["args"])
            torch.cuda.synchronize()
    rec = {"trace": _records(prof, 3)}
    smooth, restore = smooth_stage_ms.read(rec), restore_stage_ms.read(rec)
    assert smooth is not None and restore is not None and smooth > 0 and restore > 0
    busy = [sum(d["end"] - d["start"] for d in rec["trace"]["device"]
                if s <= (d["start"] + d["end"]) / 2 <= e) for s, e in rec["trace"]["ops"]]
    assert len(busy) == 3
    assert smooth + restore == pytest.approx(sorted(busy)[1] * 1e-3, rel=0.01)


def test_a_profiled_boxblur_call_shows_its_ranges_and_no_extra_device_work(cuda):
    """Under ``torch.profiler`` a BoxBlur r13 call on 1080p YUV420P16 shows the
    program's range by name on the host's side and runs the kernels it runs
    without them (B1's one a plane): no ``vszip.`` range is device work, and
    every kernel starts after the ``vszip.op.boxblur`` range opens."""
    rng = np.random.default_rng(9)
    fmt = vt.get_format("YUV420P16")
    planes = [rng.integers(0, 1 << 16, (4,) + fmt.plane_dims(1920, 1080, p)[::-1],
                           dtype=np.uint16) for p in range(3)]
    clip = vt.Clip.from_planes(planes, fmt, device=cuda)
    vt.boxblur(clip, hradius=13, vradius=13)   # builds and warms up outside the trace
    torch.cuda.synchronize()
    trace.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        vt.boxblur(clip, hradius=13, vradius=13)
        torch.cuda.synchronize()
    ranges, device = {}, []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(ev)
        elif ev.name().startswith("vszip."):
            ranges.setdefault(ev.name(), []).append(ev.start_ns())
    # the op's range alone: the finer spans are collected, never profiled
    assert {k: len(v) for k, v in ranges.items()} == {"vszip.op.boxblur": 1}
    assert not any(ev.name().startswith("vszip.") for ev in device)
    kernels = [ev for ev in device if not ev.is_user_annotation()]
    assert kb.LAUNCHES["ct_blur_int"] == 3 and kb.VARIANTS["ct_fused"] == 3 and len(kernels) == 3
    assert min(k.start_ns() for k in kernels) > ranges["vszip.op.boxblur"][0]


def test_wrappers_reject_what_kernels_do_not_take(cuda):
    x = _rand((2, 32, 48), torch.uint16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kb.rt_blur_h(x.transpose(1, 2), 3)
    with pytest.raises(ValueError, match="uint8/uint16"):
        kb.rt_blur_v(x.to(torch.int32), 3)
    with pytest.raises(ValueError, match="do not take radius"):
        kb.ct_blur_int(x, 16)
    with pytest.raises(ValueError, match="passes >= 1"):
        kb.rt_blur_v_multi(x, 3, 0)


def _offsets(shape, rmax, device, signed, seed=0):
    """Seeded offsets in [0, cap] (or [-cap, cap]), cap = min(rmax, the
    distance to the nearest edge)."""
    h, w = shape
    rng = np.random.default_rng(seed)
    ys = np.minimum(np.arange(h), h - 1 - np.arange(h))[:, None]
    xs = np.minimum(np.arange(w), w - 1 - np.arange(w))[None, :]
    cap = np.minimum(rmax, np.minimum(ys, xs))
    v = rng.integers(-rmax if signed else 0, rmax + 1, (h, w))
    return torch.from_numpy(np.clip(v, -cap if signed else 0, cap).astype(np.int32)).to(device)


@pytest.mark.parametrize("shape", [(2, 33, 77), (1, 7, 13), (2, 540, 960)], ids=str)
def test_deband_kernels_match_plain(cuda, shape):
    x = _rand(shape, torch.uint16, cuda, seed=2)
    for rmax in (1, 15, 100):
        v = _offsets(shape[1:], rmax, cuda, signed=False)
        for mode in kd.SEPARABLE_MODES:
            for bf in (True, False):
                thr3 = (12337, 20000, 6000)
                assert torch.equal(kd.deband_center(x, v, mode, bf, rmax, thr3),
                                   kd.deband_center_ref(x, v, mode, bf, rmax, thr3))
    for rmax in (15, 64, 200):
        v1 = _offsets(shape[1:], rmax, cuda, signed=True, seed=1)
        v2 = _offsets(shape[1:], rmax, cuda, signed=True, seed=2)
        key = (v1 + rmax) * (2 * rmax + 1) + (v2 + rmax)
        for bf in (True, False):
            assert torch.equal(kd.deband_m2_center(x, key, bf, rmax, 12337),
                               kd.deband_m2_center_ref(x, key, bf, rmax, 12337))


def test_deband_kernels_read_any_offset_plane(cuda):
    # offsets past the edges: B5 reads 0 there, B6 clamps, as the plain
    # versions do
    x = _rand((2, 40, 50), torch.uint16, cuda, seed=3)
    g = torch.Generator(device=cuda).manual_seed(4)
    wild = torch.randint(-300, 300, (40, 50), generator=g, device=cuda, dtype=torch.int32)
    for mode in kd.SEPARABLE_MODES:
        assert torch.equal(kd.deband_center(x, wild, mode, True, 15, (900, 900, 900)),
                           kd.deband_center_ref(x, wild, mode, True, 15, (900, 900, 900)))
    assert torch.equal(kd.deband_m2_center(x, wild, False, 15, 900),
                       kd.deband_m2_center_ref(x, wild, False, 15, 900))


def _m2_key(h, w, rmax, device, seed, wild=False):
    """Seeded joint keys over the whole alphabet (offsets up to +-rmax
    whatever the edge distance, so taps are clamped near the edges); with
    `wild`, some keys outside [0, (2rmax+1)^2) too."""
    g = torch.Generator(device=device).manual_seed(seed)
    na = 2 * rmax + 1
    key = torch.randint(0, na * na, (h, w), generator=g, device=device, dtype=torch.int32)
    if wild:
        far = torch.randint(-5 * na * na, 5 * na * na, (h, w), generator=g, device=device,
                            dtype=torch.int32)
        key = torch.where(torch.rand((h, w), generator=g, device=device) < 0.1, far, key)
    return key


# B6 from shared-memory tiles (m2_tile): 64x64 pixels a block, each pair of
# frames staged as one (64 + 2 rmax) x (64 + 2 pad) tile of 32-bit
# positions at clamped coordinates (odd N: the last pair has one frame);
# the device-memory taps of m2_kernel past rmax 50
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 5, 3), (1, 63, 127), (2, 65, 130),
                                   (3, 129, 193), (1, 64, 64), (2, 540, 960), (64, 70, 72),
                                   (63, 70, 72)], ids=str)
@pytest.mark.parametrize("rmax", [0, 1, 15, 50, 51, 200])
def test_deband_m2_matches_plain_at_tile_edges(cuda, shape, rmax):
    x = _rand(shape, torch.uint16, cuda, seed=sum(shape) + rmax)
    key = _m2_key(*shape[1:], rmax, cuda, seed=rmax)
    for bf in (True, False):
        assert _same(kd.deband_m2_center(x, key, bf, rmax, 12337),
                     kd.deband_m2_center_ref(x, key, bf, rmax, 12337)), bf


@pytest.mark.parametrize("rmax,on_chip", [(0, True), (15, True), (50, True), (51, False),
                                          (200, False)], ids=str)
def test_deband_m2_tile_limit(cuda, rmax, on_chip):
    assert kd.m2_on_chip(rmax) is on_chip
    x = _rand((2, 200, 136), torch.uint16, cuda, seed=rmax)
    key = _m2_key(200, 136, rmax, cuda, seed=rmax + 1, wild=True)
    assert _same(kd.deband_m2_center(x, key, True, rmax, 900),
                 kd.deband_m2_center_ref(x, key, True, rmax, 900))


@pytest.mark.parametrize("w", [96, 97, 100])
def test_deband_m2_takes_planes_off_16_byte_alignment(cuda, w):
    """Off 16 bytes: a plane one element past an aligned address (element
    staging, and element stores where the int32 rows are off 16 bytes too),
    rows of a width not a multiple of 8 or of 4."""
    x = _offset(_rand((3, 70, w), torch.uint16, cuda, seed=w))
    assert x.is_contiguous() and x.data_ptr() % 16
    for rmax in (1, 15):
        key = _m2_key(70, w, rmax, cuda, seed=w + rmax, wild=True)
        for bf in (True, False):
            assert _same(kd.deband_m2_center(x, key, bf, rmax, 12337),
                         kd.deband_m2_center_ref(x, key, bf, rmax, 12337)), (rmax, bf)
            y = x.clone()
            assert _same(kd.deband_m2_center(y, key, bf, rmax, 12337),
                         kd.deband_m2_center_ref(y, key, bf, rmax, 12337)), (rmax, bf)


@pytest.mark.parametrize("rmax", [15, 200])
def test_deband_m2_counts_one_launch_a_call(cuda, rmax):
    x = _rand((2, 40, 50), torch.uint16, cuda, seed=rmax)
    key = _m2_key(40, 50, rmax, cuda, seed=rmax)
    trace.reset_launches()
    kd.deband_m2_center(x, key, True, rmax, 900)
    kd.deband_m2_center(x, key, False, rmax, 900)
    assert kd.LAUNCHES == {"deband_center": 0, "deband_m2_center": 2}


@pytest.mark.parametrize("fmt,args", [
    ("YUV420P16", {"sample_mode": 1}),
    ("YUV420P16", {}),
    ("YUV420P16", {"sample_mode": 6, "thr": 30, "grain": [8, 4], "dynamic_grain": True}),
    ("YUV422P16", {"thr": 20}),
    ("YUV420P8", {"sample_mode": 4, "thr": 20}),
    ("GRAY16", {"range": 200, "thr": 40}),
], ids=str)
def test_deband_on_card_matches_cpu(cuda, fmt, args):
    rng = np.random.default_rng(5)
    f = vt.get_format(fmt)
    planes = [rng.integers(0, 1 << f.bits_per_sample,
                           (2,) + f.plane_dims(272, 160, p)[::-1]).astype(f.storage_dtype)
              for p in range(f.num_planes)]
    cpu = vt.Clip.from_planes(planes, f, device="cpu")
    trace.reset_launches()
    got = vt.deband(cpu.to(cuda), **args)
    assert sum(kd.LAUNCHES.values()) > 0  # every case runs B5 or B6 on some plane
    want = vt.deband(cpu, **args)
    for g, w in zip(got.planes, want.planes):
        assert g.is_cuda and _same(g.cpu(), w)


def test_deband_wrappers_reject_what_kernels_do_not_take(cuda):
    x = _rand((2, 32, 48), torch.uint16, cuda)
    v = torch.zeros((32, 48), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="uint16"):
        kd.deband_center(x.to(torch.int32), v, 1, True, 4, (1, 1, 1))
    with pytest.raises(ValueError, match="offset plane"):
        kd.deband_m2_center(x, v[:16], True, 4, 1)
    with pytest.raises(ValueError, match="modes"):
        kd.deband_center(x, v, 2, True, 4, (1, 1, 1))


# ---------------------------------------------------------------------------
# CLAHE (B7) and EEDI3 (B8-B10)
# ---------------------------------------------------------------------------

def _clahe_inputs(shape, tiles_x, tiles_y, device, seed=0):
    """A plane, a random packed table and the op's fractions for it."""
    n, h, w = shape
    tile_h, tile_w = h // tiles_y, w // tiles_x
    (ty1r, _, tx1r, _), ya, xa = _cells_8bit(h, w, tile_h, tile_w, tiles_y, tiles_x)
    g = torch.Generator(device=device).manual_seed(seed)
    tab = torch.randint(-2**31, 2**31 - 1, (n, len(ty1r), len(tx1r) * 256), generator=g,
                        device=device, dtype=torch.int64).to(torch.int32)
    return (_rand(shape, torch.uint8, device, seed), tab, torch.from_numpy(ya).to(device),
            torch.from_numpy(xa).to(device), tile_h, tile_w)


# B7 gives a thread 16 bytes of a row (8-, 4- or 1-byte accesses where the
# width or a plane's address is off 16 bytes: chunk_vector), bx threads a row
# up to 512 (wider rows: several chunks a thread) and stages the table in
# shared memory up to 96 KB (table_on_chip), else reads it from device
# memory.  Widths on and off 16 (1920, 960, 1000, 300, 77, 13, 9000), tiles
# under 16 columns (200x300 in 60x40 tiles: 7x5; 1080p in 16x16: 120x67),
# tables past shared memory (those two), and one frame or three
@pytest.mark.parametrize("shape,tiles", [((2, 1080, 1920), (3, 3)), ((2, 540, 960), (8, 8)),
                                         ((3, 33, 77), (1, 1)), ((1, 7, 13), (4, 2)),
                                         ((1, 200, 300), (60, 40)), ((2, 1080, 1920), (16, 16)),
                                         ((3, 70, 1000), (5, 7)), ((1, 20, 9000), (3, 2)),
                                         ((2, 31, 16), (1, 1))], ids=str)
def test_clahe_kernel_matches_plain(cuda, shape, tiles):
    args = _clahe_inputs(shape, *tiles, cuda)
    assert _same(kc.clahe8_lookup(*args), kc.clahe8_lookup_ref(*args))


@pytest.mark.parametrize("offset", [1, 4, 8], ids=str)
def test_clahe_kernel_takes_planes_off_16_bytes(cuda, offset):
    # a plane that starts `offset` bytes past 16: narrower accesses
    x, tab, ya, xa, th, tw = _clahe_inputs((2, 90, 320), 4, 3, cuda)
    off = torch.empty(x.numel() + offset, dtype=torch.uint8, device=cuda)[offset:].view(x.shape)
    off.copy_(x)
    assert kc.chunk_vector(320, off.data_ptr(), 0) == offset
    assert _same(kc.clahe8_lookup(off, tab, ya, xa, th, tw), kc.clahe8_lookup_ref(x, tab, ya, xa,
                                                                                  th, tw))


@pytest.mark.parametrize("fmt,args", [("GRAY8", {}), ("YUV420P8", {"tiles": [4, 2], "limit": 40}),
                                      ("GRAY16", {"limit": 1})], ids=str)
def test_clahe_on_card_matches_cpu(cuda, fmt, args):
    rng = np.random.default_rng(6)
    f = vt.get_format(fmt)
    planes = [rng.integers(0, 1 << f.bits_per_sample,
                           (2,) + f.plane_dims(193, 131, p)[::-1]).astype(f.storage_dtype)
              for p in range(f.num_planes)]
    cpu = vt.Clip.from_planes(planes, f, device="cpu")
    trace.reset_launches()
    got = vt.clahe(cpu.to(cuda), **args)
    assert kc.LAUNCHES["clahe8_lookup"] == (f.num_planes if f.bits_per_sample == 8 else 0)
    want = vt.clahe(cpu, **args)
    for g, w in zip(got.planes, want.planes):
        assert g.is_cuda and _same(g.cpu(), w)


def smooth_rows(b, l, w, seed):
    """Four (b, l, w) neighbour rows of a ramp with a soft diagonal edge and
    faint noise: content with near-ties in the DP."""
    rng = np.random.default_rng(seed)
    y = np.arange(l, dtype=np.float64)[:, None]
    x = np.arange(w, dtype=np.float64)[None, :]
    rows = []
    for k, dy in enumerate((-3, -1, 1, 3)):
        edge = 1.0 / (1.0 + np.exp(-(x - 0.7 * (2 * y + dy) - w / 3) / 6.0))
        img = 0.3 * x / w + 0.5 * edge + 1e-3 * rng.random((b, l, w))
        rows.append(torch.from_numpy(img.astype(np.float32)))
    return rows


def _eedi3_rows(b, l, w, seed, device, smooth=False):
    if smooth:
        rows = smooth_rows(b, l, w, seed)
    else:
        g = torch.Generator().manual_seed(seed)
        rows = [torch.rand((b, l, w), generator=g) for _ in range(4)]
    return [_pad_rows(r.to(device)).contiguous() for r in rows]


COEFS = (0.2 / 3, 0.25 / 255, 20.0 / 255, 0.55)


# The line kernel cuts x into chunks of 64 positions and gives each DP lane
# K directions: widths below, at and one past a chunk, a multiple of it,
# one position and 3840 (narrow rows keep their backtrack deltas in shared
# memory, wide ones in the global scratch); mdis 1-40 reaches every K of
# both kernels (non-hp 1-3, hp 1-6), nrad 0-3.  "huge" rows saturate every
# cost at BIG, so the DP's candidates tie at the edges and hp's backtrack
# leaves the directions.
@pytest.mark.parametrize("w,mdis,nrad", [
    (1920, 20, 2), (77, 3, 1), (1920, 40, 3), (5, 3, 0), (1, 4, 2), (39, 1, 0), (40, 7, 3),
    (41, 8, 1), (63, 16, 2), (64, 24, 3), (65, 33, 0), (128, 12, 2), (3840, 20, 2)], ids=str)
@pytest.mark.parametrize("smooth", [False, True, None], ids=["noise", "smooth", "huge"])
def test_eedi3_kernels_match_plain(cuda, w, mdis, nrad, smooth):
    if smooth is None:
        rows = [r * 1e37 for r in _eedi3_rows(2, 3, w, 1, cuda)]
    else:
        rows = _eedi3_rows(2, 3, w, 1, cuda, smooth)
    a, b, g, om = (float(np.float32(c)) for c in COEFS)
    gm = torch.Generator().manual_seed(2)
    mask = (torch.rand((2, 3, w), generator=gm) > 0.3).to(cuda)
    for bm in (None, mask):
        out, fp = ke.eedi3_fused(*rows, w, mdis, nrad, a, b, g, om, bm)
        ro, rf = ke.eedi3_fused_ref(*rows, w, mdis, nrad, a, b, g, om, bm)
        assert torch.equal(fp, rf) and _same(out, ro)
    out, fp = ke.eedi3_fused_hp(*rows, w, mdis, nrad, a, b, g, om)
    ro, rf = ke.eedi3_fused_hp_ref(*rows, w, mdis, nrad, a, b, g, om)
    assert torch.equal(fp, rf) and _same(out, ro)


@pytest.mark.parametrize("hp", [False, True])
def test_eedi3_kernels_match_plain_on_ties(cuda, hp):
    # flat content with beta = gamma = 0: every DP candidate ties, so the
    # path is the candidate order alone
    w = 300
    row = torch.zeros((2, 3, w))
    row[..., w // 2:] = torch.rand((2, 3, w - w // 2), generator=torch.Generator().manual_seed(4))
    rows = [_pad_rows(row.to(cuda)).contiguous() for _ in range(4)]
    a, om = float(np.float32(COEFS[0])), float(np.float32(COEFS[3]))
    mask = (torch.rand((2, 3, w), generator=torch.Generator().manual_seed(6)) > 0.3).to(cuda)
    if hp:
        pairs = [(ke.eedi3_fused_hp(*rows, w, 6, 2, a, 0.0, 0.0, om),
                  ke.eedi3_fused_hp_ref(*rows, w, 6, 2, a, 0.0, 0.0, om))]
    else:
        pairs = [(ke.eedi3_fused(*rows, w, 6, 2, a, 0.0, 0.0, om, bm),
                  ke.eedi3_fused_ref(*rows, w, 6, 2, a, 0.0, 0.0, om, bm)) for bm in (None, mask)]
    for (out, fp), (ro, rf) in pairs:
        assert torch.equal(fp, rf) and _same(out, ro)


def _vcheck_inputs(n_off, b, w, drange, device, seed):
    """B10's inputs with directions in [-drange, drange]: a third of them at
    +-drange, and most columns sharing one direction over the lines off-1,
    off, off+1, so that most pixels are not kept and gather; rows near 0.5
    with small differences, so that the blend is neither 0 nor 1."""
    g = torch.Generator().manual_seed(seed)
    dl, nb = (0.5 + 0.05 * torch.rand(s, generator=g) for s in ((n_off, b, w), (n_off, 3, b, w)))
    base = torch.randint(-drange, drange + 1, (n_off, 1, b, w), generator=g, dtype=torch.int32)
    edge = torch.rand(base.shape, generator=g) < 0.33
    base = torch.where(edge, torch.where(base < 0, -drange, drange), base).to(torch.int32)
    noise = torch.randint(-drange, drange + 1, (n_off, 3, b, w), generator=g, dtype=torch.int32)
    mixed = torch.rand((n_off, 3, b, w), generator=g) < 0.2
    dm = torch.where(mixed, noise, base.expand(-1, 3, -1, -1))
    cint = torch.rand((n_off, b, w), generator=g)
    init = 0.5 + 0.05 * torch.rand((b, w), generator=g)
    return [t.contiguous().to(device) for t in (dl, nb, dm, cint, init)]


# B10 splits a frame into slices of at least mdis columns (240 at 1920):
# widths below, at and past a slice, one halo and two, and 3840
VCHECK_SHAPES = sorted({(w, mdis) for mdis in (1, 3, 20, 40)
                        for w in (1, 2, 7, mdis, 2 * mdis + 1, 239, 240, 241, 1920, 3840)})


@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("mode", [1, 2, 3])
@pytest.mark.parametrize("n_off,b", [(9, 3), (1, 1), (2, 9)], ids=str)
@pytest.mark.parametrize("w,mdis", VCHECK_SHAPES, ids=str)
def test_vcheck_kernel_matches_plain(cuda, hp, mode, n_off, b, w, mdis):
    drange = 2 * mdis if hp else mdis
    args = _vcheck_inputs(n_off, b, w, drange, cuda, 10 * mode + hp + w + mdis)
    rc = [float(np.float32(v)) for v in (255 / 32, 255 / 64, 1 / 4, 4)]
    got = ke.vcheck(*args, w, mdis, hp, mode, *rc)
    want = ke.vcheck_ref(*args, w, mdis, hp, mode, *rc)
    assert _same(got, want)


@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("w", [10000, 29000])
def test_vcheck_kernel_takes_wide_rows(cuda, hp, w):
    # slices past 1024 columns (two per thread) and, at 29,000 (about the
    # widest row the first design took), a cluster of 16 blocks
    args = _vcheck_inputs(3, 2, w, 80 if hp else 40, cuda, w + hp)
    rc = [float(np.float32(v)) for v in (255 / 32, 255 / 64, 1 / 4, 4)]
    assert _same(ke.vcheck(*args, w, 40, hp, 2, *rc), ke.vcheck_ref(*args, w, 40, hp, 2, *rc))


def _offset(t):
    """`t` as a contiguous view that starts one element into its storage (so
    not on 16 bytes)."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape).copy_(t)


def test_kernels_take_unaligned_rows(cuda):
    # B10's 16-byte copies and h_fixed's vector loads and stores need
    # aligned rows; views off that alignment take the element-wise paths
    args = [_offset(t) for t in _vcheck_inputs(5, 3, 1920, 20, cuda, 1)]
    rc = [float(np.float32(v)) for v in (255 / 32, 255 / 64, 1 / 4, 4)]
    assert args[0].data_ptr() % 16
    assert _same(ke.vcheck(*args, 1920, 20, False, 2, *rc),
                 ke.vcheck_ref(*args, 1920, 20, False, 2, *rc))
    for dtype in (torch.uint8, torch.uint16):
        x = _offset(_rand((2, 16, 1920), dtype, cuda, seed=3))
        for p in (1, 3):
            assert _same(kb.rt_blur_h(x, 13, p), kb.h_fixed_ref(x, 13, p))


@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("w,mdis", [(7, 1), (96, 3), (241, 3), (1920, 20)], ids=str)
def test_vcheck_takes_directions_past_the_halo(cuda, hp, w, mdis):
    # B9's backtrack can walk past its directions (saturated costs), so a
    # direction may reach any column: B10 reads the columns past its halo
    # from device memory, behind a cluster barrier on the lines that need it
    args = _vcheck_inputs(9, 3, w, max(w // 2, 4 * mdis), cuda, 5 + w + hp)
    rc = [float(np.float32(v)) for v in (255 / 32, 255 / 64, 1 / 4, 4)]
    assert _same(ke.vcheck(*args, w, mdis, hp, 2, *rc),
                 ke.vcheck_ref(*args, w, mdis, hp, 2, *rc))


@pytest.mark.parametrize("fn,fmt,args", [
    ("eedi3", "GRAYS", {"field": 1, "dh": True}),
    ("eedi3", "YUV420PS", {"field": 2, "mdis": 6, "vcheck": 3}),
    ("eedi3", "GRAYS", {"field": 0, "hp": True, "mdis": 5}),
    ("eedi3h", "GRAYS", {"field": 1, "mdis": 4, "nrad": 3, "vcheck": 1}),
    ("eedi3", "GRAYS", {"field": 1, "mdis": 4, "mclip": True}),
    ("eedi3", "GRAYS", {"field": 1, "mdis": 4, "hp": True, "mclip": True}),
    # rows near 1e37 saturate every cost at BIG: B9's directions then walk
    # far past +-2*mdis, and B10 takes them as the plain version does
    ("eedi3", "GRAYS", {"field": 1, "hp": True, "mdis": 3, "vcheck": 1, "scale": 1e37}),
    ("eedi3", "GRAYS", {"field": 1, "hp": True, "mdis": 3, "vcheck": 2, "scale": 1e37}),
    ("eedi3", "GRAYS", {"field": 1, "hp": True, "mdis": 3, "vcheck": 3, "scale": 1e37}),
], ids=str)
def test_eedi3_on_card_matches_cpu(cuda, fn, fmt, args):
    rng = np.random.default_rng(8)
    f = vt.get_format(fmt)
    args = dict(args)
    scale = np.float32(args.pop("scale", 1.0))
    planes = [rng.random((2,) + f.plane_dims(96, 64, p)[::-1], dtype=np.float32) * scale
              for p in range(f.num_planes)]
    cpu = vt.Clip.from_planes(planes, f, device="cpu")
    mclip = None
    if args.pop("mclip", False):
        m = (rng.random((2, 64, 96)) > 0.4).astype(np.uint8) * 255
        mclip = vt.Clip.from_planes([m], vt.get_format("GRAY8"), device="cpu")
        args["mclip"] = mclip
    trace.reset_launches()
    card_args = dict(args, mclip=mclip.to(cuda)) if mclip is not None else args
    got = getattr(vt, fn)(cpu.to(cuda), **card_args)
    hp_mask = args.get("hp") and mclip is not None
    assert sum(ke.LAUNCHES.values()) > 0 or hp_mask
    want = getattr(vt, fn)(cpu, **args)
    for g, w in zip(got.planes, want.planes):
        assert g.is_cuda and _same(g.cpu(), w)


def test_eedi3_wrappers_reject_what_kernels_do_not_take(cuda):
    rows = _eedi3_rows(1, 2, 40, 0, cuda)
    with pytest.raises(ValueError, match="rows"):
        ke.eedi3_fused(*rows, 41, 3, 1, 0.1, 0.1, 0.1, 0.8)
    with pytest.raises(ValueError, match="mdis"):
        ke.eedi3_fused_hp(*rows, 40, 41, 1, 0.1, 0.1, 0.1, 0.8)
    with pytest.raises(ValueError, match="mask"):
        ke.eedi3_fused(*rows, 40, 3, 1, 0.1, 0.1, 0.1, 0.8,
                       torch.ones((1, 2, 40), dtype=torch.uint8, device=cuda))
    x = _rand((1, 16, 16), torch.uint8, cuda)
    tab = torch.zeros((1, 2, 512), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="cover"):
        kc.clahe8_lookup(x, tab, torch.zeros((2, 8), device=cuda),
                         torch.zeros((1, 16), device=cuda), 8, 8)


# ---------------------------------------------------------------------------
# XPSNR (B11, B12) and SSIMULACRA2 (B13)
# ---------------------------------------------------------------------------

CHROMA_BLOCKS = ((32, 32), (64, 32), (16, 16), (64, 64), (32, 64), (8, 16), (3, 7))


# B11 gives a warp each 64x64 block and a lane two columns, one load of both
# where W is even and the planes are on their pair's bytes (pair_loads), else
# one load a column.  uint16 at 10 bits and at the full range, uint8; H and
# W on and off 64, odd W, 1-3 frames (missing previous frames), planes with
# no interior
@pytest.mark.parametrize("dtype,peak", [(torch.uint16, 1024), (torch.uint16, 65536),
                                        (torch.uint8, 256)], ids=str)
@pytest.mark.parametrize("shape", [(3, 150, 256), (4, 1080, 1920), (2, 70, 131), (1, 3, 5),
                                   (2, 131, 66), (3, 2, 2), (1, 64, 64), (2, 65, 130)],
                         ids=str)
def test_xpsnr_kernels_match_plain(cuda, shape, dtype, peak):
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    org, rec = (torch.randint(0, peak, shape, generator=g, device=cuda, dtype=torch.int32)
                .to(dtype) for _ in range(2))
    for order, temporal in ((1, True), (2, True), (1, False), (2, False)):
        for k, r in zip(kx.luma_stats(org, rec, order, temporal),
                        kx.luma_stats_ref(org, rec, order, temporal)):
            assert k.dtype == torch.float64 and _same(k, r)
    # B12: a warp per strip of 8-byte lanes (4:2:0, 4:2:2, 4:4:4 and 4:4:0
    # blocks, and two narrower), the block path at (3, 7); one plane, both
    # planes in one launch, and org at the peak against rec 0
    top, zero = torch.full_like(org, peak - 1), torch.zeros_like(org)
    for by, bx in CHROMA_BLOCKS:
        assert _same(kx.chroma_sse(org, rec, by, bx), kx.chroma_sse_ref(org, rec, by, bx))
        assert _same(kx.chroma_sse(top, zero, by, bx), kx.chroma_sse_ref(top, zero, by, bx))
        uv = kx.chroma_sse_uv(org, rec, rec, top, by, bx)
        assert uv.dtype == torch.float64
        assert _same(uv, kx.chroma_sse_uv_ref(org, rec, rec, top, by, bx))


def _extreme_planes(shape, peak, device):
    """The largest block sums B11's accumulators meet: org at peak - 1 on
    even rows and columns, 0 elsewhere (|Laplacian| 12 (peak - 1) there),
    and its inverse on odd frames (|org - 2 p1 + p2| 2 (peak - 1)); rec the
    inverse of org ((org - rec)^2 = (peak - 1)^2)."""
    n, h, w = shape
    dots = ((torch.arange(h, device=device) % 2 == 0).view(h, 1)
            & (torch.arange(w, device=device) % 2 == 0).view(1, w))
    odd = (torch.arange(n, device=device) % 2 == 1).view(n, 1, 1)
    org = torch.where(dots ^ odd, peak - 1, 0).to(torch.int32)
    return org, peak - 1 - org


@pytest.mark.parametrize("dtype,peak", [(torch.uint16, 65536), (torch.uint8, 256)], ids=str)
@pytest.mark.parametrize("shape", [(3, 128, 192), (3, 1080, 1920), (2, 67, 131)], ids=str)
def test_xpsnr_luma_kernel_at_its_accumulators_bounds(cuda, shape, dtype, peak):
    org, rec = (t.to(dtype) for t in _extreme_planes(shape, peak, cuda))
    for order in (1, 2):
        for k, r in zip(kx.luma_stats(org, rec, order, True),
                        kx.luma_stats_ref(org, rec, order, True)):
            assert _same(k, r)


def test_xpsnr_luma_kernel_takes_planes_off_their_pairs(cuda):
    # planes one element past their pair's alignment: one load a column
    org, rec = (_rand((2, 70, 130), torch.uint16, cuda, seed) for seed in (1, 2))
    base = torch.empty(org.numel() + 1, dtype=torch.uint16, device=cuda)
    off = base[1:].view(org.shape)
    off.copy_(org)
    assert not kx.pair_loads(130, 2, off.data_ptr(), rec.data_ptr())
    assert kx.pair_loads(130, 2, org.data_ptr(), rec.data_ptr())
    for order, temporal in ((1, True), (2, True)):
        for k, r in zip(kx.luma_stats(off, rec, order, temporal),
                        kx.luma_stats_ref(org, rec, order, temporal)):
            assert _same(k, r)


@pytest.mark.parametrize("dtype", [torch.uint16, torch.uint8], ids=str)
def test_xpsnr_chroma_kernel_takes_planes_off_their_wide_loads(cuda, dtype):
    # rows a whole number of lanes wide, one plane of the launch 2 bytes (u8:
    # 1) past 8: one load a column, for both planes
    org, rec = (_rand((2, 70, 960), dtype, cuda, seed) for seed in (1, 2))
    base = torch.empty(org.numel() + 1, dtype=dtype, device=cuda)
    off = base[1:].view(org.shape)
    off.copy_(org)
    assert not kx.wide_loads(960, org.element_size(), rec.data_ptr(), off.data_ptr())
    assert kx.wide_loads(960, org.element_size(), rec.data_ptr(), org.data_ptr())
    for by, bx in CHROMA_BLOCKS:
        want = kx.chroma_sse_uv_ref(rec, org, org, rec, by, bx)
        assert _same(kx.chroma_sse_uv(rec, off, off, rec, by, bx), want)
        assert _same(kx.chroma_sse(off, rec, by, bx), want[1])


def _ssim_inputs(shape, device):
    """B13's input pairs: uniform noise, identical planes (every error map
    value is +-0, the SSIM map 0), and both near 0 and near 1e3."""
    g = torch.Generator(device=device).manual_seed(sum(shape))
    im1, im2 = (torch.rand(shape, generator=g, device=device) for _ in range(2))
    return [("noise", im1, im2), ("identical", im1, im1.clone()),
            ("near 0", im1 * 1e-6, im2 * 1e-6), ("near 1e3", im1 + 1e3, im2 + 1e3)]


# B13 gives a warp 8 rows of a band (64 rows, 32 past 2560 columns) and 2
# columns a lane (strips of 56 columns) or, on small planes, 1 (strips of
# 24); warps within 4 rows of the top or bottom and strips within 4 columns
# of the left or right take the edge rule by tap_index.  Heights around
# the bands and the warps' rows, widths around both strip widths and the
# first strip that touches no edge (W 52 and 116), each variant forced and
# the wrapper's choice
@pytest.mark.parametrize("shape", [(2, 130, 131), (2, 1080, 1920), (1, 100, 2600), (1, 16, 16),
                                   (3, 67, 241), (1, 17, 17), (3, 40, 2561)]
                         + [(n, h, 40) for n, h in ((1, 19), (3, 20), (1, 21), (3, 63), (1, 64),
                                                    (3, 65), (1, 127), (3, 128), (1, 129))]
                         + [(1 + 2 * (w % 2), 24, w) for w in (23, 24, 25, 51, 52, 53, 55, 56,
                                                               57, 111, 112, 113, 115, 116,
                                                               117)], ids=str)
def test_ssim_kernel_matches_plain(cuda, shape):
    for name, im1, im2 in _ssim_inputs(shape, cuda):
        for ns, ne in ((True, True), (True, False), (False, True)):
            want = ks.ssim_partials_ref(im1, im2, ns, ne)
            cpu = ks.ssim_partials_ref(im1.cpu(), im2.cpu(), ns, ne)
            for cols in (None, 2, 1):
                part = ks.ssim_partials(im1, im2, ns, ne, cols)
                assert _same(part, want), (name, ns, ne, cols)
                if name == "identical":
                    # d is +0.0 everywhere, so detail = max(-d, 0) is torch's
                    # clamp of -0.0: -0.0 on the CPU, +0.0 on the card (fmaxf),
                    # and a full band's detail sum keeps that sign; + 0.0 maps
                    # only -0.0 to +0.0 and leaves every other value as it is
                    assert _same(part.cpu() + 0.0, cpu + 0.0), (name, ns, ne, cols)
                else:
                    assert _same(part.cpu(), cpu), (name, ns, ne, cols)
            torch.testing.assert_close(ks.ssim_sums(im1, im2, ns, ne).cpu(), ks.fold(cpu),
                                       rtol=1e-12, atol=0)


@pytest.mark.parametrize("n,h,w,sms,cols", [
    # 1080p luma and the scale-1 planes of 8 frames: 4760 and 1296 blocks of
    # 56 columns x 64 rows, at least seven an SM of 132
    (8, 1080, 1920, 132, 2), (8, 540, 960, 132, 2),
    # scales 2-4: 360, 120 and 48 blocks
    (8, 270, 480, 132, 1), (8, 135, 240, 132, 1), (8, 68, 120, 132, 1),
    # both sides of seven blocks an SM; 32-row bands past 2560 columns
    (923, 16, 56, 132, 1), (924, 16, 56, 132, 2), (1, 100, 2600, 1, 2), (1, 64, 2600, 40, 1),
], ids=str)
def test_ssim_lane_columns_takes_the_narrow_strips_below_seven_blocks_an_sm(cuda, n, h, w, sms,
                                                                           cols):
    assert ks.lane_columns(n, h, w, sms) == cols


def test_ssim_kernel_variants_on_both_sides_of_their_thresholds(cuda):
    # the launcher: 2 columns a lane from seven blocks (a 16x56 frame is one)
    # per SM; 8-byte loads where W is even and both planes are on 8 bytes
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(7)
    for n in (7 * sms - 1, 7 * sms):
        assert ks.lane_columns(n, 16, 56, sms) == (2 if n == 7 * sms else 1)
        im1, im2 = (torch.rand((n, 16, 56), generator=g, device=cuda) for _ in range(2))
        assert _same(ks.ssim_partials(im1, im2, True, True),
                     ks.ssim_partials_ref(im1, im2, True, True))
    for w in (480, 481, 482, 483):
        im1, im2 = (torch.rand((2, 70, w), generator=g, device=cuda) for _ in range(2))
        for a, b in ((im1, im2), (_offset(im1), im2), (im1, _offset(im2))):
            for ns, ne in ((True, True), (False, True)):
                want = ks.ssim_partials_ref(a, b, ns, ne)
                for cols in (2, 1):
                    assert _same(ks.ssim_partials(a, b, ns, ne, cols), want), (w, cols)
    with pytest.raises(ValueError, match="cols"):
        ks.ssim_partials(im1, im2, True, True, 4)


def _metric_clip(fmt, n, h, w, seed, device):
    rng = np.random.default_rng(seed)
    f = vt.get_format(fmt)
    if f.sample_type is vt.SampleType.FLOAT:
        a = [rng.random((n,) + f.plane_dims(w, h, p)[::-1], dtype=np.float32) for p in range(3)]
        b = [np.clip(p + np.float32(0.01), 0, 1).astype(np.float32) for p in a]
    else:
        peak = (1 << f.bits_per_sample) - 1
        a = [rng.integers(0, peak + 1, (n,) + f.plane_dims(w, h, p)[::-1]).astype(f.storage_dtype)
             for p in range(3)]
        b = [np.clip(p.astype(np.int64) + rng.integers(-8, 8, p.shape), 0, peak)
             .astype(f.storage_dtype) for p in a]
    return (vt.Clip.from_planes(a, f, device=device), vt.Clip.from_planes(b, f, device=device))


@pytest.mark.parametrize("fmt,h,w,fps,launches", [
    ("YUV420P10", 1080, 1920, 24, (1, 1)),
    ("YUV420P8", 1080, 1920, 60, (1, 1)),
    ("YUV422P10", 1080, 1920, 24, (1, 1)),
    ("YUV420P10", 1440, 2560, 24, (0, 0)),
    ("YUV420P8", 480, 640, 24, (0, 0)),
    ("YUV420P10", 32, 40, 24, (0, 0)),
], ids=str)
def test_xpsnr_on_card_matches_cpu(cuda, fmt, h, w, fps, launches):
    c1, c2 = _metric_clip(fmt, 3, h, w, 1, "cpu")
    trace.reset_launches()
    got = vt.xpsnr(c1.to(cuda), c2.to(cuda), fps=fps)
    assert (kx.LAUNCHES["luma_stats"], kx.LAUNCHES["chroma_sse"]) == launches
    want = vt.xpsnr(c1, c2, fps=fps)
    assert got.props["_XPSNR_WSSE"].is_cuda
    assert _same(got.props["_XPSNR_WSSE"].cpu(), want.props["_XPSNR_WSSE"])
    for k in ("XPSNR_Y", "XPSNR_U", "XPSNR_V", "XPSNR_AVG"):
        torch.testing.assert_close(got.props[k].cpu(), want.props[k], rtol=1e-12, atol=0)


@pytest.mark.parametrize("layout", ["crop", "transposed"])
def test_xpsnr_on_card_takes_strided_planes(cuda, layout):
    # a caller's views reach the op as they are: a crop of wider planes, or
    # planes stored transposed; the op hands B11/B12 contiguous copies
    c1, c2 = _metric_clip("YUV420P10", 3, 1080, 1920, 4, "cpu")

    def strided(c):
        planes = []
        for p in c.planes:
            if layout == "crop":
                wide = torch.zeros(p.shape[:2] + (p.shape[2] + 8,), dtype=p.dtype, device=cuda)
                wide[..., 4:-4] = p.to(cuda)
                planes.append(wide[..., 4:-4])
            else:
                planes.append(p.transpose(1, 2).contiguous().to(cuda).transpose(1, 2))
        assert not any(q.is_contiguous() for q in planes)
        return vt.Clip.from_planes(planes, c.format, device=cuda)

    trace.reset_launches()
    got = vt.xpsnr(strided(c1), strided(c2), fps=24)
    assert (kx.LAUNCHES["luma_stats"], kx.LAUNCHES["chroma_sse"]) == (1, 1)
    want = vt.xpsnr(c1, c2, fps=24)
    assert _same(got.props["_XPSNR_WSSE"].cpu(), want.props["_XPSNR_WSSE"])
    for k in ("XPSNR_Y", "XPSNR_U", "XPSNR_V", "XPSNR_AVG"):
        torch.testing.assert_close(got.props[k].cpu(), want.props[k], rtol=1e-12, atol=0)


@pytest.mark.parametrize("fmt,h,w,props,launches,rtol", [
    ("RGBS", 1080, 1920, {}, 11, 1e-6),
    ("RGBS", 200, 260, {"_Transfer": 8}, 8, 1e-9),
    ("YUV420P16", 120, 176, {"_Matrix": 1}, 5, 1e-6),
], ids=str)
def test_ssimulacra2_on_card_matches_cpu(cuda, fmt, h, w, props, launches, rtol):
    c1, c2 = _metric_clip(fmt, 1, h, w, 2, "cpu")
    c1, c2 = c1.with_props(**props), c2.with_props(**props)
    trace.reset_launches()
    got = vt.ssimulacra2(c1.to(cuda), c2.to(cuda)).props["SSIMULACRA2"]
    assert ks.LAUNCHES["ssim_sums"] == launches
    want = vt.ssimulacra2(c1, c2).props["SSIMULACRA2"]
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=0)


def test_identical_ssimulacra2_on_card_is_100(cuda):
    c1, _ = _metric_clip("RGBS", 2, 1080, 1920, 3, cuda)
    trace.reset_launches()
    out = vt.ssimulacra2(c1, c1).props["SSIMULACRA2"]
    assert ks.LAUNCHES["ssim_sums"] == 11
    assert out.cpu().tolist() == [100.0, 100.0]


def test_metric_wrappers_reject_what_kernels_do_not_take(cuda):
    x = _rand((2, 64, 64), torch.uint16, cuda)
    with pytest.raises(ValueError, match="uint8/uint16"):
        kx.luma_stats(x.to(torch.int32), x.to(torch.int32), 1, True)
    with pytest.raises(ValueError, match="planes differ"):
        kx.chroma_sse(x, x[:1], 32, 32)
    with pytest.raises(ValueError, match="planes differ"):
        kx.chroma_sse_uv(x, x, x[:1], x[:1], 32, 32)
    with pytest.raises(ValueError, match="blocks >= 1"):
        kx.chroma_sse_uv(x, x, x, x, 0, 32)
    with pytest.raises(ValueError, match="order 1 or 2"):
        kx.luma_stats(x, x, 3, True)
    f = torch.rand((1, 32, 32), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        ks.ssim_partials(f, f.double(), True, True)
    with pytest.raises(ValueError, match="contiguous"):
        ks.ssim_partials(f.transpose(1, 2), f, True, True)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
def test_boxblur_rows_wider_than_shared_memory(cuda, dtype):
    # 65,536 columns: one row (with its mirror pad) outgrows a block's shared
    # memory, so h_fixed keeps it in a global scratch buffer
    x = _rand((1, 4, 65536), dtype, cuda, seed=5)
    fmt = vt.get_format("GRAY8" if dtype == torch.uint8 else "GRAY16")
    c = vt.Clip.from_planes([x], fmt, device=cuda)
    for args, launches in (({"hradius": 13, "vradius": 1}, {"rt_blur_h": 1, "rt_blur_v": 1}),
                           ({"hradius": 13, "hpasses": 5, "vradius": 1},
                            {"rt_blur_h": 1, "rt_blur_v": 1}),
                           ({"hradius": 1, "vradius": 1}, {"ct_blur_int": 1})):
        trace.reset_launches()
        got = vt.boxblur(c, **args).planes[0]
        assert {k: n for k, n in kb.LAUNCHES.items() if n} == launches
        assert _same(got.cpu(), vt.boxblur(c.to("cpu"), **args).planes[0])
    for p in (1, 5):
        assert _same(kb.rt_blur_h(x, 13, p), kb.h_fixed_ref(x, 13, p))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("w", [1, 2, 31, 33, 1920, 3840, 9000])
def test_h_fixed_matches_plain_at_segment_edges(cuda, dtype, w):
    # h_fixed cuts each padded row (w + 2r samples) into segments of 8, one
    # per thread of a block of up to 1024 (more rounds past 8192 samples);
    # widths not a multiple of 8 end on a partial segment and take scalar
    # loads and stores; radii past the width take the comptime quirk's
    # periodic mirror
    x = _rand((2, 96, w), dtype, cuda, seed=w)
    for r in (1, 13, 40, 500):
        if r >= w and r != 40:
            continue
        for p in (1, 2, 3, 4, 5):
            assert _same(kb.rt_blur_h(x, r, p), kb.h_fixed_ref(x, r, p)), (r, p)
        if r < 48:  # the vertical window must fit the 96 rows
            assert _same(kb.ct_blur_int(x, r), kb.ct_blur_int_ref(x, r)), r


def _widest_in_registers(r, passes):
    w = r
    while kb.h_fixed_in_registers(w + 1, r, passes):
        w += 1
    return w


def _h_fixed_variant(w, r, passes):
    return "h_fixed_warp" if kb.h_fixed_in_registers(w, r, passes) else "h_fixed_shared"


# h_fixed one warp a row in registers (h_fixed_kernel<T, kSlots, kChunks>):
# lanes hold runs of n = 2r + 1 samples in chunks of 4, 8, 16, 24, 28, 32 or
# 48 registers (H_WARP_RUNS), so each run of radii ends where the next begins
# (r 1 | 2-3 | 4-7 | 8-11 | 12-13 | 14-15 | 16-23 | 24: the block design); the rows
# it takes end at the widest whose runs, with passes * r samples of margin
# on each side, fit the lanes (one sample wider takes the block design);
# the rows are read and written by 16-byte copies where w * size % 16 == 0
# and the plane is on 16 bytes, by elements else (offset views)
@pytest.mark.parametrize("layout", ["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("r", [1, 2, 3, 4, 7, 8, 11, 12, 13, 14, 15, 16, 23, 24])
def test_h_fixed_warp_matches_plain_at_its_edges(cuda, r, dtype, layout):
    widths = sorted({w for p in (1, 6) for w in (_widest_in_registers(r, p),
                                                  _widest_in_registers(r, p) + 1)} | {1920})
    for w in widths:
        x = _rand((2, 5, w), dtype, cuda, seed=w + r)
        if layout == "offset":
            x = _offset(x)
        for p in range(1, 7):
            trace.reset_launches()
            got = kb.rt_blur_h(x, r, p)
            variant = _h_fixed_variant(w, r, p)
            assert kb.VARIANTS[variant] == 1 and sum(kb.VARIANTS.values()) == 1, (w, p)
            assert _same(got, kb.h_fixed_ref(x, r, p)), (w, p, variant)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("w,r", [(1, 1), (2, 1), (5, 5), (5, 6), (12, 13), (23, 23), (22, 23)],
                         ids=str)
def test_h_fixed_warp_leaves_windows_wider_than_the_row_to_the_block_design(cuda, dtype, w, r):
    # r <= w runs in registers; r > w is the comptime quirk's periodic mirror
    x = _rand((3, 4, w), dtype, cuda, seed=r)
    for p in range(1, 7):
        trace.reset_launches()
        got = kb.rt_blur_h(x, r, p)
        assert kb.VARIANTS[_h_fixed_variant(w, r, p)] == 1
        assert (r <= w) is kb.h_fixed_in_registers(w, r, p)
        assert _same(got, kb.h_fixed_ref(x, r, p)), p


# vz_h_fixed_warp runs the register design on the shape the wrapper chose
# (kb.h_fixed_warp_shape); a shape that does not hold the row would write past
# a warp's row buffer, so the library refuses it (cudaErrorInvalidValue).
# Each refused case breaks one condition on its own: (w, r, passes, slots,
# chunks, l0, a); the rule's own shapes at 1080p and at the last sample the
# lanes hold run and equal the plain version
@pytest.mark.parametrize("w,r,passes,slots,chunks,l0,a,holds", [
    (1920, 13, 5, 28, 3, 1, 94, True),
    (2433, 13, 5, 28, 3, 1, 94, True),
    (1920, 13, 5, 30, 3, 1, 94, False),    # slots not a run
    (1920, 13, 5, 24, 3, 1, 94, False),    # n = 27 past the run's slots
    (1920, 13, 5, 32, 3, 1, 94, False),    # not the first run taking n
    (1920, 13, 5, 28, 4, 1, 121, False),   # more chunks than the run has
    (1920, 13, 5, 28, 3, 1, 95, False),    # a != l0 * chunks * n + r
    (1920, 13, 5, 28, 3, 0, 13, False),    # a < passes * r
    (2434, 13, 5, 28, 3, 1, 94, False),    # a + w + passes * r past the lanes
    (12, 13, 1, 28, 1, 0, 13, False),      # r > w
], ids=["1080p", "last_sample", "slots", "n_past_slots", "first_run", "chunks", "a_l0",
        "margin_before", "margin_after", "r_past_w"])
def test_h_fixed_warp_refuses_shapes_that_do_not_hold_the_row(cuda, w, r, passes, slots,
                                                              chunks, l0, a, holds):
    x = _rand((2, 3, w), torch.uint16, cuda, seed=w)
    out = torch.zeros_like(x)

    def launch():
        kb._H_FIXED_WARP(x.device, x.data_ptr(), out.data_ptr(), 2, 6, w, r, passes, slots,
                         chunks, l0, a)
    if holds:
        assert kb.h_fixed_warp_shape(w, r, passes) == (slots, 3, chunks, l0, a)
        launch()
        assert _same(out, kb.h_fixed_ref(x, r, passes))
    else:
        with pytest.raises(RuntimeError, match="vz_h_fixed_warp failed with CUDA error 1$"):
            launch()
        torch.cuda.synchronize()
        assert int(out.count_nonzero()) == 0


@pytest.mark.parametrize("case", ["ct_blur", "v_chip", "ct_v_chip", "m2_tile"])
def test_a_failing_entry_point_raises_naming_its_symbol(cuda, case):
    """An entry point that returns a CUDA error raises RuntimeError naming its
    symbol and the code (here cudaErrorInvalidValue: a ring one row short
    of B1's one-launch shape, more passes than v_chip unrolls, a ring or
    tile past a block's shared memory)."""
    x = _rand((1, 64, 64), torch.uint16, cuda, seed=3)
    out = torch.empty_like(x)
    key = torch.zeros((64, 64), dtype=torch.int32, device=cuda)
    centre = torch.empty((1, 64, 64), dtype=torch.int32, device=cuda)
    symbol, launch = {
        "ct_blur": ("vz_ct_blur", lambda: kb._CT_BLUR(
            x.device, x.data_ptr(), out.data_ptr(), 2, 1, 64, 64, 13, 1, 28, 1, 42, 880,
            kb.ct_blur_multiplier(13))),
        "v_chip": ("vz_v_chip", lambda: kb._V_CHIP(
            x.device, x.data_ptr(), out.data_ptr(), 2, 1, 64, 64, 2, kb.V_CHIP_PASSES + 1)),
        "ct_v_chip": ("vz_ct_v_chip", lambda: kb._CT_V_CHIP(
            x.device, x.data_ptr(), out.data_ptr(), 2, 1, 64, 64, 898, *kb.quantizer(897))),
        "m2_tile": ("vz_deband_m2_tile", lambda: kd._M2_TILE(
            x.device, x.data_ptr(), key.data_ptr(), centre.data_ptr(), 1, 64, 64, 51, 1, 2)),
    }[case]
    with pytest.raises(RuntimeError, match=f"^vszip_tpu_torch: {symbol} failed with CUDA "
                       "error 1$"):
        launch()


def _smooth_u8(shape, device, seed):
    """A smooth moving pattern, noise of +-3 and a band of combed rows."""
    n, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.arange(h, device=device).view(1, h, 1).float()
    x = torch.arange(w, device=device).view(1, 1, w).float()
    f = torch.arange(n, device=device).view(n, 1, 1).float()
    v = 128 + 60 * torch.sin(x / 37 + f / 5) * torch.cos(y / 23)
    v = v + torch.randint(-3, 4, shape, generator=g, device=device)
    v[:, h // 3:2 * h // 3:2] += 40
    return v.clamp(0, 255).to(torch.uint8)


_compress_op = importlib.import_module("vszip_tpu_torch.ops.compress")
_COMPRESS = [("mpeg2", 8, 0, 50), ("mpeg2", 1, 0, 50), ("mpeg2", 2, 3, 50), ("mpeg2", 31, 1, 50),
             ("jpeg", 8, 0, 1), ("jpeg", 8, 0, 50), ("jpeg", 8, 0, 80), ("jpeg", 8, 0, 95),
             ("jpeg", 8, 0, 100)]


@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 1, 1), (3, 9, 300), (2, 540, 960)], ids=str)
def test_compress_kernel_matches_plain(cuda, shape):
    regimes = set()
    for x in (_rand(shape, torch.uint8, cuda, seed=2), _smooth_u8(shape, cuda, 2)):
        for codec, qscale, dc_prec, quality in _COMPRESS:
            for chroma in (False, True):
                qa, qb, wide, _ = _compress_op._quant_setup(codec, qscale, dc_prec, quality,
                                                            chroma)
                a = (x, qa, qb, codec == "jpeg", dc_prec, wide)
                assert _same(kz.compress_plane(*a), kz.compress_plane_ref(*a))
                regimes.add(wide)
    assert regimes == {False, True}


# B14 runs one thread per 8x8 block, its rows as 8-byte words where w % 8 == 0
# and the planes are on 8 bytes, else as clamped bytes: heights and widths
# around 8, 16, 256, 960 and 1920, aligned and not, on 1 and 3 frames
@pytest.mark.parametrize("h,w", [(h, 24) for h in range(1, 10)] + [(9, w) for w in range(1, 10)]
                         + [(h, 17) for h in (15, 16, 17, 255, 256, 257)]
                         + [(16, w) for w in (15, 16, 17, 255, 256, 257, 959, 960, 961, 1919,
                                              1920, 1921)]
                         + [(h, 64) for h in (959, 960, 961, 1080)]
                         + [(1080, w) for w in (1919, 1920, 1921)], ids=str)
def test_compress_kernel_matches_plain_at_block_edges(cuda, h, w):
    shape = (3 if (h + w) % 2 else 1, h, w)
    for x in (_rand(shape, torch.uint8, cuda, seed=h + w), _smooth_u8(shape, cuda, h)):
        for codec, qscale, dc_prec, quality in _COMPRESS:
            for chroma in (False, True):
                qa, qb, wide, _ = _compress_op._quant_setup(codec, qscale, dc_prec, quality,
                                                            chroma)
                a = (x, qa, qb, codec == "jpeg", dc_prec, wide)
                assert _same(kz.compress_plane(*a), kz.compress_plane_ref(*a)), (
                    codec, qscale, dc_prec, quality, chroma)


def test_compress_kernel_takes_planes_off_8_byte_alignment(cuda):
    """A plane that starts one byte past an aligned address: rows of 256
    bytes, but clamped byte loads and byte stores."""
    n, h, w = 3, 40, 256
    flat = _smooth_u8((1, 1, n * h * w + 1), cuda, 7).view(-1)
    x = flat[1:].view(n, h, w)
    assert x.is_contiguous() and x.data_ptr() % 8 == 1
    for codec, qscale, dc_prec, quality in _COMPRESS:
        qa, qb, wide, _ = _compress_op._quant_setup(codec, qscale, dc_prec, quality, False)
        a = (x, qa, qb, codec == "jpeg", dc_prec, wide)
        assert _same(kz.compress_plane(*a), kz.compress_plane_ref(*a))


@pytest.mark.parametrize("shape", [(3, 37, 53), (1, 5, 3), (2, 5, 300), (5, 540, 960)], ids=str)
def test_checkmate_kernel_matches_plain(cuda, shape):
    for x in (_rand(shape, torch.uint8, cuda, seed=3), _smooth_u8(shape, cuda, 3)):
        for thr, tmax, tthr2 in ((12, 12, 0), (12, 12, 10), (0, 1, 0), (255, 255, 3),
                                 (20, 30, 255)):
            assert _same(kk.checkmate(x, thr, tmax, tthr2), kk.checkmate_ref(x, thr, tmax, tthr2))


# B16: metric 0/1 x motion off/on x expand off/on at cthresh 6, and the
# thresholds' ends (metric 0 passes nothing from 255 up)
_COMB = [(6, mt, m1, ex) for m1 in (False, True) for mt in (0, 9) for ex in (False, True)] + [
    (65025, 9, True, True), (0, 0, True, False), (255, 255, False, True), (0, 1, False, True),
    (254, 9, False, True), (1000, 9, False, True), (100, 9, True, False)]


# a warp owns 120 output columns (4 per lane; lanes 0 and 31 read the
# columns either side), a block 4 warps, a band of 8 rows, a run of 4
# frames: widths, heights and frame counts around them (w % 4 != 0: byte
# loads and stores)
@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 3, 1), (2, 3, 2), (1, 4, 3), (2, 9, 300),
                                   (3, 540, 960)]
                         + [(3, 37, w) for w in (1, 2, 3, 4, 5, 119, 120, 121, 239, 240, 241,
                                                 479, 480, 481, 1921)]
                         + [(3, h, 130) for h in (3, 4, 5, 7, 8, 9, 15, 16, 17)]
                         + [(n, 19, 130) for n in (1, 2, 3, 4, 5, 8, 9, 65)], ids=str)
def test_comb_mask_kernel_matches_plain(cuda, shape):
    for x in (_rand(shape, torch.uint8, cuda, seed=4), _smooth_u8(shape, cuda, 4)):
        for cthresh, mthresh, metric_1, expand in _COMB:
            assert _same(km.comb_mask(x, cthresh, mthresh, metric_1, expand),
                         km.comb_mask_ref(x, cthresh, mthresh, metric_1, expand)), (
                cthresh, mthresh, metric_1, expand)


def test_comb_mask_kernel_takes_planes_off_16_byte_alignment(cuda):
    """A plane that starts one byte past an aligned address: rows of 256
    bytes, but byte loads and stores."""
    n, h, w = 9, 40, 256
    flat = _smooth_u8((1, 1, n * h * w + 1), cuda, 6).view(-1)
    x = flat[1:].view(n, h, w)
    assert x.is_contiguous() and x.data_ptr() % 16 == 1
    for cthresh, mthresh, metric_1, expand in _COMB:
        assert _same(km.comb_mask(x, cthresh, mthresh, metric_1, expand),
                     km.comb_mask_ref(x, cthresh, mthresh, metric_1, expand))


# B15's tiles are 128 columns x 32 rows over runs of 8 frames: frames,
# widths (w % 4 and w % 16 not 0: byte loads and stores) and heights around
# them
@pytest.mark.parametrize("shape", [(n, 37, 130) for n in (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17,
                                                          64)]
                         + [(3, 9, w) for w in (1, 2, 3, 4, 5, 127, 128, 129, 255, 256, 257,
                                                1921)]
                         + [(3, h, w) for h in (5, 6, 31, 32, 33) for w in (256, 257)]
                         + [(40, 40, 1920)], ids=str)
def test_checkmate_kernel_matches_plain_at_tile_edges(cuda, shape):
    for x in (_rand(shape, torch.uint8, cuda, seed=5), _smooth_u8(shape, cuda, 5)):
        for thr, tmax, tthr2 in ((12, 12, 0), (12, 12, 10), (0, 1, 0), (255, 255, 3),
                                 (20, 30, 255)):
            assert _same(kk.checkmate(x, thr, tmax, tthr2), kk.checkmate_ref(x, thr, tmax, tthr2))


def test_checkmate_kernel_takes_planes_off_16_byte_alignment(cuda):
    """A plane that starts one byte past an aligned address: rows of 256
    bytes, but byte loads and stores."""
    n, h, w = 5, 40, 256
    flat = _smooth_u8((1, 1, n * h * w + 1), cuda, 6).view(-1)
    x = flat[1:].view(n, h, w)
    assert x.is_contiguous() and x.data_ptr() % 16 == 1
    for tthr2 in (0, 10):
        assert _same(kk.checkmate(x, 12, 12, tthr2), kk.checkmate_ref(x, 12, 12, tthr2))


@pytest.mark.parametrize("op,fmt,args,launches", [
    ("compress", "YUV420P8", {}, {"compress_plane": 3}),
    ("compress", "YUV420P8", {"codec": 1, "quality": 95}, {"compress_plane": 3}),
    ("compress", "YUV420P8", {"qscale": 2, "dc_prec": 3}, {"compress_plane": 3}),
    ("compress", "YUV444P8", {"chroma": False}, {"compress_plane": 1}),
    ("checkmate", "YUV420P8", {}, {"checkmate": 3}),
    ("checkmate", "GRAY8", {"tthr2": 10}, {"checkmate": 1}),
    ("comb_mask", "YUV420P8", {}, {"comb_mask": 3}),
    ("comb_mask", "GRAY8", {"metric": True, "cthresh": 65025}, {"comb_mask": 1}),
    ("comb_mask", "YUV444P8", {"mthresh": 0, "expand": False}, {"comb_mask": 3}),
    ("comb_mask_mt", "YUV420P8", {"thY1": 10, "thY2": 200}, {}),
], ids=str)
@pytest.mark.parametrize("layout", ["contiguous", "crop"])
def test_integer_filters_on_card_match_cpu(cuda, op, fmt, args, launches, layout):
    f = vt.get_format(fmt)
    h, w = 38, 54
    planes = []
    for p in range(f.num_planes):
        pw, ph = f.plane_dims(w, h, p)
        # a crop of a wider plane is not contiguous; the ops take it as it is
        big = _smooth_u8((4, ph, pw + 6), cuda, p)
        planes.append(big[..., 3:-3] if layout == "crop" else big[..., 3:-3].contiguous())
    c = vt.Clip.from_planes(planes, f, device=cuda)
    for m in (kz, kk, km):
        trace.reset_launches()
    got = getattr(vt, op)(c, **args)
    counts = {k: n for m in (kz, kk, km) for k, n in m.LAUNCHES.items() if n}
    assert counts == launches
    want = getattr(vt, op)(c.to("cpu"), **args)
    for g, w_ in zip(got.planes, want.planes):
        assert g.is_cuda and _same(g.cpu(), w_)


def test_integer_filter_wrappers_reject_what_kernels_do_not_take(cuda):
    x = _rand((2, 16, 16), torch.uint8, cuda)
    qa, qb, _, _ = _compress_op._quant_setup("mpeg2", 8, 0, 50, False)
    with pytest.raises(ValueError, match="contiguous"):
        kz.compress_plane(x.transpose(1, 2), qa, qb, False, 0, False)
    with pytest.raises(ValueError, match="64"):
        kz.compress_plane(x, qa[:10], qb, False, 0, False)
    with pytest.raises(ValueError, match="uint8"):
        kk.checkmate(x.to(torch.int32), 12, 12, 0)
    with pytest.raises(ValueError, match="does not take"):
        kk.checkmate(x[:, :4].contiguous(), 12, 12, 0)
    with pytest.raises(ValueError, match="does not take"):
        km.comb_mask(x[:, :2].contiguous(), 6, 9, False, True)


# ---------------------------------------------------------------------------
# BilateralDither (B17, B18) and MosquitoNR
# ---------------------------------------------------------------------------

_bd_op = importlib.import_module("vszip_tpu_torch.ops.bilateral_dither")


def _banded(shape, dtype, device, seed):
    """A smooth gradient quantised into 8-bit steps plus noise of one step."""
    n, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.arange(h, device=device).view(1, h, 1).float()
    x = torch.arange(w, device=device).view(1, 1, w).float()
    v = torch.floor(255 * (0.5 + 0.35 * torch.sin(x / 29) * torch.cos(y / 17)))
    v = (v + torch.randint(-1, 2, shape, generator=g, device=device)).expand(shape)
    if dtype == torch.float32:
        return (v / 255).contiguous()
    return (v * (1 if dtype == torch.uint8 else 256)).to(torch.int32).to(dtype).contiguous()


def _bd_consts(dtype):
    """(m, wmax, swmin, peak) at thr 8, flat 0.4, as f32 values."""
    scale = {torch.uint8: 1.0, torch.uint16: 256.0, torch.float32: 1 / 256}[dtype]
    peak = {torch.uint8: 255.0, torch.uint16: 65535.0, torch.float32: 0.0}[dtype]
    unit = 1 / 65535 if dtype == torch.float32 else 1.0
    return (*(float(np.float32(v)) for v in (8 * scale, 8 * 0.6 * scale, unit)), peak)


def _bd_hold(x, ref, r, dyx):
    """B17 and B18 against their plain versions; each launches once."""
    c = _bd_consts(x.dtype)
    start = _bd_op._start_rows(x.shape[1], str(x.device))
    trace.reset_launches()
    got = kbd.dense_blur(x, ref, r, *c), kbd.subspl_blur(x, ref, r, start, dyx, *c)
    assert kbd.LAUNCHES == {"dense_blur": 1, "subspl_blur": 1}
    assert _same(got[0], kbd.dense_blur_ref(x, ref, r, *c))
    assert _same(got[1], kbd.subspl_blur_ref(x, ref, r, start, dyx, *c))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32], ids=str)
@pytest.mark.parametrize("has_ref", [False, True])
@pytest.mark.parametrize("shape,r", [((2, 37, 53), 2), ((1, 67, 45), 8), ((2, 135, 241), 16),
                                     ((1, 70, 81), 33)], ids=str)
def test_bilateral_dither_kernels_match_plain(cuda, dtype, has_ref, shape, r):
    x = _banded(shape, dtype, cuda, r)
    ref = _banded(shape, dtype, cuda, r + 1) if has_ref else None
    # r 33: spiral lists (its default size-32 VNC matrix takes 17 s on the host)
    _bd_hold(x, ref, r, _bd_op._table(r, 0.0 if r <= 16 else 200.0, str(cuda))[0])


@pytest.mark.parametrize("r,has_ref", [(74, True), (75, True), (109, False), (110, False)],
                         ids=str)
def test_bilateral_dither_kernels_at_the_shared_memory_edge(cuda, r, has_ref):
    """The largest radii whose tile and halo fit a block's shared memory, and
    the smallest that do not (every tap from device memory), on a plane
    barely larger than the radius."""
    shape = (1, r + 2, r + 5)
    x = _banded(shape, torch.uint16, cuda, r)
    ref = _banded(shape, torch.uint16, cuda, r + 1) if has_ref else None
    _bd_hold(x, ref, r, _bd_op._table(r, 4096.0, str(cuda))[0])


def test_bilateral_dither_table_beyond_shared_memory(cuda):
    """r 64, subspl 4: k = 4032 points, 23 x 4032 int16 pairs (371 KB) read
    through the read-only cache beside a shared-memory tile."""
    dyx, k = _bd_op._table(64, 4.0, str(cuda))
    assert k == 4032
    for has_ref in (False, True):
        x = _banded((1, 70, 90), torch.uint16, cuda, 3)
        _bd_hold(x, _banded((1, 70, 90), torch.uint16, cuda, 4) if has_ref else None, 64, dyx)


def _bd_table(r, k, seed):
    """A (23, k, 2) int16 table of offsets within +-(r-1), each list its own,
    its first point the centre."""
    t = np.random.default_rng(seed).integers(1 - r, r, (23, k, 2)).astype(np.int16)
    t[:, 0] = 0
    return t


def _bd_hold_subspl(x, ref, r, start, dyx, band=True):
    """B18 against its plain version; it launches once, on the band layout
    (or the 32x16 tile where `band` is False)."""
    c = _bd_consts(x.dtype)
    assert (kbd._subspl_band(x, ref, r, dyx.shape[1]) is not None) == band
    trace.reset_launches()
    got = kbd.subspl_blur(x, ref, r, start, dyx, *c)
    assert kbd.LAUNCHES["subspl_blur"] == 1
    assert _same(got, kbd.subspl_blur_ref(x, ref, r, start, dyx, *c))


# B18's band: warp g takes columns 4g + i + 92j of a 736-column band, or
# of a 368-, 184- or 92-column band of 2, 4 or 8 frames: the most frames
# the clip fills (9 frames: a second group of one)
@pytest.mark.parametrize("w", [1, 3, 91, 92, 93, 735, 736, 737, 960, 1920, 1921])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32], ids=str)
@pytest.mark.parametrize("has_ref", [False, True])
@pytest.mark.parametrize("n, frames", [(1, 1), (3, 2), (9, 8)])
def test_subspl_band_matches_plain_at_band_widths(cuda, w, dtype, has_ref, n, frames):
    shape = (n, 24, w)
    r = min(8, w)
    x = _banded(shape, dtype, cuda, w)
    ref = _banded(shape, dtype, cuda, w + 1) if has_ref else None
    dyx = torch.from_numpy(_bd_table(r, 30, w)).to(cuda)
    assert kbd._subspl_band(x, ref, r, 30)[:2] == (frames, 92 * 8 // frames)
    _bd_hold_subspl(x, ref, r, _bd_op._start_rows(shape[1], str(cuda)), dyx)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32], ids=str)
@pytest.mark.parametrize("has_ref", [False, True])
def test_subspl_band_matches_plain_at_row_strip_edges(cuda, dtype, has_ref):
    """Heights 1, 2 and one below, at and above a block's rows R (one frame
    per warp on a one-frame plane: R+1 rows take two strips)."""
    w, r = 200, 8
    dyx = torch.from_numpy(_bd_table(r, 30, 1)).to(cuda)
    tall = _banded((1, 512, w), dtype, cuda, 0)
    frames, _, rows = kbd._subspl_band(tall, tall if has_ref else None, r, 30)
    assert frames == 1
    for h in (1, 2, rows - 1, rows, rows + 1):
        x = _banded((1, h, w), dtype, cuda, h)
        ref = _banded((1, h, w), dtype, cuda, h + 1) if has_ref else None
        rh = min(r, h)
        table = dyx if rh == r else torch.from_numpy(_bd_table(rh, 30, h)).to(cuda)
        if h == rows + 1:
            assert kbd._subspl_band(x, ref, rh, 30)[2] == rows
        _bd_hold_subspl(x, ref, rh, _bd_op._start_rows(h, str(cuda)), table)


@pytest.mark.parametrize("has_ref", [False, True])
def test_subspl_band_every_list_in_every_warp(cuda, has_ref):
    """Row y starts at list y % 23, so over 46 rows each warp reads every
    list twice; each list has its own offsets."""
    shape, r = (2, 46, 2 * 736 + 5), 12
    x = _banded(shape, torch.uint16, cuda, 3)
    ref = _banded(shape, torch.uint16, cuda, 4) if has_ref else None
    start = (torch.arange(shape[1], device=cuda) % 23).to(torch.int32)
    dyx = torch.from_numpy(_bd_table(r, 41, 5)).to(cuda)
    _bd_hold_subspl(x, ref, r, start, dyx)


@pytest.mark.parametrize("r", [2, 8, 16, 33])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32], ids=str)
@pytest.mark.parametrize("has_ref", [False, True])
def test_subspl_band_matches_plain_at_radii(cuda, r, dtype, has_ref):
    """The op's tables (spiral lists past r 16); r 33 with a ref takes the
    32x16 tile (a band's tile and halo exceed shared memory)."""
    shape = (5, 90, 1000)
    x = _banded(shape, dtype, cuda, r)
    ref = _banded(shape, dtype, cuda, r + 1) if has_ref else None
    dyx = _bd_op._table(r, 0.0 if r <= 16 else 200.0, str(cuda))[0]
    _bd_hold_subspl(x, ref, r, _bd_op._start_rows(shape[1], str(cuda)), dyx,
                    band=not (r == 33 and has_ref))


def test_subspl_band_takes_planes_off_16_byte_alignment(cuda):
    """A uint16 plane one sample past an aligned address fills its tiles by
    single loads."""
    n, h, w = 3, 30, 960
    flat = _banded((1, 1, n * h * w + 1), torch.uint16, cuda, 7).view(-1)
    x = flat[1:].view(n, h, w)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    dyx = _bd_op._table(16, 0.0, str(cuda))[0]
    for ref in (None, x.flip(0).contiguous()):
        _bd_hold_subspl(x, ref, 16, _bd_op._start_rows(h, str(cuda)), dyx)


@pytest.mark.parametrize("r", [2, 8, 16, 33, 75, 110, 200])
def test_bilateral_dither_never_takes_the_plain_version_on_the_card(cuda, monkeypatch, r):
    """At every radius the op on a CUDA tensor launches a kernel and never
    reaches a plain version."""
    def boom(*a, **k):
        raise AssertionError("plain version on a CUDA tensor")

    monkeypatch.setattr(kbd, "dense_blur_ref", boom)
    monkeypatch.setattr(kbd, "subspl_blur_ref", boom)
    c = vt.Clip.from_planes([_banded((1, max(16, r + 3), r + 20), torch.uint16, cuda, r)],
                            vt.get_format("GRAY16"), device=cuda)
    for args, kernel in (({"subspl": 2.0}, "dense_blur"), ({"subspl": 4096.0}, "subspl_blur")):
        trace.reset_launches()
        out = vt.bilateral_dither(c, radius=r, ref=c, **args).planes[0]
        torch.cuda.synchronize()
        assert out.is_cuda and {k: n for k, n in kbd.LAUNCHES.items() if n} == {kernel: 1}


@pytest.mark.parametrize("fmt,args,launches", [
    ("GRAY8", {"radius": 6, "thr": 24.0, "subspl": 2.0}, {"dense_blur": 1}),
    ("GRAYS", {"radius": 6}, {"subspl_blur": 1}),
    ("YUV420P16", {}, {"subspl_blur": 3}),
    ("YUV420P16", {"radius": 8, "thr": 8.0, "subspl": 2.0}, {"dense_blur": 3}),
    ("YUV444P16", {"radius": [8, 4, 6], "subspl": 2.0}, {"dense_blur": 3}),
    ("YUV420P16", {"radius": 8, "planes": [0]}, {"subspl_blur": 1}),
    ("GRAY16", {"radius": 2}, {"subspl_blur": 1}),
    ("GRAY16", {"radius": 7, "subspl": 8.0}, {"subspl_blur": 1}),
    ("GRAY16", {"radius": 7, "subspl": 4.0}, {"subspl_blur": 1}),
    ("RGB24", {"radius": 4, "subspl": 8.0, "flat": 1.0}, {"subspl_blur": 3}),
], ids=str)
@pytest.mark.parametrize("with_ref", [False, True])
def test_bilateral_dither_on_card_matches_cpu(cuda, fmt, args, launches, with_ref):
    f = vt.get_format(fmt)
    dtype = f.torch_dtype

    def clip(seed):
        return vt.Clip.from_planes(
            [_banded((2,) + f.plane_dims(96, 64, p)[::-1], dtype, cuda, seed + p)
             for p in range(f.num_planes)], f, device=cuda)

    c = clip(0)
    ref = clip(10) if with_ref else None
    trace.reset_launches()
    got = vt.bilateral_dither(c, ref=ref, **args)
    assert {k: n for k, n in kbd.LAUNCHES.items() if n} == launches
    want = vt.bilateral_dither(c.to("cpu"), ref=None if ref is None else ref.to("cpu"), **args)
    for g, w_ in zip(got.planes, want.planes):
        assert g.is_cuda and _same(g.cpu(), w_)


@pytest.mark.parametrize("fmt,args", [
    ("GRAY16", {}), ("GRAY8", {"restore": 0, "radius": 1}), ("GRAY16", {"restore": 64}),
    ("YUV420P10", {"planes": [0, 1, 2], "strength": 32}), ("GRAYS", {"restore": 96}),
    ("YUV444PS", {"planes": [0, 1, 2], "restore": 64, "radius": 1}),
], ids=str)
@pytest.mark.parametrize("layout", ["contiguous", "crop", "transposed"])
def test_mosquito_nr_on_card_matches_cpu(cuda, fmt, args, layout):
    f = vt.get_format(fmt)
    g = torch.Generator(device=cuda).manual_seed(7)
    planes = []
    for p in range(f.num_planes):
        shape = (2,) + f.plane_dims(96, 64, p)[::-1]
        if f.sample_type is vt.SampleType.FLOAT:
            planes.append(torch.rand(shape, generator=g, device=cuda))
        else:
            top = 1 << f.bits_per_sample
            planes.append(torch.randint(0, top, shape, generator=g, device=cuda,
                                        dtype=torch.int32).to(f.torch_dtype))
    # a caller's views reach the op as they are: a crop of wider planes, or
    # planes stored transposed; the op hands the kernel contiguous copies
    if layout == "crop":
        wide = [q.new_zeros(q.shape[:2] + (q.shape[2] + 8,)) for q in planes]
        for q, v in zip(planes, wide):
            v[..., 4:-4] = q
        planes = [v[..., 4:-4] for v in wide]
    elif layout == "transposed":
        planes = [q.transpose(1, 2).contiguous().transpose(1, 2) for q in planes]
    assert all(q.is_contiguous() == (layout == "contiguous") for q in planes)
    c = vt.Clip.from_planes(planes, f, device=cuda)
    trace.reset_launches()
    got = vt.mosquito_nr(c, **args)
    # the smoothing kernel once a processed plane, never the plain version
    assert kmn.LAUNCHES == {"mosquito_nr_smooth": len(args.get("planes", [0]))}
    want = vt.mosquito_nr(c.to("cpu"), **args)
    for g_, w_ in zip(got.planes, want.planes):
        assert g_.is_cuda and _same(g_.cpu(), w_)


def test_bilateral_dither_wrappers_reject_what_kernels_do_not_take(cuda):
    x = _banded((1, 40, 48), torch.uint16, cuda, 0)
    c = _bd_consts(torch.uint16)
    dyx, _ = _bd_op._table(4, 0.0, str(cuda))
    start = _bd_op._start_rows(40, str(cuda))
    with pytest.raises(ValueError, match="uint8, uint16"):
        kbd.dense_blur(x.to(torch.int32), None, 4, *c)
    with pytest.raises(ValueError, match="contiguous"):
        kbd.dense_blur(x.transpose(1, 2), None, 4, *c)
    with pytest.raises(ValueError, match="ref"):
        kbd.dense_blur(x, x[:, :39].contiguous(), 4, *c)
    with pytest.raises(ValueError, match="radius 41"):
        kbd.dense_blur(x, None, 41, *c)
    with pytest.raises(ValueError, match="int32 start"):
        kbd.subspl_blur(x, None, 4, start[:39], dyx, *c)
    with pytest.raises(ValueError, match="int16 table"):
        kbd.subspl_blur(x, None, 4, start, dyx.to(torch.int32), *c)
    with pytest.raises(ValueError, match="within"):
        kbd.subspl_blur(x, None, 3, start, dyx, *c)


# ---------------------------------------------------------------------------
# Bilateral (algorithm 2's window kernel; algorithm 1 plain torch), the plain
# filters and the streaming runtime
# ---------------------------------------------------------------------------

def _seeded_clip(fmt_name, n, h, w, seed, device):
    """Full-range integers or floats in [0, 1) from a NumPy seed, on `device`."""
    f = vt.get_format(fmt_name)
    rng = np.random.default_rng(seed)
    planes = []
    for p in range(f.num_planes):
        shape = (n,) + f.plane_dims(w, h, p)[::-1]
        if f.sample_type is vt.SampleType.FLOAT:
            planes.append(rng.random(shape, dtype=np.float32).astype(f.storage_dtype))
        else:
            planes.append(rng.integers(0, 1 << f.bits_per_sample, shape).astype(f.storage_dtype))
    return vt.Clip.from_planes(planes, f, device=device)


def _bilateral_holds(got, want, alg):
    """The Bilateral contract of the docstring, card planes against CPU ones."""
    for g, w_ in zip(got.planes, want.planes):
        g = g.cpu()
        assert g.dtype == w_.dtype and g.shape == w_.shape
        if w_.dtype == torch.float32:
            rtol, atol = (1e-5, 1e-6) if alg == 2 else (3e-5, 3e-6)
            assert torch.allclose(g, w_, rtol=rtol, atol=atol)
        elif w_.dtype == torch.float16:
            w64 = w_.double()
            ulp = torch.from_numpy(np.spacing(np.abs(w_.numpy())).astype(np.float64))
            assert bool(((g.double() - w64).abs() <= ulp).all())
        else:
            d = (g.to(torch.int64) - w_.to(torch.int64)).abs()
            assert int(d.max()) <= 1
            if alg == 2:
                assert float((d > 0).double().mean()) < 0.01


_bl_op = importlib.import_module("vszip_tpu_torch.ops.bilateral")
# (radius, step, sigmaS) of the bench's luma and chroma planes, and of
# algorithm 2 forced at sigmaS 12
_LUMA, _CHROMA, _WIDE = (3, 2, 2.0), (2, 1, 1.0), (16, 3, 12.0)


def _bl_windows(clip, ref, specs, sigma_r):
    """A window for each plane of `clip` that `specs` gives a (radius, step,
    sigmaS); `ref` a clip with at least as many frames, or None."""
    f = clip.format
    hist = f.hist_len()
    out = []
    for p, (radius, step, sigma_s) in enumerate(specs):
        x = clip.planes[p]
        rp = x if ref is None else ref.planes[p][:clip.num_frames]
        out.append(kbl.Window(x, rp, _bl_op._gs_lut(radius, sigma_s).reshape(-1), sigma_r, hist,
                              radius, step, float(hist - 1),
                              f.sample_type is vt.SampleType.INTEGER))
    return out


def _bl_hold(windows):
    """The kernel against its plain version on the card, bit for bit; one
    launch for all the windows."""
    trace.reset_launches()
    got = kbl.bilateral_window(windows)
    assert kbl.LAUNCHES["bilateral_window"] == 1
    want = kbl.bilateral_window_ref(windows)
    assert len(got) == len(want) == len(windows)
    for g, w_ in zip(got, want):
        assert g.is_cuda and _same(g, w_)


@pytest.mark.parametrize("fmt,sigma_r", [("GRAY8", 0.05), ("GRAY8", 2.0), ("GRAY10", 0.02),
                                         ("GRAY10", 2.0), ("GRAY16", 2.0), ("GRAY16", 0.02),
                                         ("YUV420P16", 2.0), ("GRAYH", 0.1), ("GRAYH", 2.0),
                                         ("GRAYS", 2.0), ("GRAYS", 0.05)], ids=str)
@pytest.mark.parametrize("with_ref", [False, True])
def test_bilateral_window_matches_plain(cuda, fmt, sigma_r, with_ref):
    """Every sample type, with and without a longer joint ref, on odd sizes:
    the bench's luma and chroma windows, and a wide one where it fits; at
    sigmaR 2 the weight's clamp never binds at 8 and 16 bits and in floats,
    and the kernel leaves it out."""
    n = 2
    c = _seeded_clip(fmt, n, 45, 77, 3, cuda)
    ref = _seeded_clip(fmt, n + 3, 45, 77, 4, cuda) if with_ref else None
    planes = c.format.num_planes
    _bl_hold(_bl_windows(c, ref, [_LUMA] + [_CHROMA] * (planes - 1), sigma_r))
    _bl_hold(_bl_windows(c, ref, [_CHROMA] * planes, sigma_r))
    if planes == 1:
        _bl_hold(_bl_windows(c, ref, [_WIDE], sigma_r))


@pytest.mark.parametrize("fmt", ["GRAY16", "YUV420P16", "GRAYS"])
@pytest.mark.parametrize("n", [1, 65])
def test_bilateral_window_matches_plain_at_frame_counts(cuda, fmt, n):
    c = _seeded_clip(fmt, n, 38, 70, n, cuda)
    planes = c.format.num_planes
    _bl_hold(_bl_windows(c, None, [_LUMA] + [_CHROMA] * (planes - 1), 2.0))


@pytest.mark.parametrize("spec", [_LUMA, _CHROMA, (1, 1, 0.5)], ids=str)
@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32], ids=str)
def test_bilateral_window_on_planes_just_above_twice_the_radius(cuda, spec, dtype):
    fmt = "GRAY16" if dtype == torch.uint16 else "GRAYS"
    r = spec[0]
    for h, w in ((2 * r + 1, 2 * r + 1), (2 * r + 1, 131), (33, 2 * r + 1), (31, 33)):
        c = _seeded_clip(fmt, 2, h, w, h * w, cuda)
        _bl_hold(_bl_windows(c, c, [spec], 0.1))


@pytest.mark.parametrize("with_ref", [False, True])
def test_bilateral_window_on_both_sides_of_the_shared_memory_tile(cuda, with_ref):
    """The largest radius whose tile and halo fit a block's shared memory
    takes the tile, the next one reads its taps from device memory; both
    equal the plain version (taps every r // 2 rows and columns from 1)."""
    on_chip = kbl._WINDOW_ON_CHIP
    lim = max(r for r in range(1, 400) if on_chip(r, int(with_ref)))
    assert lim == (104 if not with_ref else 69)
    for r in (lim, lim + 1):
        c = _seeded_clip("GRAY16", 2, 2 * r + 9, 2 * r + 21, r, cuda)
        ref = _seeded_clip("GRAY16", 2, 2 * r + 9, 2 * r + 21, r + 1, cuda) if with_ref else None
        _bl_hold(_bl_windows(c, ref, [(r, r // 2, r / 2.0)], 0.1))


@pytest.mark.parametrize("fmt,args,launches", [
    ("YUV420P16", {"sigmaS": 2.0, "sigmaR": 2.0, "planes": [0, 1, 2]}, 1),
    ("YUV420P16", {"sigmaS": 2.0, "sigmaR": 2.0, "planes": [1]}, 1),
    ("YUV420P8", {"sigmaS": 3.0, "sigmaR": 0.05, "algorithm": [1, 2, 2]}, 1),
    ("GRAY16", {"sigmaS": 2.0, "sigmaR": 0.1, "algorithm": 1}, 0),
    ("GRAYH", {"sigmaS": 12.0, "sigmaR": 0.1, "algorithm": 2}, 1),
    ("GRAY16", {"sigmaS": 14.0, "sigmaR": 0.1, "algorithm": 2}, 1),
    ("GRAY8", {"sigmaS": 0.0}, 0),
], ids=str)
@pytest.mark.parametrize("with_ref", [False, True])
def test_bilateral_never_takes_the_plain_window_on_the_card(cuda, monkeypatch, fmt, args,
                                                            launches, with_ref):
    """Algorithm 2 on CUDA tensors launches the window kernel once a call,
    for all its planes, and never reaches the plain version."""
    def boom(*a, **k):
        raise AssertionError("plain version on a CUDA tensor")

    monkeypatch.setattr(kbl, "window_ref", boom)
    monkeypatch.setattr(kbl, "bilateral_window_ref", boom)
    c = _seeded_clip(fmt, 2, 40, 64, 5, cuda)
    ref = _seeded_clip(fmt, 4, 40, 64, 6, cuda) if with_ref else None
    trace.reset_launches()
    out = vt.bilateral(c, ref=ref, **args)
    torch.cuda.synchronize()
    assert all(p.is_cuda for p in out.planes)
    assert kbl.LAUNCHES["bilateral_window"] == launches


def _bl_views(c, crop):
    """`c` with each plane a non-contiguous view of the same samples: cut out
    of a larger zeroed plane (`crop`) or transposed out of a copy with its
    last two axes swapped."""
    planes = []
    for x in c.planes:
        if crop:
            n, h, w = x.shape
            big = torch.zeros((n, h + 2, w + 3), dtype=x.dtype, device=x.device)
            big[:, 1:-1, 1:-2] = x
            planes.append(big[:, 1:-1, 1:-2])
        else:
            planes.append(x.transpose(1, 2).contiguous().transpose(1, 2))
    assert not any(v.is_contiguous() for v in planes)
    return vt.Clip.from_planes(planes, c.format, device=c.planes[0].device)


@pytest.mark.parametrize("fmt,specs,sigma_r", [
    ("YUV420P16", [_LUMA, _CHROMA, _CHROMA], 2.0), ("GRAYH", [_LUMA], 2.0),
    ("GRAY8", [_CHROMA], 0.05)], ids=str)
@pytest.mark.parametrize("with_ref", [False, True])
def test_bilateral_on_card_takes_planes_that_are_views(cuda, fmt, specs, sigma_r, with_ref):
    """``Clip.from_planes`` keeps a CUDA tensor as it is, so a clip may hold
    cropped or transposed planes: the op filters them in one launch, as the
    plain version filters their contiguous copies."""
    c = _seeded_clip(fmt, 2, 45, 77, 11, cuda)
    ref = _seeded_clip(fmt, 3, 45, 77, 12, cuda) if with_ref else None
    views = _bl_views(c, False)
    rviews = None if ref is None else _bl_views(ref, True)
    assert views.planes[0].is_cuda
    trace.reset_launches()
    got = vt.bilateral(views, ref=rviews, sigmaS=specs[0][2], sigmaR=sigma_r)
    assert kbl.LAUNCHES["bilateral_window"] == 1
    want = kbl.bilateral_window_ref(_bl_windows(c, ref, specs, sigma_r))
    for g, w_ in zip(got.planes, want):
        assert g.is_cuda and _same(g, w_)


def test_bilateral_window_rejects_what_the_kernel_does_not_take(cuda):
    c = _seeded_clip("GRAY16", 2, 40, 64, 7, cuda)
    (win,) = _bl_windows(c, None, [_LUMA], 2.0)
    x = win.src
    with pytest.raises(ValueError, match="float32 planes"):
        kbl.bilateral_window([win._replace(src=x.to(torch.int32), ref=x.to(torch.int32))])
    with pytest.raises(ValueError, match="contiguous"):
        kbl.bilateral_window([win._replace(src=x.transpose(1, 2), ref=x.transpose(1, 2))])
    with pytest.raises(ValueError, match="ref"):
        kbl.bilateral_window([win._replace(ref=x[:, :39].contiguous())])
    with pytest.raises(ValueError, match="1 to 3 planes"):
        kbl.bilateral_window([win] * 4)
    with pytest.raises(ValueError, match="share their device"):
        kbl.bilateral_window([win, win._replace(src=x.cpu(), ref=x.cpu())])
    with pytest.raises(ValueError, match="is_int"):
        kbl.bilateral_window([win._replace(is_int=False)])
    with pytest.raises(ValueError, match="radius 3, step 2 with 9"):
        kbl.bilateral_window([win._replace(gs=win.gs[:9])])


@pytest.mark.parametrize("fmt,args,alg", [
    ("YUV420P16", {"sigmaS": 2.0, "sigmaR": 2.0, "planes": [0, 1, 2]}, 2),
    ("GRAY8", {"sigmaS": 3.0, "sigmaR": 0.05}, 2),
    ("GRAYH", {"sigmaS": 2.0, "sigmaR": 0.1, "algorithm": 2}, 2),
    ("GRAYS", {"sigmaS": 2.0, "sigmaR": 2.0}, 2),
    ("GRAY16", {"sigmaS": 2.0, "sigmaR": 0.1, "algorithm": 1}, 1),
    ("GRAYS", {"sigmaS": 3.0, "sigmaR": 0.1, "algorithm": 1}, 1),
    ("YUV420P8", {"sigmaS": 3.0, "sigmaR": 0.03, "algorithm": 1}, 1),
    ("YUV420P16", {"sigmaS": 2.0, "sigmaR": 2.0, "planes": [0]}, 2),
], ids=str)
@pytest.mark.parametrize("with_ref", [False, True])
def test_bilateral_on_card_holds_its_contract_against_cpu(cuda, fmt, args, alg, with_ref):
    c = _seeded_clip(fmt, 2, 40, 64, 1, cuda)
    ref = _seeded_clip(fmt, 3, 40, 64, 2, cuda) if with_ref else None
    for m in (kb, kd, kc, ke, kx, ks, kz, kk, km, kbd, kbl):
        trace.reset_launches()
    got = vt.bilateral(c, ref=ref, **args)
    assert {k: n for m in (kb, kd, kc, ke, kx, ks, kz, kk, km, kbd, kbl)
            for k, n in m.LAUNCHES.items() if n} == ({"bilateral_window": 1} if alg == 2 else {})
    assert all(p.is_cuda for p in got.planes)
    want = vt.bilateral(c.to("cpu"), ref=None if ref is None else ref.to("cpu"), **args)
    _bilateral_holds(got, want, alg)


def _props_equal(got, want, keys):
    for k in keys:
        g, w_ = got.props[k], want.props[k]
        assert g.is_cuda and g.dtype == w_.dtype and g.shape == w_.shape, k
        if w_.dtype == torch.float64:
            assert torch.allclose(g.cpu(), w_, rtol=1e-12, atol=0), k
        else:
            assert _same(g.cpu(), w_), k


@pytest.mark.parametrize("op,fmt,args,keys", [
    ("plane_average", "YUV420P16", {"planes": [0, 1, 2], "exclude": [0, 65535]}, ["psmAvg"]),
    ("plane_average", "GRAYS", {"exclude": [0.5]}, ["psmAvg"]),
    ("plane_average", "GRAY8", {"clipb": True}, ["psmAvg", "psmDiff"]),
    ("plane_minmax", "YUV420P16", {"minthr": 0.1, "maxthr": 0.1, "planes": [0, 1, 2]},
     ["psmMin", "psmMax"]),
    ("plane_minmax", "RGB24", {"minthr": 0.1, "maxthr": 0.1, "clipb": True},
     ["psmMin", "psmMax", "psmDiff"]),
    ("plane_minmax", "GRAYS", {"minthr": 0.25}, ["psmMin", "psmMax"]),
    ("plane_minmax", "GRAYH", {}, ["psmMin", "psmMax"]),
    ("plane_minmax", "YUV420P8", {"planes": [0, 1, 2], "clipb": True},
     ["psmMin", "psmMax", "psmDiff"]),
    ("limit_filter", "YUV420P16", {"dark_thr": 3.0, "bright_thr": 5.0, "elast": 2.5}, []),
    ("limit_filter", "GRAYS", {"dark_thr": 40.0, "bright_thr": 20.0, "elast": 3.0}, []),
    ("limit_filter", "GRAY8", {"ref": True, "dark_thr": 60.0, "elast": 1.5}, []),
    ("adaptive_binarize", "YUV420P8", {"c": 3}, []),
    ("packrgb", "RGB24", {}, []),
    ("packrgb", "RGB30", {}, []),
    ("rfs", "YUV420P16", {"frames": [0, 2], "planes": [1, 2]}, []),
    ("rfs", "GRAY32", {"frames": [1]}, []),
    ("colormap", "GRAY8", {"color": 20}, []),
    ("colormap", "GRAY8", {"color": 12}, []),
], ids=str)
def test_plain_filters_on_card_match_cpu(cuda, op, fmt, args, keys):
    c = _seeded_clip(fmt, 3, 38, 54, 4, cuda)
    other = _seeded_clip(fmt, 3 if op == "limit_filter" else 4, 38, 54, 5, cuda)
    args = dict(args)
    pos = ()
    if op in ("limit_filter", "adaptive_binarize", "rfs"):
        pos = (other,)
    for k in ("clipb", "ref"):
        if args.get(k):
            args[k] = _seeded_clip(fmt, 3, 38, 54, 6, cuda)
    got = getattr(vt, op)(c, *pos, **args)
    cpu_args = {k: v.to("cpu") if isinstance(v, vt.Clip) else v for k, v in args.items()}
    want = getattr(vt, op)(c.to("cpu"), *(o.to("cpu") for o in pos), **cpu_args)
    assert got.format == want.format
    for g, w_ in zip(got.planes, want.planes):
        assert g.is_cuda and _same(g.cpu(), w_)
    _props_equal(got, want, keys)


def _stream_frames(fmt_name, n, h, w, seed):
    f = vt.get_format(fmt_name)
    rng = np.random.default_rng(seed)
    return f, tuple(rng.integers(0, 1 << f.bits_per_sample,
                                 (n,) + f.plane_dims(w, h, p)[::-1]).astype(f.storage_dtype)
                    for p in range(f.num_planes))


def _kept(fmt):
    chunks = {}

    def sink(start, clip):
        chunks[start] = clip

    def whole():
        return [np.concatenate([chunks[s].planes[p] for s in sorted(chunks)])
                for p in range(fmt.num_planes)]

    return sink, whole, chunks


@pytest.mark.parametrize("batch", [4, 5, 20])
def test_streamed_boxblur_equals_resident_on_card(cuda, batch):
    fmt, planes = _stream_frames("YUV420P16", 13, 96, 128, 0)
    resident = vt.boxblur(vt.Clip.from_planes(planes, fmt, device=cuda), hradius=13, vradius=13)
    sink, whole, chunks = _kept(fmt)
    trace.reset_launches()
    vt.process_stream(vt.ArraySource(planes, fmt),
                      lambda c: vt.boxblur(c, hradius=13, vradius=13), batch=batch, sink=sink)
    assert kb.LAUNCHES["ct_blur_int"] == 3 * len(chunks)
    for got, want in zip(whole(), resident.planes):
        assert np.array_equal(got, want.cpu().numpy())


def test_streamed_checkmate_with_overlap_equals_resident_on_card(cuda):
    fmt, planes = _stream_frames("YUV420P8", 11, 64, 96, 1)
    resident = vt.checkmate(vt.Clip.from_planes(planes, fmt, device=cuda), tthr2=10)
    sink, whole, _ = _kept(fmt)
    vt.process_stream(vt.ArraySource(planes, fmt), lambda c: vt.checkmate(c, tthr2=10),
                      batch=4, overlap=2, sink=sink)
    for got, want in zip(whole(), resident.planes):
        assert np.array_equal(got, want.cpu().numpy())


def test_streamed_xpsnr_equals_resident_on_card(cuda):
    fmt, ref_p = _stream_frames("YUV420P8", 13, 64, 128, 2)
    rng = np.random.default_rng(3)
    dist_p = tuple(np.clip(p.astype(np.int32) + rng.integers(-9, 9, p.shape), 0, 255)
                   .astype(np.uint8) for p in ref_p)
    resident = vt.xpsnr(vt.Clip.from_planes(ref_p, fmt, device=cuda),
                        vt.Clip.from_planes(dist_p, fmt, device=cuda), fps=24)
    batch, overlap, n = 4, 2, 13
    starts = iter(range(0, n, batch))

    def op(chunk):
        s = next(starts)
        lo, hi = max(0, s - overlap), min(n, s + batch + overlap)
        r = vt.Clip.from_planes(tuple(p[lo:hi] for p in ref_p), fmt, device=cuda)
        return vt.xpsnr(r, chunk, fps=24)

    props = vt.process_stream(vt.ArraySource(dist_p, fmt), op, batch=batch, overlap=overlap,
                              donate=False)
    for k in ("XPSNR_Y", "XPSNR_U", "XPSNR_V", "XPSNR_AVG"):
        want = resident.props[k].cpu().numpy()
        assert props[k].dtype == want.dtype and np.array_equal(props[k].view(np.int64),
                                                                want.view(np.int64)), k


def test_streamed_memory_mapped_source_on_card(cuda, tmp_path):
    fmt, planes = _stream_frames("YUV420P16", 9, 64, 96, 4)
    maps = []
    for i, p in enumerate(planes):
        np.save(tmp_path / f"p{i}.npy", p)
        maps.append(np.load(tmp_path / f"p{i}.npy", mmap_mode="r"))
    resident = vt.boxblur(vt.Clip.from_planes(planes, fmt, device=cuda), hradius=3, vradius=3)
    sink, whole, _ = _kept(fmt)
    vt.process_stream(vt.ArraySource(maps, fmt), lambda c: vt.boxblur(c, hradius=3, vradius=3),
                      batch=4, sink=sink)
    for got, want in zip(whole(), resident.planes):
        assert np.array_equal(got, want.cpu().numpy())


def test_streamed_sink_keeps_its_chunks_on_card(cuda):
    """An op that returns its input planes (PlaneAverage) and a sink that
    keeps every chunk: each kept plane is its own host array, equal to the
    source's frames, though the device buffers and staging ring are reused."""
    fmt, planes = _stream_frames("YUV420P16", 17, 64, 96, 5)
    sink, _, chunks = _kept(fmt)
    props = vt.process_stream(vt.ArraySource(planes, fmt), lambda c: vt.plane_average(c),
                              batch=3, overlap=1, sink=sink)
    assert sorted(chunks) == list(range(0, 17, 3))
    kept = []
    for s, clip in chunks.items():
        n = min(3, 17 - s)
        for p, plane in enumerate(clip.planes):
            assert np.array_equal(plane, planes[p][s: s + n])
            kept.append(plane)
        assert clip.props["psmAvg"].shape == (n, 1)
    for i, a in enumerate(kept):
        assert not any(np.shares_memory(a, b) for b in kept[i + 1:])
    want = vt.plane_average(vt.Clip.from_planes(planes, fmt, device=cuda)).props["psmAvg"]
    assert np.array_equal(props["psmAvg"], want.cpu().numpy())


def test_streamed_frame_doubling_and_ragged_batch_on_card(cuda):
    rng = np.random.default_rng(6)
    x = rng.random((7, 24, 32), dtype=np.float32)
    fmt = vt.get_format("GRAYS")
    resident = vt.eedi3(vt.Clip.from_planes((x,), fmt, device=cuda), field=2).planes[0]
    sink, whole, chunks = _kept(fmt)
    vt.process_stream(vt.ArraySource((x,), fmt), lambda c: vt.eedi3(c, field=2), batch=3,
                      sink=sink, donate=False)
    assert sorted(chunks) == [0, 6, 12]
    assert _same(torch.from_numpy(whole()[0]), resident.cpu())



# ---------------------------------------------------------------------------
# ImageRead and the mesh on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rgb48_paeth", "gray16_sub", "rgba32_avg"])
def test_image_read_lands_on_the_card(cuda, tmp_path, kind):
    from helpers import encode_png

    rng = np.random.default_rng(7)
    shape, dtype, gray, alpha, ft = {
        "rgb48_paeth": ((33, 47, 3), np.uint16, False, False, 4),
        "gray16_sub": ((20, 31, 1), np.uint16, True, False, 1),
        "rgba32_avg": ((17, 29, 4), np.uint8, False, True, 3)}[kind]
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    paths = []
    for i in range(2):
        p = tmp_path / f"{kind}{i}.png"
        p.write_bytes(encode_png(img, gray=gray, alpha=alpha, filter_type=ft))
        paths.append(str(p))
    clip, aclip = vt.image_read(paths, alpha=True)
    cpu, acpu = vt.image_read(paths, alpha=True, device="cpu")
    assert clip.format == cpu.format and clip.props == cpu.props
    for got, want in zip(clip.planes + aclip.planes, cpu.planes + acpu.planes):
        assert got.device == torch.device("cuda", 0) and _same(got.cpu(), want)
    for c in range(len(clip.planes)):
        assert np.array_equal(clip.planes[c][1].cpu().numpy(), img[..., c])


def test_frames_mesh_on_the_card(cuda):
    from vszip_tpu_torch.parallel import frames_mesh

    count = torch.cuda.device_count()
    mesh = frames_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(count))
    with pytest.raises(RuntimeError, match="visible"):
        frames_mesh(count + 1)


def _two_on_card0():
    from vszip_tpu_torch.parallel import frames_mesh

    return frames_mesh(devices=["cuda:0", "cuda:0"])


@pytest.mark.parametrize("name,overlap", [("boxblur", 0), ("checkmate", 1),
                                          ("checkmate_tthr2", 2), ("plane_average", 0)])
def test_run_sharded_equals_resident_on_card(cuda, name, overlap):
    from vszip_tpu_torch.parallel import run_sharded

    op = {"boxblur": lambda c: vt.boxblur(c, hradius=13, vradius=13),
          "checkmate": lambda c: vt.checkmate(c),
          "checkmate_tthr2": lambda c: vt.checkmate(c, tthr2=10),
          "plane_average": lambda c: vt.plane_average(c, planes=[0, 1, 2])}[name]
    fmt, planes = _stream_frames("YUV420P8", 12, 64, 96, 8)
    clip = vt.Clip.from_planes(planes, fmt, device=cuda)
    want = op(clip)
    got = run_sharded(op, clip, mesh=_two_on_card0(), overlap=overlap)
    for g, w in zip(got.planes, want.planes):
        assert g.is_cuda and _same(g, w)
    assert set(got.props) == set(want.props)
    for k, v in want.props.items():
        assert _same(got.props[k], v) if isinstance(v, torch.Tensor) else got.props[k] == v


def test_run_sharded_xpsnr_equals_resident_on_card(cuda):
    from vszip_tpu_torch.parallel import run_sharded

    fmt, ref_p = _stream_frames("YUV420P8", 12, 64, 128, 9)
    rng = np.random.default_rng(10)
    dist_p = tuple(np.clip(p.astype(np.int32) + rng.integers(-9, 9, p.shape), 0, 255)
                   .astype(np.uint8) for p in ref_p)
    ref, dist = (vt.Clip.from_planes(p, fmt, device=cuda) for p in (ref_p, dist_p))
    want = vt.xpsnr(ref, dist, fps=24)
    got = run_sharded(lambda r, d: vt.xpsnr(r, d, fps=24), ref, dist, mesh=_two_on_card0(),
                      overlap=2)
    for k in ("XPSNR_Y", "XPSNR_U", "XPSNR_V", "XPSNR_AVG", "_XPSNR_WSSE"):
        assert got.props[k].is_cuda and _same(got.props[k], want.props[k]), k


@pytest.mark.parametrize("batch", [4, 6, 13])
def test_meshed_stream_equals_resident_on_card(cuda, batch):
    """Chunks of 6 and 8 frames split over the two entries (checkmate runs
    once more a plane for each), the others run whole on the first."""
    fmt, planes = _stream_frames("YUV420P8", 13, 64, 96, 11)
    resident = vt.checkmate(vt.Clip.from_planes(planes, fmt, device=cuda), tthr2=10)
    sink, whole, chunks = _kept(fmt)
    trace.reset_launches()
    props = vt.process_stream(vt.ArraySource(planes, fmt),
                              lambda c: vt.plane_average(vt.checkmate(c, tthr2=10)),
                              batch=batch, overlap=2, sink=sink,
                              mesh=_two_on_card0())
    assert kk.LAUNCHES["checkmate"] > 3 * len(chunks) or batch == 13
    for got, want in zip(whole(), resident.planes):
        assert np.array_equal(got, want.cpu().numpy())
    want = vt.plane_average(resident).props["psmAvg"].cpu().numpy()
    assert np.array_equal(props["psmAvg"], want)
