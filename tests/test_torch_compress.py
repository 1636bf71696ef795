"""vszip_tpu_torch.compress held against vszip_tpu.compress on seeded clips
(GRAY8, YUV420P8, YUV444P8; ragged and minimal sizes; 1, 2 and 5 frames),
over every MPEG-2 qscale/dc_prec and JPEG quality regime that straddles a
wide (i64 quantizer) threshold, ``chroma=False``, and every validation
message.  On the CPU the op runs B14's plain version, so these cases also
check B14's function in both regimes.  B14's plain version against the
Pallas kernel in interpret mode and the literal block oracle is in
``test_torch_compress_kernels.py``.

Tolerance: bit-exact everywhere (integer planes).
"""

import importlib

import numpy as np
import pytest

import vszip_tpu as vz
import vszip_tpu_torch as vt
from test_torch_core import assert_planes_match, both_clips, make_planes, same_error

tcomp = importlib.import_module("vszip_tpu_torch.ops.compress")
tkern = importlib.import_module("vszip_tpu_torch.kernels.compress")
jcomp = importlib.import_module("vszip_tpu.ops.compress")

FORMATS = ("GRAY8", "YUV420P8", "YUV444P8")
# (frames, height, width): ragged both ways, ragged one way, whole blocks
SHAPES = ((2, 37, 53), (1, 24, 19), (5, 16, 24))


def _case(i):
    return FORMATS[i % 3], SHAPES[(i // 3) % 3]


MPEG = [(q, d) for q in (1, 2, 3, 8, 31) for d in (0, 3)]


@pytest.mark.parametrize("qscale,dc_prec", MPEG, ids=str)
def test_mpeg2_matches_jax(qscale, dc_prec):
    i = MPEG.index((qscale, dc_prec))
    fmt, (n, h, w) = _case(i)
    cj, ct = both_clips(fmt, make_planes(fmt, np.random.default_rng(i), n, h, w))
    args = {"codec": 0, "qscale": qscale, "dc_prec": dc_prec}
    got = vt.compress(ct, **args)
    assert got.format == ct.format and all(p.device.type == "cpu" for p in got.planes)
    assert_planes_match(got.planes, vz.compress(cj, **args).planes)


QUALITY = (1, 10, 50, 77, 78, 86, 87, 95, 100)


@pytest.mark.parametrize("quality", QUALITY)
def test_jpeg_matches_jax(quality):
    i = QUALITY.index(quality)
    fmt, (n, h, w) = _case(i + 1)
    cj, ct = both_clips(fmt, make_planes(fmt, np.random.default_rng(100 + i), n, h, w))
    assert_planes_match(vt.compress(ct, codec=1, quality=quality).planes,
                        vz.compress(cj, codec=1, quality=quality).planes)


@pytest.mark.parametrize("fmt,n,h,w", [("GRAY8", 1, 1, 1), ("GRAY8", 2, 8, 8),
                                       ("YUV420P8", 1, 2, 2), ("YUV444P8", 2, 9, 3),
                                       ("GRAY8", 1, 3, 70)], ids=str)
def test_minimal_sizes_match_jax(fmt, n, h, w):
    cj, ct = both_clips(fmt, make_planes(fmt, np.random.default_rng(h * w), n, h, w))
    for args in ({}, {"codec": 1, "quality": 95}):
        assert_planes_match(vt.compress(ct, **args).planes, vz.compress(cj, **args).planes)


@pytest.mark.parametrize("fmt", ["YUV420P8", "YUV444P8"])
def test_chroma_false_passes_chroma_through(fmt):
    cj, ct = both_clips(fmt, make_planes(fmt, np.random.default_rng(7), 2, 24, 40))
    for args in ({"qscale": 20, "chroma": False}, {"codec": 1, "quality": 25, "chroma": False}):
        got = vt.compress(ct, **args)
        assert got.planes[1] is ct.planes[1] and got.planes[2] is ct.planes[2]
        assert_planes_match(got.planes, vz.compress(cj, **args).planes)


def test_quant_setup_and_wide_regimes_match_jax():
    wide = set()
    for q in range(1, 32):
        for d in range(4):
            tj, tt = jcomp._quant_setup("mpeg2", q, d, 50, False), tcomp._quant_setup(
                "mpeg2", q, d, 50, False)
            for a, b in zip(tj, tt):
                np.testing.assert_array_equal(a, b)
            if tt[2]:
                wide.add(("mpeg2", q))
    for chroma in (False, True):
        for quality in range(1, 101):
            tj = jcomp._quant_setup("jpeg", 8, 0, quality, chroma)
            tt = tcomp._quant_setup("jpeg", 8, 0, quality, chroma)
            for a, b in zip(tj, tt):
                np.testing.assert_array_equal(a, b)
            if tt[2]:
                wide.add(("chroma" if chroma else "luma", quality))
    # the true thresholds (the JAX package's comments name narrower sets)
    assert wide == ({("mpeg2", 1), ("mpeg2", 2)} | {("luma", q) for q in range(78, 101)}
                    | {("chroma", q) for q in range(87, 101)})
    np.testing.assert_array_equal(tkern._fdct_mat(), jcomp._fdct_mat())
    np.testing.assert_array_equal(tkern._idct_mat(), jcomp._idct_mat())


def test_compress_errors():
    rng = np.random.default_rng(0)
    cj, ct = both_clips("GRAY8", make_planes("GRAY8", rng, 1, 16, 16))
    bad = [both_clips(f, make_planes(f, rng, 1, 16, 16)) for f in ("RGB24", "GRAY16", "GRAYS")]
    msgs = [same_error(lambda: vz.compress(bj), lambda: vt.compress(bt)) for bj, bt in bad]
    for args in ({"codec": 2}, {"qscale": 0}, {"qscale": 32}, {"dc_prec": 4},
                 {"dc_prec": -1}, {"codec": 1, "quality": 0}, {"codec": 1, "quality": 101}):
        msgs.append(same_error(lambda: vz.compress(cj, **args), lambda: vt.compress(ct, **args)))
    assert all(m.startswith("Compress: ") for m in msgs)
    # JPEG ignores qscale and dc_prec, MPEG-2 ignores quality, as in the JAX package
    assert_planes_match(vt.compress(ct, codec=1, qscale=99).planes,
                        vz.compress(cj, codec=1, qscale=99).planes)
    assert_planes_match(vt.compress(ct, quality=0).planes, vz.compress(cj, quality=0).planes)
