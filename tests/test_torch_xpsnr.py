"""vszip_tpu_torch.xpsnr held against vszip_tpu.xpsnr on seeded clips: the
bench's geometry (1920x1080 YUV420P10, b = 64, where the port runs B11 and
B12's plain versions), first- and second-order temporal terms (fps 24 and
60) and temporal off, the >HD downsampled path (2560x1440), the <=640x480
weight smoothing, the degenerate b < 4 path, 4:2:2 and 4:4:4 chroma blocks,
8-bit input, a mixed 8/10-bit pair (``bit_depth`` promote), every
validation message and the ``verbose`` line.

Tolerance: ``_XPSNR_WSSE`` and ``_XPSNR_Num64`` exactly equal (the block
sums are exact integers and the weights the same f64 operations);
XPSNR_Y/U/V/AVG within rtol 1e-12 (the same f64 formula; libm's log10 may
differ from XLA's by an ulp).
"""

import re

import numpy as np
import pytest

import vszip_tpu as vz
import vszip_tpu_torch as vt
from test_torch_core import same_error

PROPS = ("XPSNR_Y", "XPSNR_U", "XPSNR_V", "XPSNR_AVG")


def _pair(fmt, n, h, w, seed, fmt2=None):
    """Seeded reference planes and a distorted copy (the bench's recipe:
    + integers(-8, 8), clipped) as NumPy arrays."""
    rng = np.random.default_rng(seed)
    f = vz.get_format(fmt)
    peak = (1 << f.bits_per_sample) - 1
    ref = [rng.integers(0, peak + 1, (n,) + f.plane_dims(w, h, p)[::-1]).astype(f.storage_dtype)
           for p in range(3)]
    f2 = vz.get_format(fmt2 or fmt)
    peak2 = (1 << f2.bits_per_sample) - 1
    scale = 1 << (f2.bits_per_sample - f.bits_per_sample) if fmt2 else 1
    dist = [np.clip(a.astype(np.int64) * scale + rng.integers(-8, 8, a.shape), 0, peak2)
            .astype(f2.storage_dtype) for a in ref]
    return ref, dist


def _check(fmt, n, h, w, seed=0, fmt2=None, **args):
    ref, dist = _pair(fmt, n, h, w, seed, fmt2)
    fmt2 = fmt2 or fmt
    want = vz.xpsnr(vz.Clip.from_planes(ref, vz.get_format(fmt)),
                    vz.Clip.from_planes(dist, vz.get_format(fmt2)), **args)
    got = vt.xpsnr(vt.Clip.from_planes(ref, vt.get_format(fmt), device="cpu"),
                   vt.Clip.from_planes(dist, vt.get_format(fmt2), device="cpu"), **args)
    for k in ("_XPSNR_WSSE", "_XPSNR_Num64"):
        np.testing.assert_array_equal(got.props[k].numpy(), np.asarray(want.props[k]))
    for k in PROPS:
        g, x = got.props[k].numpy(), np.asarray(want.props[k])
        assert g.shape == x.shape and g.dtype == np.float64
        np.testing.assert_allclose(g, x, rtol=1e-12, atol=0)
    assert got.format == vt.get_format(fmt2)
    return got


@pytest.mark.parametrize("fps,temporal", [(24, True), (60, True), (24, False)], ids=str)
def test_bench_geometry_matches_jax(fps, temporal):
    _check("YUV420P10", 3, 1080, 1920, fps=fps, temporal=temporal)


@pytest.mark.parametrize("fmt,fps", [("YUV422P10", 24), ("YUV444P8", 30)], ids=str)
def test_1080p_chroma_layouts_match_jax(fmt, fps):
    _check(fmt, 2, 1080, 1920, seed=1, fps=fps)


@pytest.mark.parametrize("fps,temporal", [(24, True), (60, True), (24, False)], ids=str)
def test_above_hd_matches_jax(fps, temporal):
    _check("YUV420P10", 2, 1440, 2560, seed=2, fps=fps, temporal=temporal)


@pytest.mark.parametrize("h,w,fps", [(480, 640, 24), (240, 320, 60), (144, 256, 24),
                                     (720, 1280, 32)], ids=str)
def test_smaller_pictures_match_jax(h, w, fps):
    # <= 640x480 runs the weight smoothing; 1280x720 has b = 44 (no kernel)
    _check("YUV420P8", 3, h, w, seed=h, fps=fps)


def test_degenerate_block_size_matches_jax():
    _check("YUV420P10", 3, 32, 40, seed=4, fps=24)


def test_mixed_depth_pair_matches_jax():
    _check("YUV420P8", 3, 1080, 1920, seed=5, fmt2="YUV420P10", fps=24)


def test_fps_from_props_matches_jax():
    ref, dist = _pair("YUV420P8", 3, 144, 176, 6)
    props = {"_FpsNum": 60000, "_FpsDen": 1001}
    want = vz.xpsnr(vz.Clip.from_planes(ref, vz.get_format("YUV420P8"), props),
                    vz.Clip.from_planes(dist, vz.get_format("YUV420P8")))
    got = vt.xpsnr(vt.from_reference(ref, "YUV420P8", props, device="cpu"),
                   vt.Clip.from_planes(dist, vt.get_format("YUV420P8"), device="cpu"))
    np.testing.assert_array_equal(got.props["_XPSNR_WSSE"].numpy(),
                                  np.asarray(want.props["_XPSNR_WSSE"]))


def test_identical_clips_score_infinity():
    ref, _ = _pair("YUV420P10", 2, 64, 96, 7)
    c = vt.Clip.from_planes(ref, vt.get_format("YUV420P10"), device="cpu")
    out = vt.xpsnr(c, c, fps=24)
    assert all(np.isinf(out.props[k].numpy()).all() for k in PROPS)


def test_errors_match_jax():
    def both(fmt, h=32, w=48):
        planes = _pair(fmt, 1, h, w, 8)[0] if fmt.startswith("YUV") else \
            [np.zeros((1, h, w), np.uint8)]
        return (vz.Clip.from_planes(planes, vz.get_format(fmt)),
                vt.Clip.from_planes(planes, vt.get_format(fmt), device="cpu"))

    for a, b in ((both("GRAY8"), both("GRAY8")), (both("YUV420P16"), both("YUV420P16")),
                 (both("YUV420P8", 30, 49), both("YUV420P8", 30, 49)),
                 (both("YUV420P8"), both("YUV420P8", 32, 64)),
                 (both("YUV420P8"), both("YUV444P8"))):
        same_error(lambda: vz.xpsnr(a[0], b[0]), lambda: vt.xpsnr(a[1], b[1]))
    ref, dist = _pair("YUV420P8", 2, 32, 48, 9)
    short = [p[:1] for p in dist]
    same_error(lambda: vz.xpsnr(vz.Clip.from_planes(ref, vz.get_format("YUV420P8")),
                                vz.Clip.from_planes(short, vz.get_format("YUV420P8"))),
               lambda: vt.xpsnr(vt.Clip.from_planes(ref, vt.get_format("YUV420P8"), device="cpu"),
                                vt.Clip.from_planes(short, vt.get_format("YUV420P8"),
                                                    device="cpu")))


def test_verbose_line_matches_jax(capsys):
    ref, dist = _pair("YUV420P8", 3, 96, 128, 10)
    vz.xpsnr(vz.Clip.from_planes(ref, vz.get_format("YUV420P8")),
             vz.Clip.from_planes(dist, vz.get_format("YUV420P8")), fps=24, verbose=True)
    want = capsys.readouterr().out
    out = vt.xpsnr(vt.Clip.from_planes(ref, vt.get_format("YUV420P8"), device="cpu"),
                   vt.Clip.from_planes(dist, vt.get_format("YUV420P8"), device="cpu"),
                   fps=24, verbose=True)
    got = capsys.readouterr().out
    assert got == want
    m = re.search(r"XPSNR average, 3 frames\s+y: ([0-9.]+)\s+u: ([0-9.]+)\s+v: ([0-9.]+)", got)
    assert m and float(m.group(1)) == pytest.approx(float(out.props["XPSNR_AVG"][0]), abs=1e-4)
