"""The ported slice end to end against the JAX package at a reduced size:
the flagship step ``boxblur(r=13) -> limiter(tv_range=True)`` that
``__graft_entry__.py`` runs, the bench's 5-pass row, the BoxBlur settings
of ``benchmarks/tpu_parity.py`` (``boxblur_ct``, ``boxblur_x3``), and the
bench's two Deband rows (``deband(sample_mode=1)`` and ``deband()``,
``bench.py:113-116``), the CLAHE and EEDI3 rows (``clahe(c)`` on GRAY8
and ``eedi3(c, field=1, dh=True)`` on GRAYS, ``bench.py:118-125``) and the
metric rows (``xpsnr(c1, c2, fps=24)`` and ``ssimulacra2(r1, r2)``, built
as ``bench.py:151-168`` builds them), and the 8-bit rows of
``chip_smoke.py`` (``compress(c)``, ``compress(c, codec=1, quality=95)``,
``checkmate(c)``, ``checkmate(c, tthr2=10)``, ``comb_mask(c)``) and its
banded rows (``bilateral_dither(c)``, ``bilateral_dither(c, radius=8,
thr=8.0, subspl=2.0)``, ``mosquito_nr(c)``).  The JAX clip's state
crosses over through ``from_reference``.

Tolerance: every integer plane bit-exact; EEDI3's f32 planes within
max |d| < 2e-6 (the ROADMAP's EEDI3 criterion); XPSNR's ``_XPSNR_WSSE``
equal and its props within rtol 1e-12; the SSIMULACRA2 score within rtol
1e-3 / atol 1e-6 (the metric's criterion).  Size: 4 frames of 128x192
YUV420P16 (the bench runs 64 frames of 1920x1080); CLAHE 4 frames of
108x192 GRAY8 (bench: 64 of 1080x1920), EEDI3 2 frames of 27x96 GRAYS
(bench: 8 of 540x1920), XPSNR 4 frames of 128x192 YUV420P10 (bench: 32 of
1080p), SSIMULACRA2 2 frames of 128x192 RGBS (bench: 8 of 1080p), the
8-bit rows 4 frames of 74x102 YUV420P8 and the banded rows 4 frames of
74x102 YUV420P16 (``chip_smoke.py``: 64 of 1080p).
"""

import numpy as np
import pytest

import vszip_tpu as vz
import vszip_tpu_torch as vt
from test_torch_core import assert_planes_match, make_planes

N, H, W = 4, 128, 192

STEPS = {
    "flagship": (lambda m, c: m.limiter(m.boxblur(c, hradius=13, vradius=13),
                                        tv_range=True)),
    "bench_5pass": (lambda m, c: m.boxblur(c, hradius=13, hpasses=5, vradius=13,
                                           vpasses=5)),
    "boxblur_ct": lambda m, c: m.boxblur(c, hradius=13, vradius=13),
    "boxblur_x3": (lambda m, c: m.boxblur(c, hradius=5, hpasses=3, vradius=5,
                                          vpasses=3)),
    "rt_single": lambda m, c: m.boxblur(c, hradius=23, vradius=23),
    "deband_m1": lambda m, c: m.deband(c, sample_mode=1),
    "deband_m2": lambda m, c: m.deband(c),
}


def _reference_clip(seed):
    rng = np.random.default_rng(seed)
    fmt = vz.get_format("YUV420P16")
    return vz.Clip.from_planes(make_planes("YUV420P16", rng, N, H, W), fmt).device()


@pytest.mark.parametrize("step", sorted(STEPS))
def test_slice_matches_jax(step):
    cj = _reference_clip(7)
    ct = vt.from_reference([np.asarray(p) for p in cj.planes], "YUV420P16",
                           device="cpu")
    got = STEPS[step](vt, ct)
    want = STEPS[step](vz, cj)
    assert got.format == ct.format and got.num_frames == N
    assert_planes_match(got.planes, want.planes)


BENCH_ROWS = {
    "clahe_8bit": ("GRAY8", 4, 108, 192, lambda m, c: m.clahe(c)),
    "eedi3_dh": ("GRAYS", 2, 27, 96, lambda m, c: m.eedi3(c, field=1, dh=True)),
}


@pytest.mark.parametrize("row", sorted(BENCH_ROWS))
def test_slice_bench_rows_match_jax(row):
    fmt, n, h, w, fn = BENCH_ROWS[row]
    cj = vz.Clip.from_planes(make_planes(fmt, np.random.default_rng(3), n, h, w),
                             vz.get_format(fmt))
    ct = vt.from_reference([np.asarray(p) for p in cj.planes], fmt, device="cpu")
    got, want = fn(vt, ct), fn(vz, cj)
    assert (got.num_frames, got.height, got.width) == (want.num_frames, want.height,
                                                       want.width)
    if fmt == "GRAYS":
        for g, x in zip(got.planes, want.planes):
            assert g.shape == x.shape and np.abs(g.numpy() - np.asarray(x)).max() < 2e-6
    else:
        assert_planes_match(got.planes, want.planes)


def _metric_clips(rng):
    """The bench's metric inputs (bench.py:151-168) at a reduced size, as
    JAX clips: c1/c2 YUV420P10 (c2 = c1 + integers(-8, 8), clipped), r1/r2
    RGBS (r2 = clip(r1 + 0.01, 0, 1))."""
    c1 = vz.Clip.from_planes(make_planes("YUV420P10", rng, N, H, W), vz.get_format("YUV420P10"))
    c2 = vz.Clip.from_planes(
        tuple(np.clip(np.asarray(a).astype(np.int32) + rng.integers(-8, 8, a.shape), 0, 1023)
              .astype(np.uint16) for a in c1.planes), vz.get_format("YUV420P10"))
    r1 = vz.Clip.from_planes(tuple(rng.random((2, H, W), dtype=np.float32) for _ in range(3)),
                             vz.get_format("RGBS"))
    r2 = vz.Clip.from_planes(tuple(np.clip(np.asarray(p) + 0.01, 0, 1) for p in r1.planes),
                             vz.get_format("RGBS"))
    return c1, c2, r1, r2


def _port(c):
    return vt.from_reference([np.asarray(p) for p in c.planes], c.format.name,
                             {k: np.asarray(v) for k, v in c.props.items()}, device="cpu")


@pytest.mark.parametrize("row", ["xpsnr", "ssimulacra2"])
def test_slice_metric_rows_match_jax(row):
    c1, c2, r1, r2 = _metric_clips(np.random.default_rng(11))
    if row == "xpsnr":
        want = vz.xpsnr(c1, c2, fps=24)
        got = vt.xpsnr(_port(c1), _port(c2), fps=24)
        np.testing.assert_array_equal(got.props["_XPSNR_WSSE"].numpy(),
                                      np.asarray(want.props["_XPSNR_WSSE"]))
        for k in ("XPSNR_Y", "XPSNR_U", "XPSNR_V", "XPSNR_AVG"):
            np.testing.assert_allclose(got.props[k].numpy(), np.asarray(want.props[k]),
                                       rtol=1e-12, atol=0)
    else:
        want = np.asarray(vz.ssimulacra2(r1, r2).props["SSIMULACRA2"])
        got = vt.ssimulacra2(_port(r1), _port(r2)).props["SSIMULACRA2"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6,
                                   err_msg=f"max |d| {np.abs(got - want).max():.3e}")


INT8_ROWS = {
    "compress_mpeg2_q8": lambda m, c: m.compress(c),
    "compress_jpeg_q95": lambda m, c: m.compress(c, codec=1, quality=95),
    "checkmate_default": lambda m, c: m.checkmate(c),
    "checkmate_tthr2": lambda m, c: m.checkmate(c, tthr2=10),
    "comb_mask_default": lambda m, c: m.comb_mask(c),
}


@pytest.mark.parametrize("row", sorted(INT8_ROWS))
def test_slice_int8_rows_match_jax(row):
    """A smooth moving picture with noise and a band of combed rows, as
    chip_smoke.py builds it, so both branches of each filter are taken."""
    rng = np.random.default_rng(11)
    fmt = vz.get_format("YUV420P8")
    planes = []
    for p in range(3):
        pw, ph = fmt.plane_dims(102, 74, p)
        y, x = np.mgrid[:ph, :pw]
        f = np.arange(N)[:, None, None]
        v = 128 + 60 * np.sin(x / 37 + f / 5) * np.cos(y / 23 - f / 11)
        v = v + rng.integers(-3, 4, v.shape)
        v[:, ph // 3:2 * ph // 3:2] += 40
        planes.append(np.clip(v, 0, 255).astype(np.uint8))
    cj = vz.Clip.from_planes(planes, fmt).device()
    ct = vt.from_reference([np.asarray(p) for p in cj.planes], "YUV420P8", device="cpu")
    got = INT8_ROWS[row](vt, ct)
    assert got.format == ct.format and got.num_frames == N
    assert_planes_match(got.planes, INT8_ROWS[row](vz, cj).planes)


BANDED_ROWS = {
    "bilateral_dither_default": lambda m, c: m.bilateral_dither(c),
    "bilateral_dither_r8_dense": lambda m, c: m.bilateral_dither(c, radius=8, thr=8.0,
                                                                  subspl=2.0),
    "mosquito_nr_default": lambda m, c: m.mosquito_nr(c),
}


@pytest.mark.parametrize("row", sorted(BANDED_ROWS))
def test_slice_banded_rows_match_jax(row):
    """A smooth gradient quantised into 8-bit steps that moves a little per
    frame, noise of +-1 step and a flat top eighth, as chip_smoke.py builds
    it, so BilateralDither's weights fall between 0 and wmax."""
    rng = np.random.default_rng(12)
    fmt = vz.get_format("YUV420P16")
    planes = []
    for p in range(3):
        pw, ph = fmt.plane_dims(102, 74, p)
        y, x = np.mgrid[:ph, :pw]
        f = np.arange(N)[:, None, None]
        v = np.floor(255 * (0.5 + 0.35 * np.sin(x / 9 + f / 7) * np.cos(y / 7 - f / 13)))
        v = v + rng.integers(-1, 2, v.shape)
        v[:, :ph // 8] = 128
        planes.append((v * 256).astype(np.uint16))
    cj = vz.Clip.from_planes(planes, fmt).device()
    ct = vt.from_reference([np.asarray(p) for p in cj.planes], "YUV420P16", device="cpu")
    got = BANDED_ROWS[row](vt, ct)
    assert got.format == ct.format and got.num_frames == N
    assert_planes_match(got.planes, BANDED_ROWS[row](vz, cj).planes)
    assert 0.01 < (got.planes[0].numpy() != planes[0]).mean() < 0.99
