"""The port's plain filters (LimitFilter, AdaptiveBinarize, PackRGB, RFS,
ColorMap) and ``scale_value`` held against the JAX package on seeded planes,
on the CPU (PlaneAverage and PlaneMinMax: ``test_torch_plane_stats.py``).

Tolerances: planes and integer props bit-exact; f32 props (float min/max)
exact; f64 props (averages, diffs) within rtol 1e-12, since a float sum's
rounding depends on its order; error messages equal.
"""

import numpy as np
import pytest
import torch
from test_torch_core import both_clips, make_planes, same_error

import vszip_tpu as vz
import vszip_tpu_torch as vt
from vszip_tpu.core import params as jparams
from vszip_tpu.ops.adaptive_binarize import adaptive_binarize as j_binarize
from vszip_tpu.ops.colormap import _lut as j_lut
from vszip_tpu.ops.colormap import colormap as j_colormap
from vszip_tpu.ops.limit_filter import limit_filter as j_limit
from vszip_tpu.ops.packrgb import packrgb as j_packrgb
from vszip_tpu.ops.planeaverage import plane_average as j_avg
from vszip_tpu.ops.rfs import rfs as j_rfs
from vszip_tpu_torch.core import params as tparams
from vszip_tpu_torch.ops.colormap import _lut as t_lut

N, H, W = 3, 24, 40


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_clip_matches(got, want, props=()):
    """Planes bit-exact, format equal, and `props` as the docstring says."""
    assert got.format.name == want.format.name
    assert len(got.planes) == len(want.planes)
    for g, w in zip(got.planes, want.planes):
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    for k in props:
        g, w = _np(got.props[k]), np.asarray(want.props[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == np.float64:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def clips(fmt, seed, n=N, h=H, w=W):
    return both_clips(fmt, make_planes(fmt, np.random.default_rng(seed), n, h, w))


# ---------------------------------------------------------------------------
# scale_value
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["GRAY8", "GRAY10", "YUV420P16", "GRAYH", "RGBS", "GRAY32"])
@pytest.mark.parametrize("color_range", [None, "FULL", "LIMITED"])
@pytest.mark.parametrize("prop", [None, 0, 1])
def test_scale_value_matches(fmt, color_range, prop):
    jc, tc = clips(fmt, 0, n=1, h=4, w=4)
    if prop is not None:
        jc, tc = jc.with_props(_ColorRange=prop), tc.with_props(_ColorRange=prop)
    for value in (0.0, 1.0, 16.5, 128.0, 235.0, 255.0, 1023.0):
        for depth_in in (8, 10, 16):
            for chroma in (False, True):
                for st in ("INTEGER", "FLOAT"):
                    if st == "FLOAT" and depth_in != 16:
                        continue
                    kw = dict(depth_in=depth_in, chroma=chroma)
                    jkw = dict(kw, sample_type_in=vz.SampleType[st])
                    tkw = dict(kw, sample_type_in=vt.SampleType[st])
                    if color_range is not None:
                        jkw["color_range"] = vz.ColorRange[color_range]
                        tkw["color_range"] = vt.ColorRange[color_range]
                    assert tparams.scale_value(value, tc, **tkw) == \
                        jparams.scale_value(value, jc, **jkw)


# ---------------------------------------------------------------------------
# LimitFilter
# ---------------------------------------------------------------------------

def _limit_inputs(fmt, seed):
    """flt random; src and ref within about 12 8-bit steps of it, so every
    branch (flt, src, the ramp) is taken."""
    rng = np.random.default_rng(seed)
    f = vz.get_format(fmt)
    flt = make_planes(fmt, rng, N, H, W)
    if f.sample_type.name == "INTEGER":
        step = 1 << (f.bits_per_sample - 8)
        near = [np.clip(p.astype(np.int64) + rng.integers(-12, 13, p.shape) * step, 0,
                        (1 << f.bits_per_sample) - 1).astype(p.dtype) for p in flt]
        ref = [np.clip(p.astype(np.int64) + rng.integers(-12, 13, p.shape) * step, 0,
                       (1 << f.bits_per_sample) - 1).astype(p.dtype) for p in flt]
    else:
        near = [(p.astype(np.float32) + rng.uniform(-12, 12, p.shape).astype(np.float32) / 255)
                .astype(p.dtype) for p in flt]
        ref = [(p.astype(np.float32) + rng.uniform(-12, 12, p.shape).astype(np.float32) / 255)
               .astype(p.dtype) for p in flt]
    return both_clips(fmt, flt), both_clips(fmt, near), both_clips(fmt, ref)


@pytest.mark.parametrize("fmt", ["GRAY8", "GRAY10", "GRAY16", "GRAYH", "GRAYS", "YUV420P16"])
@pytest.mark.parametrize("args", [
    {},
    {"dark_thr": 3.0, "bright_thr": 5.0, "elast": 2.5},
    {"dark_thr": [2.0, 6.0], "bright_thr": 7.5, "elast": [1.5, 4.0, 3.0], "planes": [0, 2]},
    {"dark_thr": 0.0, "bright_thr": 0.0},
    {"dark_thr": 255.0, "bright_thr": 255.0, "elast": 1.0},
    {"with_ref": True, "dark_thr": 4.0, "bright_thr": 2.0, "elast": 3.0},
], ids=str)
def test_limit_filter_matches(fmt, args):
    (jf, tf), (js, ts), (jr, tr) = _limit_inputs(fmt, 1)
    args = dict(args)
    if args.pop("with_ref", False):
        args_j, args_t = dict(args, ref=jr), dict(args, ref=tr)
    else:
        args_j, args_t = args, args
    if "planes" in args and jf.format.num_planes == 1:
        args_j = dict(args_j, planes=[0])
        args_t = dict(args_t, planes=[0])
    assert_clip_matches(vt.limit_filter(tf, ts, **args_t), j_limit(jf, js, **args_j))


def test_limit_filter_errors_match():
    (jf, tf), (js, ts), _ = _limit_inputs("GRAY16", 2)
    j32, t32 = clips("GRAY32", 3)
    jo, to = clips("GRAY16", 4, w=W + 2)
    jl, tl = clips("GRAY16", 5, n=N + 1)
    same_error(lambda: j_limit(j32, j32), lambda: vt.limit_filter(t32, t32))
    same_error(lambda: j_limit(jf, jo), lambda: vt.limit_filter(tf, to))
    same_error(lambda: j_limit(jf, jl), lambda: vt.limit_filter(tf, tl))
    same_error(lambda: j_limit(jf, js, dark_thr=[1, 2, 3, 4]),
               lambda: vt.limit_filter(tf, ts, dark_thr=[1, 2, 3, 4]))
    same_error(lambda: j_limit(jf, js, bright_thr=256), lambda: vt.limit_filter(tf, ts,
                                                                                bright_thr=256))
    same_error(lambda: j_limit(jf, js, planes=[1]), lambda: vt.limit_filter(tf, ts, planes=[1]))


# ---------------------------------------------------------------------------
# AdaptiveBinarize, PackRGB
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["GRAY8", "YUV420P8", "RGB24"])
@pytest.mark.parametrize("c", [3, 0, -7, 40, -300, 300])
def test_adaptive_binarize_matches(fmt, c):
    j1, t1 = clips(fmt, 6)
    j2, t2 = clips(fmt, 7)
    got, want = vt.adaptive_binarize(t1, t2, c=c), j_binarize(j1, j2, c=c)
    assert_clip_matches(got, want)
    assert got.props["_ColorRange"] == want.props["_ColorRange"] == 0


def test_adaptive_binarize_errors_match():
    j16, t16 = clips("GRAY16", 8)
    j1, t1 = clips("GRAY8", 9)
    js, ts = clips("GRAY8", 10, n=N - 1)
    jw, tw = clips("GRAY8", 11, w=W + 2)
    same_error(lambda: j_binarize(j16, j16), lambda: vt.adaptive_binarize(t16, t16))
    same_error(lambda: j_binarize(j1, js), lambda: vt.adaptive_binarize(t1, ts))
    same_error(lambda: j_binarize(j1, jw), lambda: vt.adaptive_binarize(t1, tw))


@pytest.mark.parametrize("fmt", ["RGB24", "RGB30"])
def test_packrgb_matches(fmt):
    jc, tc = clips(fmt, 12)
    jc, tc = jc.with_props(_Foo=3), tc.with_props(_Foo=3)
    got, want = vt.packrgb(tc), j_packrgb(jc)
    assert_clip_matches(got, want)
    assert got.planes[0].dtype == torch.uint32 and got.props["_Foo"] == 3
    # every channel at its peak sets every bit of the packed word
    peak = tuple(np.full((1, 2, 2), (1 << tc.format.bits_per_sample) - 1,
                         tc.format.storage_dtype) for _ in range(3))
    top = vt.packrgb(vt.Clip.from_planes(peak, tc.format, device="cpu"))
    assert int(top.planes[0][0, 0, 0]) == 0xFFFFFFFF


@pytest.mark.parametrize("fmt", ["RGB48", "GRAY8", "YUV444P8"])
def test_packrgb_errors_match(fmt):
    jc, tc = clips(fmt, 13)
    same_error(lambda: j_packrgb(jc), lambda: vt.packrgb(tc))


# ---------------------------------------------------------------------------
# RFS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["GRAY16", "YUV420P8", "YUV444PH", "RGBS", "GRAY32"])
@pytest.mark.parametrize("args", [
    {"frames": [0, 2]}, {"frames": [1], "planes": [0]}, {}, {"frames": [2], "mismatch": True},
    {"frames": [0, 1, 2], "planes": 0},
], ids=str)
def test_rfs_matches(fmt, args):
    ja, ta = clips(fmt, 14)
    jb, tb = clips(fmt, 15, n=N + 2)
    assert_clip_matches(vt.rfs(ta, tb, **args), j_rfs(ja, jb, **args))


def test_rfs_planes_subset_keeps_the_other_planes():
    ja, ta = clips("YUV420P16", 16)
    jb, tb = clips("YUV420P16", 17)
    got = vt.rfs(ta, tb, frames=[1], planes=[1, 2])
    assert_clip_matches(got, j_rfs(ja, jb, frames=[1], planes=[1, 2]))
    assert torch.equal(got.planes[0], ta.planes[0])
    assert torch.equal(got.planes[1][1], tb.planes[1][1])


@pytest.mark.parametrize("other", ["format", "dims"])
def test_rfs_mismatch_variable_clip_matches(other):
    ja, ta = clips("YUV420P8", 18)
    jb, tb = (clips("YUV420P16", 19, n=2) if other == "format"
              else clips("YUV420P8", 19, n=2, w=W + 8))
    got = vt.rfs(ta, tb, frames=[0, 2], mismatch=True)
    want = j_rfs(ja, jb, frames=[0, 2], mismatch=True)
    assert isinstance(got, vt.VariableClip)
    assert got.table == want.table
    assert (got.width, got.height, got.num_frames) == (want.width, want.height,
                                                       want.num_frames)
    assert bool(got.format) == bool(want.format)
    for k in range(got.num_frames):
        assert_clip_matches(got.get_frame(k), want.get_frame(k))
    same_error(lambda: want.planes, lambda: got.planes)
    same_error(lambda: j_avg(want), lambda: vt.plane_average(got))


def test_rfs_errors_match():
    ja, ta = clips("YUV420P8", 20)
    jf, tf = clips("YUV420P16", 21)
    jd, td = clips("YUV420P8", 22, w=W + 8)
    same_error(lambda: j_rfs(ja, jf), lambda: vt.rfs(ta, tf))
    same_error(lambda: j_rfs(ja, jd), lambda: vt.rfs(ta, td))
    same_error(lambda: j_rfs(ja, ja, frames=[-1]), lambda: vt.rfs(ta, ta, frames=[-1]))
    same_error(lambda: j_rfs(ja, ja, frames=[N]), lambda: vt.rfs(ta, ta, frames=[N]))
    same_error(lambda: j_rfs(ja, ja, planes=[3]), lambda: vt.rfs(ta, ta, planes=[3]))
    same_error(lambda: j_rfs(ja, jf, frames=[0], planes=[0], mismatch=True),
               lambda: vt.rfs(ta, tf, frames=[0], planes=[0], mismatch=True))


# ---------------------------------------------------------------------------
# ColorMap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("color", range(22))
def test_colormap_matches(color):
    np.testing.assert_array_equal(t_lut(color), np.stack(j_lut(color)))
    every = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
    planes = [np.concatenate([every, make_planes("GRAY8", np.random.default_rng(color), 1,
                                                 16, 16)[0]])]
    jc, tc = both_clips("GRAY8", planes)
    jc, tc = jc.with_props(_Foo=1), tc.with_props(_Foo=1)
    got, want = vt.colormap(tc, color), j_colormap(jc, color)
    assert_clip_matches(got, want)
    assert got.props == want.props


def test_colormap_errors_match():
    j16, t16 = clips("GRAY16", 34)
    j8, t8 = clips("GRAY8", 35)
    same_error(lambda: j_colormap(j16), lambda: vt.colormap(t16))
    same_error(lambda: j_colormap(j8, 22), lambda: vt.colormap(t8, 22))
    same_error(lambda: j_colormap(j8, -1), lambda: vt.colormap(t8, -1))
