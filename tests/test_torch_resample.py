"""vszip_tpu_torch's format conversions (``core/resample.py``) held against
vszip_tpu's on seeded clips: ``bit_depth`` in every direction and with
every dither, ``to_rgbs`` on gray, 4:2:0 and 4:4:4 YUV (integer and float
chroma upsampling), RGB24 and RGBS, ``pick_matrix`` with and without a
``_Matrix`` prop and on both sides of height 650, ``srgb_to_linear`` with
and without ``_Transfer=8``, and ``resize`` on integer and float formats.

Tolerance: integer planes bit-exact (the Q14 resizes, shifts and dithers);
float planes rtol 2e-6 / atol 1e-6 (XLA:CPU's jit may contract the JAX
package's tap ladders and matrix into FMA, the port rounds each product and
sum; the float resize sums its matrix products in another order); f16
planes within one f16 ulp.
"""

import importlib

import numpy as np
import pytest

import vszip_tpu as vz
import vszip_tpu_torch as vt
from test_torch_core import assert_planes_match, both_clips, make_planes, same_error

jres = importlib.import_module("vszip_tpu.core.resample")
tres = importlib.import_module("vszip_tpu_torch.core.resample")


def _st(mod, name):
    return None if name is None else getattr(mod.SampleType, name)


@pytest.mark.parametrize("src,bits,st,dither", [
    ("YUV420P8", 10, None, "ordered"),
    ("GRAY8", 16, None, "ordered"),
    ("YUV420P10", 16, None, "none"),
    ("YUV420P16", 8, None, "ordered"),
    ("YUV420P16", 8, None, "none"),
    ("GRAY16", 10, None, "error_diffusion"),
    ("YUV420P10", 8, None, "error_diffusion"),
    ("YUV420P10", 8, None, "ordered"),
    ("GRAY10", 10, None, "ordered"),
    ("YUV420P8", 32, "FLOAT", "ordered"),
    ("GRAY10", 16, "FLOAT", "ordered"),
    ("RGBS", 8, "INTEGER", "ordered"),
    ("GRAYS", 16, "INTEGER", "ordered"),
    ("RGBS", 16, "FLOAT", "ordered"),
    ("GRAYH", 32, "FLOAT", "ordered"),
], ids=str)
def test_bit_depth_matches_jax(src, bits, st, dither):
    rng = np.random.default_rng([bits, len(src), len(dither)])
    cj, ct = both_clips(src, make_planes(src, rng, 2, 26, 38))
    want = vz.bit_depth(cj, bits, _st(vz, st), dither=dither)
    got = vt.bit_depth(ct, bits, _st(vt, st), dither=dither)
    assert got.format.name == want.format.name
    assert_planes_match(got.planes, want.planes)


def test_bit_depth_unknown_dither():
    cj, ct = both_clips("GRAY16", make_planes("GRAY16", np.random.default_rng(0), 1, 8, 8))
    same_error(lambda: vz.bit_depth(cj, 8, dither="bayer"),
               lambda: vt.bit_depth(ct, 8, dither="bayer"))


@pytest.mark.parametrize("fmt,props", [
    ("GRAY8", {}),
    ("YUV420P8", {}),
    ("YUV420P16", {}),
    ("YUV420P16", {"_Matrix": 1}),
    ("YUV444P16", {"_Matrix": 6}),
    ("YUV420PS", {}),
    ("YUV422P10", {"_Matrix": 5}),
    ("RGB24", {}),
    ("RGBS", {}),
], ids=str)
def test_to_rgbs_matches_jax(fmt, props):
    rng = np.random.default_rng(len(fmt) + len(props))
    planes = make_planes(fmt, rng, 2, 30, 44)
    cj = vz.Clip.from_planes(planes, vz.get_format(fmt), props)
    ct = vt.Clip.from_planes(planes, vt.get_format(fmt), props, device="cpu")
    got, want = vt.to_rgbs(ct), vz.to_rgbs(cj)
    assert got.format.name == want.format.name == "RGBS"
    assert_planes_match(got.planes, want.planes)


@pytest.mark.parametrize("h", [650, 652])
@pytest.mark.parametrize("matrix", [None, 1, 5, 6, 2, np.int64(1), 1.0], ids=repr)
def test_pick_matrix_matches_jax(h, matrix):
    planes = make_planes("YUV420P8", np.random.default_rng(0), 1, h, 8)
    props = {} if matrix is None else {"_Matrix": matrix}
    cj = vz.Clip.from_planes(planes, vz.get_format("YUV420P8"), props)
    ct = vt.Clip.from_planes(planes, vt.get_format("YUV420P8"), props, device="cpu")
    assert tres.pick_matrix(ct) == jres.pick_matrix(cj)


def test_matrix_override_matches_jax():
    planes = make_planes("YUV420P10", np.random.default_rng(1), 1, 24, 32)
    cj, ct = both_clips("YUV420P10", planes)
    for m in (1, 6):
        assert_planes_match(vt.to_rgbs(ct, matrix=m).planes, vz.to_rgbs(cj, matrix=m).planes)


@pytest.mark.parametrize("transfer", [None, 8, 1], ids=str)
def test_srgb_to_linear_matches_jax(transfer):
    rng = np.random.default_rng(3)
    planes = make_planes("RGBS", rng, 2, 20, 28)
    planes[0][0, :2] = np.linspace(0.0, 0.05, 56, dtype=np.float32).reshape(2, 28)
    props = {} if transfer is None else {"_Transfer": transfer}
    cj = vz.Clip.from_planes(planes, vz.get_format("RGBS"), props)
    ct = vt.Clip.from_planes(planes, vt.get_format("RGBS"), props, device="cpu")
    got, want = vt.srgb_to_linear(ct), vz.srgb_to_linear(cj)
    assert got.props["_Transfer"] == want.props["_Transfer"] == 8
    assert_planes_match(got.planes, want.planes)
    if transfer == 8:
        assert got is ct


@pytest.mark.parametrize("fmt,w,h,kernel", [
    ("YUV420P8", 88, 60, "bicubic"),
    ("YUV420P8", 22, 14, "bicubic"),
    ("GRAY16", 61, 37, "bilinear"),
    ("YUV444P10", 44, 90, "point"),
    ("RGBS", 88, 60, "bicubic"),
    ("YUV420PS", 30, 20, "bicubic"),
    ("GRAYH", 50, 33, "bilinear"),
], ids=str)
def test_resize_matches_jax(fmt, w, h, kernel):
    rng = np.random.default_rng(w * h)
    cj, ct = both_clips(fmt, make_planes(fmt, rng, 2, 30, 44))
    got = vt.resize(ct, w, h, kernel=kernel)
    want = vz.resize(cj, w, h, kernel=kernel)
    assert (got.width, got.height) == (want.width, want.height) == (w, h)
    assert_planes_match(got.planes, want.planes)


def test_resize_errors():
    cj, ct = both_clips("YUV420P8", make_planes("YUV420P8", np.random.default_rng(0), 1, 8, 8))
    same_error(lambda: vz.resize(cj, 9, 8), lambda: vt.resize(ct, 9, 8))
    same_error(lambda: vz.resize(cj, 16, 8, kernel="lanczos"),
               lambda: vt.resize(ct, 16, 8, kernel="lanczos"))


def test_props_cross_over_as_scalars():
    # the props the metrics read keep their type through from_reference, so
    # pick_matrix, the _Transfer check and the fps rule take the JAX
    # package's branches
    planes = make_planes("YUV420P8", np.random.default_rng(2), 1, 700, 8)
    props = {"_Matrix": np.int64(6), "_Transfer": 8, "_FpsNum": 60000, "_FpsDen": 1001}
    cj = vz.Clip.from_planes(planes, vz.get_format("YUV420P8"), props)
    ct = vt.from_reference([np.asarray(p) for p in cj.planes], "YUV420P8", cj.props,
                           device="cpu")
    for k, v in props.items():
        assert type(ct.props[k]) is type(v) and ct.props[k] == v
    assert tres.pick_matrix(ct) == jres.pick_matrix(cj) == 6
    assert vt.srgb_to_linear(vt.to_rgbs(ct)).props["_Transfer"] == 8
