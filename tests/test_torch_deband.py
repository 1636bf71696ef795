"""vszip_tpu_torch.deband held against vszip_tpu.deband on seeded clips:
every sample mode on 16-bit, 4:2:2 (the non-symmetric m2 path), <16-bit
(the host demote round trip) and float formats; blur_first, dynamic grain,
keep_tv_range, per-plane lists, ranges 1/15/31/200; and every validation
message.  On the CPU the port's int modes 1-6 run the kernels' plain
versions, so this is also the slice's check of B5/B6's function.

Tolerances (the JAX package's own m6/m7 criteria, tests/test_deband.py:96-104):
integer planes bit-exact, except int m6/m7, which may be 1 LSB off on under
1% of pixels; f32 within rtol 2e-6 / atol 1e-6, m6/m7 f32 within rtol 2e-5 /
atol 2e-6.  Reason: XLA:CPU contracts the VCL pow/atan polynomials into FMA,
and the port rounds each product.
"""

import numpy as np
import pytest

import vszip_tpu as vz
import vszip_tpu_torch as vt
from test_torch_core import both_clips, make_planes, same_error

BASE = {"thr": 40, "grain": 12, "seed": 7}


def assert_deband_match(got, want, mode):
    for g, w in zip(got.planes, want.planes):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype == np.float32:
            tol = dict(rtol=2e-5, atol=2e-6) if mode in (6, 7) else dict(rtol=2e-6, atol=1e-6)
            np.testing.assert_allclose(g, w, **tol)
        elif mode in (6, 7):
            d = np.abs(g.astype(np.int64) - w.astype(np.int64))
            assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
        else:
            np.testing.assert_array_equal(g, w)


def run_both(fmt, data_seed, n=2, h=56, w=96, **kwargs):
    rng = np.random.default_rng(data_seed)
    cj, ct = both_clips(fmt, make_planes(fmt, rng, n, h, w))
    got = vt.deband(ct, **kwargs)
    assert got.format == ct.format and all(p.device.type == "cpu" for p in got.planes)
    return got, vz.deband(cj, **kwargs)


FORMATS = ("GRAY16", "YUV420P16", "YUV422P16", "YUV420P8", "GRAYS", "YUV444PS")


@pytest.mark.parametrize("mode", range(1, 8))
@pytest.mark.parametrize("fmt", FORMATS)
def test_deband_modes_match_jax(fmt, mode):
    got, want = run_both(fmt, [FORMATS.index(fmt), mode], sample_mode=mode, **BASE)
    assert_deband_match(got, want, mode)


OPTIONS = (
    {"blur_first": False, "sample_mode": 1},
    {"blur_first": False, "sample_mode": 2},
    {"blur_first": False, "sample_mode": 4},
    {"dynamic_grain": True, "sample_mode": 2},
    {"dynamic_grain": True, "sample_mode": 5, "grain": [12, 30]},
    {"keep_tv_range": True, "sample_mode": 3},
    {"thr": [48, 24, 6], "thr1": [60, 10], "thr2": 20, "grain": [16, 0],
     "sample_mode": 5},
    {"range": 1, "sample_mode": 2},
    {"range": 1, "sample_mode": 6},
    {"range": 31, "sample_mode": 1},
    {"range": 31, "sample_mode": 2},
    {"range": 0},
    {"random_algo_ref": 2, "random_param_ref": 2.0, "random_algo_grain": 0},
    {"seed": -5, "sample_mode": 7, "angle_boost": 4.0, "max_angle": 0.5},
)


@pytest.mark.parametrize("opts", OPTIONS, ids=str)
@pytest.mark.parametrize("fmt", ["YUV420P16", "YUV444PS"])
def test_deband_options_match_jax(fmt, opts):
    kwargs = {**BASE, **opts}
    got, want = run_both(fmt, [OPTIONS.index(opts)], **kwargs)
    assert_deband_match(got, want, kwargs.get("sample_mode", 2))


@pytest.mark.parametrize("mode", [1, 2])
def test_deband_range_200_matches_jax(mode):
    # 272x272 draws offsets up to ±135 in its centre: refEncode wraps 128 to
    # -128 and 129..135 to 127..121.  At range 200 m1 takes the plain
    # clamped gathers and m2 still takes B6's function.
    got, want = run_both("GRAY16", 3, n=1, h=272, w=272, range=200,
                         sample_mode=mode, thr=60)
    assert_deband_match(got, want, mode)


@pytest.mark.parametrize("fmt", ["RGB48", "YUV420P10", "GRAY8"])
def test_deband_other_int_formats_match_jax(fmt):
    got, want = run_both(fmt, 9, sample_mode=2, thr=[40, 20], grain=8)
    assert_deband_match(got, want, 2)


@pytest.mark.parametrize("fmt,kwargs", [
    ("YUV444PH", {}),
    ("GRAY32", {}),
    ("GRAY16", {"sample_mode": 8}),
    ("GRAY16", {"sample_mode": 0}),
    ("GRAY16", {"range": -1}),
    ("GRAY16", {"range": 256}),
    ("GRAY16", {"thr": 256}),
    ("GRAY16", {"thr": [1, 2, 3, 4]}),
    ("GRAY16", {"thr1": -1}),
    ("GRAY16", {"grain": [1, 2, 3]}),
    ("GRAY16", {"grain": 128}),
    ("GRAY16", {"seed": 2**31}),
    ("GRAY16", {"max_angle": 2}),
    ("GRAY16", {"random_algo_ref": 3}),
    ("GRAY16", {"random_param_grain": -1}),
], ids=str)
def test_deband_errors_match(fmt, kwargs):
    rng = np.random.default_rng(1)
    cj, ct = both_clips(fmt, make_planes(fmt, rng, 1, 8, 16))
    msg = same_error(lambda: vz.deband(cj, **kwargs), lambda: vt.deband(ct, **kwargs),
                     ValueError)
    assert msg.startswith("Deband: ")
