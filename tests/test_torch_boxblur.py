"""vszip_tpu_torch.boxblur held against vszip_tpu.boxblur on seeded clips:
the comptime and runtime paths, multipass floats, the hpasses=0 quirk, plane
selection, and every validation message.

Tolerances (``assert_planes_match``): integer planes bit-exact; f32 planes
rtol 2e-6 / atol 1e-6; f16 planes within one f16 ulp.  The float paths run
the reference's add order as separate multiplies and adds; XLA:CPU contracts
the JAX tap ladders into FMA, which moves single-pass float results by an
ulp.  Multipass floats come out exactly equal.
"""

import numpy as np
import pytest

import vszip_tpu as vz
import vszip_tpu_torch as vt
from test_torch_core import assert_planes_match, both_clips, make_planes, same_error

FORMATS = ("GRAY8", "YUV420P10", "YUV420P16", "GRAYH", "GRAYS", "RGBS")

# 56x96 luma, 28x48 chroma: every radius below fits every plane
ARGS = (
    {"hradius": 1, "vradius": 1},                                # comptime
    {"hradius": 13, "vradius": 13},                              # comptime, bench radius
    {"hradius": 4, "vradius": 9},                                # runtime, hr != vr
    {"hradius": 23, "vradius": 5},                               # runtime, r > 22
    {"hradius": 7, "vradius": 0, "vpasses": 0},                  # H only
    {"hradius": 0, "hpasses": 0, "vradius": 7},                  # V only
    {"hradius": 5, "vradius": 5, "hpasses": 0},                  # quirk: still both axes
    {"hradius": 5, "vradius": 5, "hpasses": 3, "vpasses": 3},    # multipass
    {"hradius": 6, "vradius": 3, "hpasses": 2, "vpasses": 1},    # float exact, int fused H
    {"hradius": 5, "vradius": 5, "planes": [0]},
)


@pytest.mark.parametrize("args", ARGS, ids=str)
@pytest.mark.parametrize("fmt", FORMATS)
def test_boxblur_matches_jax(fmt, args):
    rng = np.random.default_rng([FORMATS.index(fmt), ARGS.index(args)])
    cj, ct = both_clips(fmt, make_planes(fmt, rng))
    out = vt.boxblur(ct, **args)
    assert out.format == ct.format
    assert_planes_match(out.planes, vz.boxblur(cj, **args).planes)


def test_boxblur_keeps_unprocessed_planes():
    rng = np.random.default_rng(2)
    cj, ct = both_clips("YUV420P16", make_planes("YUV420P16", rng))
    out = vt.boxblur(ct, planes=[1, 2], hradius=3, vradius=3)
    assert out.planes[0] is ct.planes[0]
    assert_planes_match(out.planes, vz.boxblur(cj, planes=[1, 2], hradius=3, vradius=3).planes)


@pytest.mark.parametrize("fmt,kwargs", [
    ("GRAY16", {"hradius": 0, "vradius": 0}),
    ("GRAY16", {"hradius": 3, "hpasses": 0, "vradius": 0}),
    ("GRAY16", {"hradius": 48, "vradius": 1}),
    ("GRAY16", {"hradius": 1, "vradius": 28}),
    ("YUV420P8", {"hradius": 24, "vradius": 1}),
    ("YUV420P8", {"hradius": 1, "vradius": 14}),
    ("GRAY16", {"hradius": -1, "vradius": 1}),
    ("GRAY16", {"planes": [1]}),
    ("GRAY16", {"planes": [0, 0]}),
    ("GRAY32", {}),
], ids=str)
def test_boxblur_errors_match(fmt, kwargs):
    rng = np.random.default_rng(1)
    cj, ct = both_clips(fmt, make_planes(fmt, rng))
    msg = same_error(lambda: vz.boxblur(cj, **kwargs), lambda: vt.boxblur(ct, **kwargs),
                     ValueError)
    assert msg.startswith("BoxBlur: ")


@pytest.mark.parametrize("args", [{"hradius": 13, "vradius": 1},
                                  {"hradius": 13, "hpasses": 5, "vradius": 1},
                                  {"hradius": 1, "vradius": 1}], ids=str)
@pytest.mark.parametrize("fmt", ["GRAY8", "GRAY16"])
def test_rows_wider_than_shared_memory_match_jax(fmt, args):
    # 65,536 columns: on the card these rows take h_fixed's global scratch
    rng = np.random.default_rng(len(str(args)))
    cj, ct = both_clips(fmt, make_planes(fmt, rng, 1, 4, 65536))
    assert_planes_match(vt.boxblur(ct, **args).planes, vz.boxblur(cj, **args).planes)
