"""The port's PlaneAverage and PlaneMinMax held against the JAX package on
seeded planes, on the CPU: integer and float formats, ``planes``, ``clipb``,
``exclude``, thresholds on both sides of the binary search's edges, and the
errors.

Tolerances: integer props bit-exact; f32 props (float min/max) exact; f64
props (averages, diffs) within rtol 1e-12, since a float sum's rounding
depends on its order; error messages equal.
"""

import numpy as np
import pytest
from test_torch_core import both_clips, make_planes, same_error
from test_torch_plain_filters import H, N, W, assert_clip_matches, clips

import vszip_tpu as vz
import vszip_tpu_torch as vt
from vszip_tpu.ops.planeaverage import plane_average as j_avg
from vszip_tpu.ops.planeminmax import plane_minmax as j_minmax


# ---------------------------------------------------------------------------
# PlaneAverage
# ---------------------------------------------------------------------------

def _planted(fmt, seed, values):
    """Seeded planes with `values` planted on about a third of the pixels."""
    rng = np.random.default_rng(seed)
    planes = make_planes(fmt, rng, N, H, W)
    for p in planes:
        mask = rng.random(p.shape) < 0.33
        p[mask] = rng.choice(np.asarray(values, p.dtype), int(mask.sum()))
    return both_clips(fmt, planes)


@pytest.mark.parametrize("fmt,exclude", [
    ("GRAY8", None), ("GRAY8", [0, 255, 17]), ("GRAY16", [65535, 0]), ("GRAY10", [1023]),
    ("GRAYH", None), ("GRAYH", [0.5, 0.25]), ("GRAYS", [0.5]), ("GRAYS", None),
    ("YUV420P16", [-1]), ("RGB24", [3]), ("GRAY32", None), ("GRAY16", [65536 + 7]),
], ids=str)
@pytest.mark.parametrize("args", [{}, {"planes": [0, 1, 2]}, {"clipb": True, "prop": "x"}],
                         ids=str)
def test_plane_average_matches(fmt, exclude, args):
    values = [v for v in (exclude or [7]) if 0 <= v < 65536] or [7]
    ja, ta = _planted(fmt, 23, values)
    args = dict(args)
    if ja.format.num_planes == 1 and "planes" in args:
        args["planes"] = [0]
    jargs, targs = dict(args), dict(args)
    if args.pop("clipb", False):
        jb, tb = clips(fmt, 24, n=N + 1)
        jargs["clipb"], targs["clipb"] = jb, tb
    prop = args.get("prop", "psm")
    keys = [f"{prop}Avg"] + ([f"{prop}Diff"] if "clipb" in jargs else [])
    assert_clip_matches(vt.plane_average(ta, exclude=exclude, **targs),
                        j_avg(ja, exclude=exclude, **jargs), keys)


def test_plane_average_excluding_everything_gives_zero():
    planes = [np.full((2, 8, 8), 9, np.uint8)]
    ja, ta = both_clips("GRAY8", planes)
    got = vt.plane_average(ta, exclude=[9])
    assert_clip_matches(got, j_avg(ja, exclude=[9]), ["psmAvg"])
    assert got.props["psmAvg"].tolist() == [[0.0], [0.0]]


def test_plane_average_errors_match():
    j32, t32 = clips("GRAY32", 25)
    ja, ta = clips("YUV420P8", 26)
    js, ts = clips("YUV420P8", 27, n=N - 1)
    same_error(lambda: j_avg(j32, exclude=[1]), lambda: vt.plane_average(t32, exclude=[1]))
    same_error(lambda: j_avg(ja, planes=[3]), lambda: vt.plane_average(ta, planes=[3]))
    same_error(lambda: j_avg(ja, planes=[0, 0]), lambda: vt.plane_average(ta, planes=[0, 0]))
    same_error(lambda: j_avg(ja, clipb=js), lambda: vt.plane_average(ta, clipb=ts))


# ---------------------------------------------------------------------------
# PlaneMinMax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["GRAY8", "GRAY16", "GRAYH", "GRAYS", "YUV420P8", "YUV420P16",
                                 "RGB24", "RGBS"])
@pytest.mark.parametrize("thr", [(0.0, 0.0), (0.1, 0.1), (0.4, 0.0), (0.0, 0.4), (1.0, 1.0),
                                 (0.999, 0.001)], ids=str)
@pytest.mark.parametrize("args", [{}, {"planes": [0, 1, 2], "clipb": True}], ids=str)
def test_plane_minmax_matches(fmt, thr, args):
    ja, ta = clips(fmt, 28)
    args = dict(args)
    minthr, maxthr = thr
    f = ja.format
    if "planes" in args and (f.num_planes == 1 or (
            f.color_family.name == "YUV" and f.sample_type.name == "FLOAT" and thr != (0, 0))):
        args["planes"] = [0]
    jargs, targs = dict(args), dict(args)
    keys = ["psmMin", "psmMax"]
    if args.pop("clipb", False):
        jb, tb = clips(fmt, 29, n=N + 1)
        jargs["clipb"], targs["clipb"] = jb, tb
        keys.append("psmDiff")
    assert_clip_matches(vt.plane_minmax(ta, minthr, maxthr, **targs),
                        j_minmax(ja, minthr, maxthr, **jargs), keys)


@pytest.mark.parametrize("fmt", ["RGB24", "GRAY16", "GRAYS"])
@pytest.mark.parametrize("thr", [0.1, 0.25])
def test_plane_minmax_at_the_search_edges(fmt, thr):
    """Planes whose cumulative counts land exactly on trunc(total*thr): the
    lowest bin holds thr of the pixels (so the walk's '>' must pass it), the
    rest sit at the top bin, and one frame is constant."""
    f = vz.get_format(fmt)
    h, w = 10, 20
    total = h * w
    top = (1 << f.bits_per_sample) - 1 if f.sample_type.name == "INTEGER" else 1.0
    planes = []
    for p in range(f.num_planes):
        x = np.full((3, h, w), top, f.storage_dtype)
        k = int(np.trunc(total * np.float64(np.float32(thr))))
        x[0].reshape(-1)[:k] = 0
        x[1].reshape(-1)[: k + 1] = 0
        x[1].reshape(-1)[k + 1: 2 * k + 2] = top // 2 if f.sample_type.name == "INTEGER" else 0.5
        planes.append(x)
    ja, ta = both_clips(fmt, planes)
    for minthr, maxthr in ((thr, 0.0), (0.0, thr), (thr, thr)):
        args = {"planes": list(range(f.num_planes))}
        assert_clip_matches(vt.plane_minmax(ta, minthr, maxthr, **args),
                            j_minmax(ja, minthr, maxthr, **args), ["psmMin", "psmMax"])


def test_plane_minmax_errors_match():
    j32, t32 = clips("GRAY32", 30)
    jy, ty = clips("YUV420PS", 31)
    ja, ta = clips("GRAY8", 32)
    js, ts = clips("GRAY8", 33, n=N - 1)
    same_error(lambda: j_minmax(j32), lambda: vt.plane_minmax(t32))
    same_error(lambda: j_minmax(jy, 0.1, planes=[0, 1]),
               lambda: vt.plane_minmax(ty, 0.1, planes=[0, 1]))
    same_error(lambda: j_minmax(ja, 1.5), lambda: vt.plane_minmax(ta, 1.5))
    same_error(lambda: j_minmax(ja, 0.0, -0.1), lambda: vt.plane_minmax(ta, 0.0, -0.1))
    same_error(lambda: j_minmax(ja, clipb=js), lambda: vt.plane_minmax(ta, clipb=ts))
