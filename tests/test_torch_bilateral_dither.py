"""vszip_tpu_torch.bilateral_dither held against vszip_tpu.bilateral_dither
on seeded clips: GRAY8, GRAY16, YUV420P8, YUV420P16, YUV444P16, RGB24 and
GRAYS; the dense path (subspl 1 and 2) and the sub-sampled one (0 and 8) at
r = 2, 4, 6 and 8 and the default r = 16; flat 0 and 1, thr 2.5 and 24,
wmin 0.5, a joint ref, per-plane arrays and ``planes``; and every
validation message.  On the CPU the op runs the plain versions of B17 and
B18, so these cases also check their function.

Tolerance: integer planes bit-exact against the jitted package on the
smooth pictures.  GRAYS within rtol 2e-6 of the jitted package, and
bit-exact against its strict evaluation under ``jax.disable_jit()``:
XLA:CPU's jit moves a few float outputs by 1 ulp, and on full-range noise
a few integer outputs by 1 LSB (ROADMAP §C), so that case is held bit-exact
against the strict evaluation and within 1 LSB of the jitted one.  r stays
<= 8 in the dense cases: the JAX dense path unrolls (2r-1)^2 taps under
jit.
"""

import jax
import numpy as np
import pytest

import vszip_tpu as vz
import vszip_tpu_torch as vt
from test_torch_core import assert_planes_match, both_clips, make_planes, same_error


def smooth_planes(fmt_name, seed, n=2, h=56, w=96):
    """A smooth gradient quantised into 8-bit steps plus noise of one step on
    every plane, so that most taps get a weight between 0 and wmax (on
    full-range noise nearly every weight is 0)."""
    fmt = vz.get_format(fmt_name)
    rng = np.random.default_rng(seed)
    planes = []
    for p in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, p)
        y, x = np.mgrid[:ph, :pw]
        base = 0.3 + 0.4 * np.sin(x / (7.0 + p) + y / 11.0) ** 2
        if fmt.sample_type.name == "FLOAT":
            v = np.floor(base * 256) / 256 + rng.uniform(-1 / 256, 1 / 256, (n, ph, pw))
            planes.append(v.astype(np.float32))
        else:
            peak = (1 << fmt.bits_per_sample) - 1
            step = 1 << (fmt.bits_per_sample - 8)
            v = (base * peak) // step * step + rng.integers(-step, step + 1, (n, ph, pw))
            planes.append(np.clip(v, 0, peak).astype(fmt.storage_dtype))
    return planes


CASES = [
    ("GRAY8", {"radius": 2, "subspl": 1.0}),
    ("GRAY8", {"radius": 2, "subspl": 0.0}),
    ("GRAY8", {"radius": 6, "thr": 24.0, "wmin": 0.5, "subspl": 2.0}),
    ("GRAY16", {"radius": 4, "flat": 0.0, "subspl": 2.0}),
    ("GRAY16", {"radius": 8, "thr": 8.0, "subspl": 2.0}),
    ("GRAY16", {"radius": 6, "subspl": 8.0, "wmin": 0.5}),
    ("GRAY16", {"radius": 2, "thr": 2.5, "flat": 1.0, "subspl": 1.0}),
    ("YUV420P8", {}),
    ("YUV420P8", {"radius": 6, "thr": 24.0, "subspl": 2.0}),
    ("YUV420P16", {"radius": 4}),
    ("YUV420P16", {"radius": 8, "thr": 8.0, "subspl": 0.0}),
    ("YUV420P16", {"radius": 8, "thr": 12.0, "subspl": 2.0, "planes": [0]}),
    ("YUV444P16", {"radius": [8, 4, 6], "thr": [8.0, 16.0, 4.0], "flat": [0.0, 0.4, 1.0],
                   "subspl": 2.0}),
    ("YUV444P16", {"radius": [4, 6], "subspl": [8.0, 2.0], "planes": [1, 2]}),
    ("RGB24", {"radius": 4, "thr": 2.5, "flat": 1.0, "subspl": 8.0}),
    ("GRAYS", {"radius": 4, "subspl": 2.0}),
    ("GRAYS", {"radius": 6, "thr": 16.0}),
    ("GRAYS", {"radius": 4, "thr": 24.0, "flat": 0.0, "wmin": 0.5, "subspl": 8.0}),
]


@pytest.mark.parametrize("fmt,args", CASES, ids=str)
def test_bilateral_dither_matches_jax(fmt, args):
    planes = smooth_planes(fmt, CASES.index((fmt, args)))
    cj, ct = both_clips(fmt, planes)
    got = vt.bilateral_dither(ct, **args)
    assert got.format == ct.format and all(p.device.type == "cpu" for p in got.planes)
    assert_planes_match(got.planes, vz.bilateral_dither(cj, **args).planes)
    # the filter changed a share of luma (or of the first processed plane)
    p = args.get("planes", [0])[0]
    assert (got.planes[p].numpy() != planes[p]).mean() > 0.01


@pytest.mark.parametrize("fmt,args", [("GRAY16", {"radius": 4, "subspl": 2.0}),
                                      ("YUV420P16", {"radius": 6, "thr": 12.0}),
                                      ("GRAYS", {"radius": 3, "subspl": 1.0}),
                                      ("GRAYS", {"radius": 4, "subspl": 8.0})], ids=str)
def test_joint_ref_matches_jax(fmt, args):
    planes = smooth_planes(fmt, 30)
    rplanes = smooth_planes(fmt, 31)
    cj, ct = both_clips(fmt, planes)
    rj, rt = both_clips(fmt, rplanes)
    got = vt.bilateral_dither(ct, ref=rt, **args)
    assert_planes_match(got.planes, vz.bilateral_dither(cj, ref=rj, **args).planes)
    assert not np.array_equal(got.planes[0].numpy(), vt.bilateral_dither(ct, **args).planes[0])


@pytest.mark.parametrize("args,with_ref", [({"radius": 4, "subspl": 2.0}, False),
                                           ({"radius": 4}, False),
                                           ({"radius": 3, "thr": 16.0, "subspl": 1.0}, True)],
                         ids=str)
def test_grays_bit_exact_against_strict_jax(args, with_ref):
    planes = smooth_planes("GRAYS", 40, n=1, h=32, w=40)
    cj, ct = both_clips("GRAYS", planes)
    rj, rt = both_clips("GRAYS", smooth_planes("GRAYS", 41, n=1, h=32, w=40)) if with_ref \
        else (None, None)
    got = vt.bilateral_dither(ct, ref=rt, **args).planes[0].numpy()
    with jax.disable_jit():
        want = np.asarray(vz.bilateral_dither(cj, ref=rj, **args).planes[0])
    np.testing.assert_array_equal(got, want)


def test_noise_plane_and_flat_plane():
    """Full-range noise at a high thr: the port equals the package's strict
    evaluation bit for bit.  The jitted package differs from that by 1 LSB
    in 3 of these 1,920 pixels (ROADMAP §C), so it is held within 1 LSB."""
    planes = make_planes("GRAY16", np.random.default_rng(5), 2, 24, 40)
    cj, ct = both_clips("GRAY16", planes)
    got = vt.bilateral_dither(ct, radius=4, thr=200.0).planes[0].numpy().astype(np.int64)
    jitted = np.asarray(vz.bilateral_dither(cj, radius=4, thr=200.0).planes[0])
    with jax.disable_jit():
        strict = np.asarray(vz.bilateral_dither(cj, radius=4, thr=200.0).planes[0])
    np.testing.assert_array_equal(got, strict)
    assert np.abs(got - jitted).max() <= 1
    flat = vt.Clip.blank(vt.get_format("GRAY16"), 32, 32, value=30000, device="cpu")
    assert (vt.bilateral_dither(flat, radius=4).planes[0] == 30000).all()


def _clip_pair(fmt, n=1, h=24, w=32, seed=0):
    return both_clips(fmt, make_planes(fmt, np.random.default_rng(seed), n, h, w))


@pytest.mark.parametrize("fmt,h,w,args,ref", [
    ("GRAY32", 24, 32, {}, None),
    ("GRAYH", 24, 32, {}, None),
    ("GRAY8", 15, 32, {}, None),
    ("GRAY8", 24, 15, {}, None),
    ("GRAY8", 20, 20, {"radius": 30}, None),
    ("YUV420P8", 24, 64, {"radius": 16}, None),
    ("GRAY8", 24, 32, {"radius": 1}, None),
    ("GRAY8", 24, 32, {"radius": 16385}, None),
    ("GRAY8", 24, 32, {"thr": -1.0}, None),
    ("GRAY8", 24, 32, {"flat": 1.5}, None),
    ("GRAY8", 24, 32, {"wmin": 70000.0}, None),
    ("GRAY8", 24, 32, {"subspl": 5000.0}, None),
    ("GRAY8", 24, 32, {"radius": [4, 4, 4, 4]}, None),
    ("GRAY8", 24, 32, {"planes": [1]}, None),
    ("YUV420P8", 24, 32, {"planes": [0, 0]}, None),
    ("GRAY16", 24, 32, {}, ("GRAY8", 1, 24, 32)),
    ("GRAY16", 24, 32, {}, ("GRAY16", 2, 24, 32)),
    ("GRAY16", 24, 32, {}, ("GRAY16", 1, 24, 40)),
], ids=str)
def test_errors_match_jax(fmt, h, w, args, ref):
    cj, ct = _clip_pair(fmt, 1, h, w)
    rj, rt = _clip_pair(*ref) if ref is not None else (None, None)
    msg = same_error(lambda: vz.bilateral_dither(cj, ref=rj, **args),
                     lambda: vt.bilateral_dither(ct, ref=rt, **args))
    assert msg.startswith("BilateralDither: ")
