"""vszip_tpu_torch.mosquito_nr held against vszip_tpu.mosquito_nr on seeded
clips (GRAY8, GRAY16, YUV420P10, GRAYS, YUV444PS; strength 0/8/16/32,
restore 0/64/96/128, radius 1/2, per-plane arrays and ``planes``; ragged and
minimal sizes), against the literal integer oracle tests/oracle/mosquito_ref.py,
and every validation message.

Tolerance: integer planes bit-exact.  Float planes bit-exact against the
package's strict evaluation under ``jax.disable_jit()`` and within rtol 2e-6
of the jitted package: XLA:CPU contracts the restore mix ``wo * ll_o + (1 -
wo) * ll_b`` into ``fma(wo, ll_o, (1 - wo) * ll_b)`` (in 15% of 2^20 random
cases at restore 96; at restore 64 the products are exact and nothing
moves), which the port, like the reference, rounds term by term.
"""

import jax
import numpy as np
import pytest

import vszip_tpu as vz
import vszip_tpu_torch as vt
from oracle.mosquito_ref import mosquito_plane_ref
from test_torch_core import assert_planes_match, both_clips, make_planes, same_error

INT_CASES = [(fmt, args) for fmt in ("GRAY8", "GRAY16", "YUV420P10") for args in (
    {}, {"strength": 8, "restore": 64}, {"strength": 32, "restore": 0, "radius": 1},
    {"strength": 0})] + [
    ("YUV420P10", {"restore": 128, "radius": 1, "planes": [0, 1, 2]}),
    ("YUV420P10", {"strength": [16, 8, 32], "restore": [128, 64, 0], "radius": [2, 1, 2],
                   "planes": [0, 1, 2]}),
    ("YUV420P10", {"strength": 24, "restore": 96, "planes": [1, 2]}),
]
SHAPES = ((2, 37, 53), (2, 40, 56), (1, 8, 10))


@pytest.mark.parametrize("fmt,args", INT_CASES, ids=str)
def test_integer_formats_match_jax(fmt, args):
    i = INT_CASES.index((fmt, args))
    n, h, w = SHAPES[i % 3]
    planes = make_planes(fmt, np.random.default_rng(i), n, h, w)
    cj, ct = both_clips(fmt, planes)
    got = vt.mosquito_nr(ct, **args)
    assert got.format == ct.format and all(p.device.type == "cpu" for p in got.planes)
    assert_planes_match(got.planes, vz.mosquito_nr(cj, **args).planes)
    if args.get("strength", 16) and "planes" not in args:
        assert not np.array_equal(got.planes[0].numpy(), planes[0])
        # chroma passes through by default
        for g, p in zip(got.planes[1:], planes[1:]):
            np.testing.assert_array_equal(g.numpy(), p)


@pytest.mark.parametrize("strength,restore,radius", [(16, 128, 2), (8, 64, 1), (32, 0, 2),
                                                     (16, 50, 1), (24, 96, 2)], ids=str)
@pytest.mark.parametrize("fmt", ["GRAY8", "GRAY16"])
def test_matches_literal_oracle(fmt, strength, restore, radius):
    planes = make_planes(fmt, np.random.default_rng(strength + restore), 1, 28, 36)
    _, ct = both_clips(fmt, planes)
    got = vt.mosquito_nr(ct, strength=strength, restore=restore, radius=radius)
    bits = ct.format.bits_per_sample
    want = mosquito_plane_ref(planes[0][0], strength, restore, radius, bits)
    np.testing.assert_array_equal(got.planes[0][0].numpy(), want)


FLOAT_CASES = [("GRAYS", {}), ("GRAYS", {"restore": 64, "radius": 1}),
               ("GRAYS", {"strength": 32, "restore": 0}),
               ("YUV444PS", {"planes": [0, 1, 2], "restore": 96, "radius": 1}),
               ("YUV444PS", {"strength": [8, 24], "restore": [128, 40], "planes": [0, 2]})]


@pytest.mark.parametrize("fmt,args", FLOAT_CASES, ids=str)
def test_float_formats_match_jax(fmt, args):
    planes = make_planes(fmt, np.random.default_rng(FLOAT_CASES.index((fmt, args))), 2, 37, 53)
    cj, ct = both_clips(fmt, planes)
    got = vt.mosquito_nr(ct, **args).planes
    assert_planes_match(got, vz.mosquito_nr(cj, **args).planes)
    with jax.disable_jit():
        strict = vz.mosquito_nr(cj, **args).planes
    for g, s in zip(got, strict):
        np.testing.assert_array_equal(g.numpy(), np.asarray(s))
    # float chroma is clamped to +-0.5
    if fmt == "YUV444PS":
        assert float(got[2].max()) <= 0.5 and float(got[2].min()) >= -0.5


@pytest.mark.parametrize("fmt,h,w,args", [
    ("GRAY32", 16, 16, {}),
    ("GRAYH", 16, 16, {}),
    ("RGB24", 16, 16, {}),
    ("GRAY8", 3, 16, {}),
    ("YUV420P8", 6, 16, {"planes": [0, 1]}),
    ("GRAY8", 16, 16, {"strength": 33}),
    ("GRAY8", 16, 16, {"restore": -1}),
    ("GRAY8", 16, 16, {"radius": 3}),
    ("GRAY8", 16, 16, {"planes": [1]}),
    ("YUV420P8", 16, 16, {"planes": [2, 2]}),
], ids=str)
def test_errors_match_jax(fmt, h, w, args):
    cj, ct = both_clips(fmt, make_planes(fmt, np.random.default_rng(0), 1, h, w))
    msg = same_error(lambda: vz.mosquito_nr(cj, **args), lambda: vt.mosquito_nr(ct, **args))
    assert msg.startswith("MosquitoNR: ")


def test_small_luma_only_clip_with_tiny_chroma():
    """Unprocessed chroma planes below 4x4 are not checked (luma only)."""
    planes = make_planes("YUV420P8", np.random.default_rng(3), 1, 6, 16)
    cj, ct = both_clips("YUV420P8", planes)
    assert_planes_match(vt.mosquito_nr(ct).planes, vz.mosquito_nr(cj).planes)
