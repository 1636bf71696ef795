"""vszip_tpu_torch.limiter held against vszip_tpu.limiter: the three modes,
mask, plane selection, and every validation message.

Tolerance: none; a clamp moves no value it keeps, so every plane, float ones
included, must match exactly.
"""

import numpy as np
import pytest

import vszip_tpu as vz
import vszip_tpu_torch as vt
from test_torch_core import both_clips, make_planes, same_error

FORMATS = ("GRAY8", "YUV420P10", "YUV420P16", "GRAY32", "GRAYH", "GRAYS", "RGBS",
           "YUV444PH")

MODES = (
    {},
    {"tv_range": True},
    {"tv_range": True, "mask": True},
    {"tv_range": True, "planes": [0]},
    "explicit",
)


def _explicit(fmt):
    f = vz.get_format(fmt)
    n = f.num_planes
    if f.sample_type.name == "FLOAT":
        return {"min": [0.1, -0.2, 0.3][:n], "max": [0.7, 0.31, 0.3][:n]}
    peak = (1 << f.bits_per_sample) - 1
    return {"min": [1, peak // 5, 0][:n], "max": [peak - 7, peak // 2, peak][:n]}


@pytest.mark.parametrize("mode", MODES, ids=str)
@pytest.mark.parametrize("fmt", FORMATS)
def test_limiter_matches_jax(fmt, mode):
    rng = np.random.default_rng([FORMATS.index(fmt), MODES.index(mode)])
    planes = make_planes(fmt, rng, 2, 24, 40)
    if vz.get_format(fmt).sample_type.name == "FLOAT":
        planes = [((p.astype(np.float32) * 2) - 0.6).astype(p.dtype) for p in planes]
    cj, ct = both_clips(fmt, planes)
    kwargs = _explicit(fmt) if mode == "explicit" else mode
    got = vt.limiter(ct, **kwargs)
    want = vz.limiter(cj, **kwargs)
    for g, w in zip(got.planes, want.planes):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == ct.format.torch_dtype


def test_limiter_scalar_bounds_on_gray():
    rng = np.random.default_rng(9)
    cj, ct = both_clips("GRAY16", make_planes("GRAY16", rng, 2, 16, 16))
    np.testing.assert_array_equal(vt.limiter(ct, min=300, max=60000).planes[0].numpy(),
                                  np.asarray(vz.limiter(cj, min=300, max=60000).planes[0]))


@pytest.mark.parametrize("fmt,kwargs", [
    ("GRAY8", {"min": 1}),
    ("GRAY8", {"max": 1}),
    ("YUV420P8", {"min": [1, 2], "max": [3, 4, 5]}),
    ("YUV420P8", {"min": [1, 2, 3], "max": [3, 4]}),
    ("GRAY8", {"min": 5, "max": 4}),
    ("GRAY8", {"min": 0, "max": 256}),
    ("GRAY8", {"min": -1, "max": 4}),
    ("GRAYS", {"min": 0.5, "max": 0.25}),
    ("GRAY8", {"planes": [2]}),
], ids=str)
def test_limiter_errors_match(fmt, kwargs):
    rng = np.random.default_rng(1)
    cj, ct = both_clips(fmt, make_planes(fmt, rng, 1, 8, 8))
    msg = same_error(lambda: vz.limiter(cj, **kwargs), lambda: vt.limiter(ct, **kwargs),
                     ValueError)
    assert msg.startswith("Limiter: ")
