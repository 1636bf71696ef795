"""vszip_tpu_torch.checkmate held against vszip_tpu.checkmate on seeded clips
(GRAY8, YUV420P8, YUV444P8, RGB24; ragged sizes and the minimal height 5;
1, 2 and 5 frames; tthr2 0 and 10; tmax 1, 12 and 255), B15's plain
version against the Pallas kernel in interpret mode and the literal
per-pixel oracle, and every validation message.  On the CPU the op runs
B15's plain version, so the op-level cases also check B15's function.

Tolerance: bit-exact everywhere (uint8 planes).
"""

import numpy as np
import pytest
import torch

import vszip_tpu as vz
import vszip_tpu_torch as vt
from oracle.pointwise_ref import checkmate_ref as oracle
from test_torch_core import assert_planes_match, both_clips, make_planes, same_error
from vszip_tpu_torch import trace
from vszip_tpu_torch.kernels import checkmate as kk

CASES = [(fmt, tthr2, tmax) for fmt in ("GRAY8", "YUV420P8", "YUV444P8")
         for tthr2 in (0, 10) for tmax in (1, 12, 255)]
SHAPES = ((2, 37, 53), (5, 21, 30), (2, 10, 6))


@pytest.mark.parametrize("fmt,tthr2,tmax", CASES, ids=str)
def test_checkmate_matches_jax(fmt, tthr2, tmax):
    i = CASES.index((fmt, tthr2, tmax))
    n, h, w = SHAPES[i % 3]
    cj, ct = both_clips(fmt, make_planes(fmt, np.random.default_rng(i), n, h, w))
    args = {"thr": 12 + i, "tmax": tmax, "tthr2": tthr2}
    got = vt.checkmate(ct, **args)
    assert got.format == ct.format and all(p.device.type == "cpu" for p in got.planes)
    assert_planes_match(got.planes, vz.checkmate(cj, **args).planes)


@pytest.mark.parametrize("fmt,n,h,w,args", [
    ("GRAY8", 1, 5, 3, {}), ("GRAY8", 2, 5, 3, {"tthr2": 255}),
    ("YUV420P8", 1, 10, 6, {"thr": 0}), ("RGB24", 2, 9, 11, {"tthr2": 4, "tmax": 3}),
    ("GRAY8", 5, 5, 40, {"tthr2": 30, "thr": 255}),
], ids=str)
def test_minimal_sizes_match_jax(fmt, n, h, w, args):
    cj, ct = both_clips(fmt, make_planes(fmt, np.random.default_rng(h * w), n, h, w))
    assert_planes_match(vt.checkmate(ct, **args).planes, vz.checkmate(cj, **args).planes)


@pytest.mark.parametrize("n,args", [(4, {"thr": 12, "tmax": 12, "tthr2": 0}),
                                    (4, {"thr": 12, "tmax": 12, "tthr2": 5}),
                                    (3, {"thr": 20, "tmax": 30, "tthr2": 0}),
                                    (1, {"thr": 12, "tmax": 12, "tthr2": 10})], ids=str)
def test_checkmate_matches_oracle(n, args):
    """The literal per-pixel oracle on smooth content with noise, where both
    branches are taken.  One frame with tthr2 > 0 is checked here only: the
    JAX package's frame shift builds two frames from one there and raises."""
    rng = np.random.default_rng(n)
    y, x = np.mgrid[:14, :17]
    base = 128 + 40 * np.sin(x / 3.0) * np.cos(y / 4.0)
    frames = np.stack([base + f + rng.integers(-3, 4, base.shape) for f in range(n)])
    frames = np.clip(frames, 0, 255).astype(np.uint8)
    got = kk.checkmate(torch.from_numpy(frames), **args).numpy()
    for f in range(n):
        np.testing.assert_array_equal(got[f], oracle(frames, f, **args), err_msg=f"frame {f}")
    if args["tthr2"] > 0 and n > 1:  # the temporal smooth changes some pixel
        assert (got[1] != oracle(frames, 1, args["thr"], args["tmax"], 0)).any()


def test_plain_matches_pallas_interpret(monkeypatch):
    import jax.numpy as jnp

    from vszip_tpu.kernels import checkmate_pallas as kp

    orig = kp.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(kp.pl, "pallas_call", interp_call)
    x = np.random.default_rng(3).integers(0, 256, (4, 70, 130), dtype=np.uint8)
    for thr, tmax, tthr2 in [(12, 12, 0), (12, 12, 5), (20, 30, 0)]:
        want = np.asarray(kp.checkmate_pallas(jnp.asarray(x), thr, tmax, tthr2, tthr2 > 0))
        got = kk.checkmate(torch.from_numpy(x), thr, tmax, tthr2).numpy()
        np.testing.assert_array_equal(got, want)


def test_wrapper_dispatch():
    trace.reset_launches()
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 7, 9), dtype=np.uint8))
    assert kk.checkmate(x, 12, 12, 0).shape == x.shape
    assert kk.LAUNCHES == {"checkmate": 0}
    with pytest.raises(ValueError, match="no Checkmate kernel"):
        kk.checkmate(x.to("meta"), 12, 12, 0)


def test_checkmate_errors():
    rng = np.random.default_rng(0)
    cj, ct = both_clips("GRAY8", make_planes("GRAY8", rng, 2, 16, 16))
    msgs = []
    for f, h, w in (("GRAY16", 16, 16), ("GRAYS", 16, 16), ("GRAY8", 4, 16),
                    ("GRAY8", 16, 2), ("YUV420P8", 8, 16)):
        bj, bt = both_clips(f, make_planes(f, rng, 1, h, w))
        msgs.append(same_error(lambda: vz.checkmate(bj), lambda: vt.checkmate(bt)))
    for args in ({"tmax": 0}, {"tmax": 256}, {"tthr2": -1}, {"thr": -1}, {"thr": 256}):
        msgs.append(same_error(lambda: vz.checkmate(cj, **args), lambda: vt.checkmate(ct, **args)))
    assert all(m.startswith("Checkmate: ") for m in msgs)
