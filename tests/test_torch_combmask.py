"""vszip_tpu_torch.comb_mask and comb_mask_mt held against vszip_tpu's on
seeded clips (GRAY8, YUV420P8, YUV444P8; ragged sizes, height 3, widths
1-3; 1, 2 and 5 frames; metric 0/1 x mthresh 0/9 x expand on/off;
CombMaskMT with thY1 = thY2 and thY1 < thY2), B16's plain version against
the Pallas kernel in interpret mode and the literal per-pixel oracles, and
every validation message.  On the CPU CombMask runs B16's plain version, so
the op-level cases also check B16's function.

Tolerance: bit-exact everywhere (uint8 masks).
"""

import numpy as np
import pytest
import torch

import vszip_tpu as vz
import vszip_tpu_torch as vt
from oracle.pointwise_ref import comb_mask_mt_ref, comb_mask_ref
from test_torch_core import assert_planes_match, both_clips, make_planes, same_error
from vszip_tpu_torch import trace
from vszip_tpu_torch.kernels import comb_mask as km

CASES = [(metric, mthresh, expand) for metric in (False, True) for mthresh in (0, 9)
         for expand in (True, False)]
SHAPES = (("GRAY8", 2, 37, 53), ("YUV420P8", 5, 22, 30), ("YUV444P8", 1, 13, 17))


def _combed(fmt, rng, n, h, w):
    """Seeded low-noise planes with a band of rows whose odd lines are offset
    and which brightens from frame to frame, so both mask values occur with
    and without the motion mask."""
    planes = make_planes(fmt, rng, n, h, w)
    for p in planes:
        p[:] = p // 64 + 100
        band = p[:, p.shape[1] // 3: 2 * p.shape[1] // 3]
        band[:, 1::2] += 60
        band += (20 * np.arange(n, dtype=np.uint8))[:, None, None]
    return planes


@pytest.mark.parametrize("metric,mthresh,expand", CASES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_comb_mask_matches_jax(shape, metric, mthresh, expand):
    fmt, n, h, w = shape
    rng = np.random.default_rng(CASES.index((metric, mthresh, expand)))
    cj, ct = both_clips(fmt, _combed(fmt, rng, n, h, w))
    args = {"cthresh": 100 if metric else 6, "mthresh": mthresh, "expand": expand,
            "metric": metric}
    got = vt.comb_mask(ct, **args)
    assert got.format == ct.format and all(p.device.type == "cpu" for p in got.planes)
    assert_planes_match(got.planes, vz.comb_mask(cj, **args).planes)
    if fmt == "GRAY8":
        assert 0 < int((got.planes[0] == 255).sum()) < got.planes[0].numel()


@pytest.mark.parametrize("fmt,n,h,w", [("GRAY8", 2, 3, 1), ("GRAY8", 2, 3, 2), ("GRAY8", 1, 3, 3),
                                       ("GRAY8", 5, 4, 2), ("YUV420P8", 2, 6, 2),
                                       ("YUV444P8", 1, 3, 5)], ids=str)
def test_minimal_sizes_match_jax(fmt, n, h, w):
    cj, ct = both_clips(fmt, make_planes(fmt, np.random.default_rng(h * w + n), n, h, w))
    for args in ({"cthresh": 0}, {"cthresh": 0, "mthresh": 0}, {"metric": True, "cthresh": 10},
                 {"cthresh": 3, "mthresh": 30, "expand": False}):
        assert_planes_match(vt.comb_mask(ct, **args).planes, vz.comb_mask(cj, **args).planes)


@pytest.mark.parametrize("fmt,thy", [("GRAY8", (30, 30)), ("YUV420P8", (10, 200)),
                                     ("YUV444P8", (0, 255)), ("GRAY8", (0, 0))], ids=str)
def test_comb_mask_mt_matches_jax(fmt, thy):
    cj, ct = both_clips(fmt, make_planes(fmt, np.random.default_rng(sum(thy)), 2, 21, 33))
    args = {"thY1": thy[0], "thY2": thy[1]}
    got = vt.comb_mask_mt(ct, **args)
    assert_planes_match(got.planes, vz.comb_mask_mt(cj, **args).planes)
    if thy[0] < thy[1]:  # the ramp between the thresholds is used
        v = got.planes[0]
        assert bool(((v > 0) & (v < 255)).any())


@pytest.mark.parametrize("args", [dict(cthresh=6, mthresh=9, expand=True, metric=False),
                                  dict(cthresh=6, mthresh=0, expand=True, metric=False),
                                  dict(cthresh=500, mthresh=9, expand=True, metric=True),
                                  dict(cthresh=10, mthresh=5, expand=False, metric=False)],
                         ids=str)
def test_comb_mask_matches_oracle(args):
    rng = np.random.default_rng(args["cthresh"])
    frames = np.stack(_combed("GRAY8", rng, 3, 12, 19)[0])
    got = km.comb_mask(torch.from_numpy(frames), args["cthresh"], args["mthresh"],
                       args["metric"], args["expand"]).numpy()
    for f in range(3):
        want = comb_mask_ref(frames[f], frames[max(f - 1, 0)], args["cthresh"],
                             args["mthresh"], args["expand"], args["metric"])
        np.testing.assert_array_equal(got[f], want, err_msg=f"frame {f}")


def test_comb_mask_mt_matches_oracle():
    img = make_planes("GRAY8", np.random.default_rng(2), 1, 15, 21)[0]
    ct = vt.Clip.from_planes([img], vt.get_format("GRAY8"), device="cpu")
    for thy in ((30, 30), (10, 90)):
        got = vt.comb_mask_mt(ct, *thy).planes[0][0].numpy()
        np.testing.assert_array_equal(got, comb_mask_mt_ref(img[0], *thy))


def test_plain_matches_pallas_interpret(monkeypatch):
    import jax.numpy as jnp

    from vszip_tpu.kernels import comb_mask_pallas as kp

    orig = kp.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(kp.pl, "pallas_call", interp_call)
    x = np.random.default_rng(3).integers(0, 256, (3, 70, 130), dtype=np.uint8)
    for metric, mthresh, expand in [(False, 9, True), (True, 9, True), (False, 0, True),
                                    (False, 9, False)]:
        cth6 = 0 if metric else 6 * 6
        want = np.asarray(kp.comb_mask_pallas(jnp.asarray(x), 6, cth6, mthresh, metric, expand))
        got = km.comb_mask(torch.from_numpy(x), 6, mthresh, metric, expand).numpy()
        np.testing.assert_array_equal(got, want)


def test_wrapper_dispatch():
    trace.reset_launches()
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 7, 9), dtype=np.uint8))
    assert km.comb_mask(x, 6, 9, False, True).shape == x.shape
    assert km.LAUNCHES == {"comb_mask": 0}
    with pytest.raises(ValueError, match="no CombMask kernel"):
        km.comb_mask(x.to("meta"), 6, 9, False, True)


def test_errors():
    rng = np.random.default_rng(0)
    cj, ct = both_clips("GRAY8", make_planes("GRAY8", rng, 2, 16, 16))
    msgs = []
    for f, h in (("GRAY16", 16), ("GRAYS", 16), ("GRAY8", 2), ("YUV420P8", 4)):
        bj, bt = both_clips(f, make_planes(f, rng, 1, h, 16))
        msgs.append(same_error(lambda: vz.comb_mask(bj), lambda: vt.comb_mask(bt)))
        msgs.append(same_error(lambda: vz.comb_mask_mt(bj), lambda: vt.comb_mask_mt(bt)))
    for args in ({"cthresh": 256}, {"cthresh": -1}, {"cthresh": 65026, "metric": True},
                 {"mthresh": 256}, {"mthresh": -1}):
        msgs.append(same_error(lambda: vz.comb_mask(cj, **args), lambda: vt.comb_mask(ct, **args)))
    for args in ({"thY1": 256}, {"thY1": -1}, {"thY2": 256, "thY1": 0}, {"thY2": -1},
                 {"thY1": 40, "thY2": 30}):
        msgs.append(same_error(lambda: vz.comb_mask_mt(cj, **args),
                               lambda: vt.comb_mask_mt(ct, **args)))
    assert all(m.startswith(("CombMask: ", "CombMaskMT: ")) for m in msgs)
    assert_planes_match(vt.comb_mask(ct, cthresh=65025, metric=True).planes,
                        vz.comb_mask(cj, cthresh=65025, metric=True).planes)
