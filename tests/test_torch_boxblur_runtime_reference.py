"""The port's BoxBlur runtime integer path, the one the upstream's 5-pass
benchmark takes, against the benchmark's plain reference of it
(``portbench/reference/boxblur_rt.py``, written from the plugin's formulas
and not from the port's plain versions), on the CPU: bit for bit on seeded
uint8 and uint16 planes; the reference's control differs; the reference
rounds between passes and refuses the calls it does not cover.  Imports no
JAX."""

import numpy as np
import pytest
import torch

import vszip_tpu_torch as vt
from portbench.reference import boxblur_rt

FORMATS = {torch.uint8: ("GRAY8", 8), torch.uint16: ("GRAY16", 16)}
# (frames, height, width) and the call: r 13 on a picture just over 2r in
# each axis; r 1; hpasses != vpasses; hradius != vradius
CASES = {
    "r13_just_over_2r": ((2, 27, 29), {"hradius": 13, "hpasses": 5, "vradius": 13,
                                        "vpasses": 5}),
    "r1": ((3, 6, 9), {"hradius": 1, "hpasses": 5, "vradius": 1, "vpasses": 5}),
    "hpasses_ne_vpasses": ((2, 20, 24), {"hradius": 4, "hpasses": 5, "vradius": 4,
                                          "vpasses": 2}),
    "hradius_ne_vradius": ((2, 24, 40), {"hradius": 9, "hpasses": 5, "vradius": 4,
                                          "vpasses": 5}),
}


def _planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    top = int(torch.iinfo(dtype).max) + 1
    return torch.from_numpy(rng.integers(0, top, shape).astype(
        np.uint8 if dtype == torch.uint8 else np.uint16))


def _cfg(args, dtype, shape):
    name, bits = FORMATS[dtype]
    return {"args": args, "format": name, "bits": bits, "planes": [list(shape[1:])]}


def _port(x, args):
    fmt = vt.get_format(FORMATS[x.dtype][0])
    return vt.boxblur(vt.Clip.from_planes((x,), fmt, device="cpu"), **args).planes[0]


@pytest.mark.parametrize("dtype", list(FORMATS), ids=str)
@pytest.mark.parametrize("case", list(CASES))
def test_the_port_equals_the_reference_bit_for_bit(case, dtype):
    shape, args = CASES[case]
    x = _planes(shape, dtype, seed=len(case) * 7 + dtype.itemsize)
    want, = boxblur_rt.run((x,), _cfg(args, dtype, shape))
    got = _port(x, args)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == x.shape
    assert torch.equal(got, want)
    assert not torch.equal(want, x)


@pytest.mark.parametrize("dtype", list(FORMATS), ids=str)
def test_the_control_differs_on_the_same_input(dtype):
    """On a horizontal ramp over the sample type's range: the plugin's
    running output truncates inv2, and the error grows with W(x) - W(0),
    which noise blurred flat keeps near 0 at 8 bits."""
    _, args = CASES["r13_just_over_2r"]
    shape = (2, 27, 120)
    top = int(torch.iinfo(dtype).max)
    x = (torch.arange(shape[2]) * top // (shape[2] - 1)).to(dtype).expand(shape).contiguous()
    cfg = _cfg(args, dtype, shape)
    exact, = boxblur_rt.run((x,), cfg)
    low, = boxblur_rt.run((x,), cfg, control=True)
    d = (exact.to(torch.int32) - low.to(torch.int32)).abs()
    assert low.dtype == dtype and int(torch.count_nonzero(d)) > 0


def test_the_reference_rounds_between_passes():
    """A row 0 0 0 2 0 0 0, two passes of r 1 in each axis: rounded after each
    pass the first gives 0 0 1 1 1 0 0 (2/3 rounds up) and the second keeps
    it; the two passes' exact mean rounded once gives 0 0 0 1 0 0 0.  Columns
    are constant, so the vertical passes keep every value."""
    x = torch.tensor([0, 0, 0, 2, 0, 0, 0], dtype=torch.uint8).repeat(1, 3, 1)
    args = {"hradius": 1, "hpasses": 2, "vradius": 1, "vpasses": 2}
    per_pass = torch.tensor([0, 0, 1, 1, 1, 0, 0], dtype=torch.uint8).repeat(1, 3, 1)
    kernel = torch.tensor([1.0, 2.0, 3.0, 2.0, 1.0], dtype=torch.float64) / 9
    # the row's ends are 0, so the mirror reads 0 past them
    row = torch.nn.functional.pad(x[0, :1].to(torch.float64), (2, 2))
    once = torch.floor(torch.nn.functional.conv1d(row[None], kernel.view(1, 1, 5))[0, 0] + 0.5)
    assert once.tolist() == [0, 0, 0, 1, 0, 0, 0]
    got, = boxblur_rt.run((x,), _cfg(args, torch.uint8, x.shape))
    assert torch.equal(got, per_pass)
    assert torch.equal(_port(x, args), per_pass)


@pytest.mark.parametrize("change,match", [
    ({"format": "GRAYS", "bits": 32}, "integer formats"),
    ({"format": "YUV420PH", "bits": 16}, "integer formats"),
    ({"args": {"hradius": 13, "hpasses": 5, "vradius": 13, "vpasses": 5, "planes": [0]}},
     "every plane"),
    ({"args": {"hradius": 13, "vradius": 13}}, "comptime path"),
    ({"args": {"hradius": 0, "hpasses": 5, "vradius": 13, "vpasses": 0}}, "axis to blur"),
    ({"planes_dtype": torch.float32}, "uint8/uint16"),
    ({"args": {"hradius": 15, "hpasses": 5, "vradius": 13, "vpasses": 5}}, "does not fit"),
], ids=["float32", "float16", "planes", "comptime", "nothing", "float_planes", "too_wide"])
def test_the_reference_refuses_the_calls_it_does_not_cover(change, match):
    shape, args = CASES["r13_just_over_2r"]
    change = dict(change)
    x = _planes(shape, torch.uint16, seed=1).to(change.pop("planes_dtype", torch.uint16))
    cfg = {**_cfg(args, torch.uint16, shape), **change}
    with pytest.raises(ValueError, match=match):
        boxblur_rt.run((x,), cfg)
