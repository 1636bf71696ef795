"""The port's MosquitoNR against the benchmark's plain reference of it
(``portbench/reference/mosquito_nr.py``, written from the plugin's integer
formulas and not from the port's op), on the CPU: bit for bit on seeded
GRAY8, GRAY16 and YUV420P16 planes over the plugin's strengths, restores,
radii and plane selections, on noise, on flat areas and on pictures full of
exact SAD ties; the reference against the literal oracle
``tests/oracle/mosquito_ref.py``; the reference's control differs; it
refuses what it does not cover; its work count reads only the selected
planes.  Imports no JAX."""

import numpy as np
import pytest
import torch

import vszip_tpu_torch as vt
from oracle.mosquito_ref import mosquito_plane_ref
from portbench.reference import mosquito_nr as ref

FORMATS = {"GRAY8": 8, "GRAY16": 16, "YUV420P16": 16}
# (frames, height, width) of the luma: odd and even sides down to the 4x4
# minimum; YUV420's chroma planes, half of each side, need 8x8 luma
SHAPES = {"GRAY8": [(2, 13, 17), (1, 4, 4), (2, 8, 6), (1, 5, 9)],
          "GRAY16": [(2, 13, 17), (1, 4, 4), (2, 8, 6), (1, 5, 9)],
          "YUV420P16": [(2, 14, 18), (1, 8, 8), (2, 10, 12), (1, 12, 8)]}
PICTURES = ("noise", "flat", "ties")
CALLS = [(s, r, rad) for s in (0, 16, 32) for r in (0, 64, 128) for rad in (1, 2)]


def _picture(kind, shape, bits, rng):
    """Seeded samples of one plane: full-range noise; flat blocks with a
    noisy quarter, where many SADs are exactly 0; or two levels in a random
    pattern, where directions tie exactly."""
    top = (1 << bits) - 1
    if kind == "noise":
        x = rng.integers(0, top + 1, shape)
    elif kind == "flat":
        x = np.repeat(np.repeat(rng.integers(0, top + 1, (shape[0], 3, 3)), 3, 1), 3, 2)
        x = np.tile(x, (1, shape[1] // 9 + 1, shape[2] // 9 + 1))[:, :shape[1], :shape[2]]
        q = (shape[1] // 2, shape[2] // 2)
        x[:, :q[0], :q[1]] = rng.integers(0, top + 1, (shape[0],) + q)
    else:
        x = rng.integers(0, 2, shape) * (top // 2)
    return x.astype(np.uint8 if bits <= 8 else np.uint16)


def _planes(fmt, shape, kind, seed):
    rng = np.random.default_rng(seed)
    bits = FORMATS[fmt]
    n, h, w = shape
    shapes = [(h, w)] if fmt.startswith("GRAY") else [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    return tuple(torch.from_numpy(_picture(kind, (n,) + s, bits, rng)) for s in shapes)


def _cfg(fmt, planes, args):
    return {"format": fmt, "bits": FORMATS[fmt], "args": args,
            "planes": [list(p.shape[1:]) for p in planes]}


def _port(fmt, planes, args):
    clip = vt.Clip.from_planes(planes, vt.get_format(fmt), device="cpu")
    return vt.mosquito_nr(clip, **args).planes


@pytest.mark.parametrize("kind", PICTURES)
@pytest.mark.parametrize("every_plane", [False, True], ids=["planes_default", "planes_all"])
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("strength,restore,radius", CALLS,
                         ids=[f"s{s}_r{r}_rad{rad}" for s, r, rad in CALLS])
def test_the_port_equals_the_reference_bit_for_bit(strength, restore, radius, fmt, every_plane,
                                                   kind):
    i = CALLS.index((strength, restore, radius))
    shape = SHAPES[fmt][(i + PICTURES.index(kind)) % len(SHAPES[fmt])]
    planes = _planes(fmt, shape, kind, seed=i * 31 + PICTURES.index(kind))
    args = {"strength": strength, "restore": restore, "radius": radius}
    if every_plane:
        args["planes"] = list(range(len(planes)))
    want = ref.run(planes, _cfg(fmt, planes, args))
    got = _port(fmt, planes, args)
    for g, w, x, p in zip(got, want, planes, range(len(planes))):
        assert g.dtype == w.dtype == x.dtype and g.shape == w.shape == x.shape
        assert torch.equal(g, w)
        if p > 0 and not every_plane or strength == 0:
            assert torch.equal(w, x)


@pytest.mark.parametrize("kind", PICTURES)
@pytest.mark.parametrize("strength,restore,radius", [(16, 128, 2), (8, 64, 1), (32, 0, 2),
                                                     (16, 50, 1), (24, 96, 2)], ids=str)
@pytest.mark.parametrize("fmt", ["GRAY8", "GRAY16"])
def test_the_reference_equals_the_literal_oracle(fmt, strength, restore, radius, kind):
    planes = _planes(fmt, (2, 11, 14), kind, seed=strength + restore + radius)
    args = {"strength": strength, "restore": restore, "radius": radius}
    got, = ref.run(planes, _cfg(fmt, planes, args))
    x = planes[0].numpy()
    want = np.stack([mosquito_plane_ref(f, strength, restore, radius, FORMATS[fmt]) for f in x])
    np.testing.assert_array_equal(got.numpy(), want)


def test_ties_keep_the_lower_index_and_a_zero_sad_copies_the_centre():
    """Radius 1, restore 0: a centre of 1000 on a row of 1000, rows of 4000
    above and 200 below.  Along its row direction 0's SAD is exactly 0, so
    the centre is copied.  With 1500 to its right, 750 above and 1250 below,
    directions 0 and 2 both read 500 (in sixteenths, 8000) and every other
    direction more: the lower index's blend is taken, (32 c + 16 (1000 +
    1500) 16 + 32) >> 6 = 18000, put out as 1125; direction 2's would give
    1000."""
    pic = np.full((1, 5, 5), 1000, np.uint16)
    pic[:, :2], pic[:, 3:] = 4000, 200
    cfg = _cfg("GRAY16", (torch.from_numpy(pic),), {"strength": 16, "restore": 0, "radius": 1})
    got, = ref.run((torch.from_numpy(pic),), cfg)
    assert int(got[0, 2, 2]) == 1000
    pic[0, 2, 3], pic[0, 1, 2], pic[0, 3, 2] = 1500, 750, 1250
    got, = ref.run((torch.from_numpy(pic),), cfg)
    assert int(got[0, 2, 2]) == 1125
    np.testing.assert_array_equal(got[0].numpy(), mosquito_plane_ref(pic[0], 16, 0, 1, 16))


@pytest.mark.parametrize("fmt", ["GRAY8", "YUV420P16"])
def test_the_control_differs_on_the_same_input(fmt):
    planes = _planes(fmt, (2, 32, 48), "noise", seed=3)
    cfg = _cfg(fmt, planes, {})
    exact = ref.run(planes, cfg)
    low = ref.run(planes, cfg, control=True)
    d = (exact[0].to(torch.int32) - low[0].to(torch.int32)).abs()
    assert low[0].dtype == planes[0].dtype and int(torch.count_nonzero(d)) > 0
    for a, b in zip(exact[1:], low[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("change,match", [
    ({"format": "GRAYS", "bits": 32}, "integer formats"),
    ({"format": "YUV420PH", "bits": 16}, "integer formats"),
    ({"format": "RGB48", "bits": 16}, "GRAY and YUV"),
    ({"args": {"strength": 33}}, "strength 33 is outside"),
    ({"args": {"strength": -1}}, "strength -1 is outside"),
    ({"args": {"restore": 129}}, "restore 129 is outside"),
    ({"args": {"radius": 3}}, "radius 3 is outside"),
    ({"args": {"radius": 0}}, "radius 0 is outside"),
    ({"args": {"strength": [16, 8]}}, "one integer strength"),
    ({"args": {"planes": [0, 3]}}, "do not name distinct planes"),
    ({"args": {"planes": [0, 0]}}, "do not name distinct planes"),
    ({"shape": (1, 3, 8)}, "at least 4x4"),
    ({"dtype": torch.float32}, "uint8/uint16"),
], ids=["float32", "float16", "rgb", "strength_high", "strength_low", "restore", "radius_high",
        "radius_low", "per_plane", "plane_index", "plane_twice", "too_small", "float_planes"])
def test_the_reference_refuses_what_it_does_not_cover(change, match):
    change = dict(change)
    x = torch.from_numpy(_picture("noise", change.pop("shape", (1, 8, 8)), 16,
                                  np.random.default_rng(0)))
    x = x.to(change.pop("dtype", torch.uint16))
    planes = (x, x, x)
    cfg = {"format": "YUV444P16", "bits": 16, "args": {}, "planes": [[8, 8]] * 3, **change}
    with pytest.raises(ValueError, match=match):
        ref.run(planes, cfg)


def test_work_counts_only_the_selected_planes():
    cfg = {"format": "YUV420P16", "bits": 16, "planes": [[1080, 1920], [540, 960], [540, 960]],
           "args": {"strength": 16, "restore": 128, "radius": 2, "planes": [0]}}
    nbytes, int_ops, f32_ops = ref.work(cfg, 64)
    luma = 64 * 1920 * 1080
    assert nbytes == 2 * 2 * luma == 530_841_600 and f32_ops == 0
    # 1 + 104 + 23 + 9 + 4 a sample, and 13.5 of lifting steps at 1080p
    assert int_ops == 141 * luma + 9 * 64 * (1080 * 1920 + 540 * 1920) == 20_503_756_800
    every = {**cfg, "args": {**cfg["args"], "planes": [0, 1, 2]}}
    assert ref.work(every, 64)[0] == 2 * 2 * 64 * (1920 * 1080 + 2 * 960 * 540)
    chroma = {**cfg, "args": {**cfg["args"], "planes": [1, 2]}}
    assert ref.work(chroma, 64)[0] == 2 * 2 * 64 * 2 * 960 * 540
    assert ref.work({**cfg, "args": {**cfg["args"], "strength": 0}}, 64) == (0, 0, 0)
    mixed = ref.work({**cfg, "args": {**cfg["args"], "restore": 64}}, 64)[1]
    assert mixed - int_ops == 5 * 64 * 540 * 960
    bare = ref.work({**cfg, "args": {**cfg["args"], "restore": 0, "radius": 1}}, 64)[1]
    assert bare == (1 + 56 + 23 + 7 + 4) * luma
    gray8 = {"format": "GRAY8", "bits": 8, "planes": [[64, 96]], "args": {}}
    assert ref.work(gray8, 3)[0] == 2 * 3 * 64 * 96
