"""MosquitoNR's smoothing kernel (``vszip_tpu_torch.kernels.mosquito_nr``).

On the CPU: the identities the kernel's arithmetic rests on, on the
direction tables written out as tap lists, equal the plain version bit for
bit (integers: each SAD ranked as the key 8 (SAD / 8) + direction on the
raw samples, both blends as one formula on the raw samples; f32: both
blends from the same six taps, each sum in the plain version's order); the
wrapper takes the plain version for a CPU tensor and counts no launch.  On
the card: the kernel equals the plain version bit for bit over sample
types, radii, strengths, sizes (4x4, odd, widths off the 64-column tile and
off 16 bytes), frame counts and pictures (noise, a constant plane, ties,
the range's ends), one launch a plane; the wrapper refuses what the kernel
does not take.  This file imports no JAX, so its card tests run on the
card's machine as

    python -m pytest --noconftest -m cuda tests/test_torch_mosquito_kernel.py
"""

import pytest
import torch

from vszip_tpu_torch import trace
from vszip_tpu_torch.kernels import mosquito_nr as kmn

# sample kinds: (dtype, lowest, highest sample)
KINDS = {"u8": (torch.uint8, 0, 255), "u16_10bit": (torch.uint16, 0, 1023),
         "u16_16bit": (torch.uint16, 0, 65535), "f32": (torch.float32, 0.0, 1.0),
         "f32_chroma": (torch.float32, -0.5, 0.5)}
PICTURES = ("noise", "constant", "ties", "ends")
# The directions as the kernel's tables give them: the four lines run along
# e, with near taps at +-e (and +-2e at radius 2); the four bends pair near
# taps at +-u and +-w with far ones at +-f.
LINES = ((0, 1), (1, 1), (1, 0), (1, -1))
BENDS = (((1, 1), (0, 1), (1, 2)), ((1, 1), (1, 0), (2, 1)), ((1, -1), (1, 0), (2, -1)),
         ((1, -1), (0, -1), (1, -2)))


def _picture(kind, picture, shape, seed, device="cpu"):
    """A seeded plane of `kind`: uniform noise over the range, one value
    everywhere, three values (many equal SADs), or the range's two ends."""
    dtype, lo, hi = KINDS[kind]
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(shape, generator=g, dtype=torch.float64)
    if picture == "constant":
        u = torch.full(shape, 0.37, dtype=torch.float64)
    elif picture == "ties":
        u = torch.randint(0, 3, shape, generator=g).to(torch.float64) / 4
    elif picture == "ends":
        u = torch.randint(0, 2, shape, generator=g).to(torch.float64)
    if dtype.is_floating_point:
        x = (lo + u * (hi - lo)).to(dtype)
    else:
        x = torch.round(lo + u * (hi - lo)).to(torch.int32).to(dtype)
    return x.to(device)


def _neg(o):
    return (-o[0], -o[1])


def _dbl(o):
    return (2 * o[0], 2 * o[1])


@pytest.mark.parametrize("picture", PICTURES)
@pytest.mark.parametrize("strength", [1, 16, 32])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("kind", list(KINDS))
def test_the_kernels_arithmetic_equals_the_plain_version(kind, radius, strength, picture):
    x = _picture(kind, picture, (2, 19, 23), seed=radius * 100 + strength)
    is_int = not x.is_floating_point()
    h, w = x.shape[1:]
    raw = kmn._pad2(x.to(torch.int32) if is_int else x)

    def taps(p):
        return lambda dy, dx: p[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]

    lifted = taps(raw << 4 if is_int else raw)
    dirs = kmn._sads(lifted, radius, is_int)
    want = kmn._blend(lifted, dirs, strength, radius, is_int)
    t, s = taps(raw), strength
    c = t(0, 0)
    if is_int:
        def ad(o):
            return (t(*o) - c).abs()

        def pr(a, b):
            return (t(*a) + t(*b) - 2 * c).abs()

        keys = [sum(ad(o) + ad(_neg(o)) for o in ([e] if radius == 1 else [e, _dbl(e)])) * 16 + d
                for d, e in enumerate(LINES)]
        for d, (u, v, f) in enumerate(BENDS):
            key = (pr(_neg(u), _neg(v)) + pr(u, v)) * 8 + 4 + d
            keys.append(key + (ad(f) + ad(_neg(f))) * 16 if radius == 2 else key)
        best = torch.stack(keys).amin(0)
        assert torch.equal(torch.where(best < 8, 8, best & 7), dirs)
        # a line's near taps counted twice (u = w = e), its far pair at 2e
        six = [(e, e, _dbl(e)) for e in LINES] + list(BENDS)
        pick = (best & 7).long()[None]
        n4 = torch.stack([t(*_neg(u)) + t(*_neg(v)) + t(*v) + t(*u) for u, v, _ in six])
        f2 = torch.stack([t(*_neg(f)) + t(*f) for _, _, f in six])
        n4, f2 = n4.gather(0, pick)[0], f2.gather(0, pick)[0]
        if radius == 2:
            acc = ((256 - 8 * s) * c + s * n4 + 2 * s * f2 + 8) >> 4
        else:
            acc = ((128 - 4 * s) * c + s * n4 + 4) >> 3
        assert torch.equal(torch.where(best < 8, c << 4, acc), want)
        return
    # a vertical line term serves the sample below: |a - b| is |b - a|
    assert torch.equal((t(1, 0) - c).abs().view(torch.int32),
                       (c - t(1, 0)).abs().view(torch.int32))
    # a line sums t(-2e), t(-e), t(e), t(2e) (radius 1: t(-e), t(e))
    got = c
    for d, (u, v, f) in enumerate([(_dbl(e), e, (0, 0)) for e in LINES] + list(BENDS)):
        near4 = ((t(*_neg(u)) + t(*_neg(v))) + t(*v)) + t(*u)
        if radius == 2 and d < 4:
            arm = ((128 - 4 * s) * c + s * near4) * (1.0 / 128)
        elif radius == 2:
            arm = (((256 - 8 * s) * c + (2 * s) * (t(*_neg(f)) + t(*f))) + s * near4) * (1.0 / 256)
        elif d < 4:
            arm = ((64 - 2 * s) * c + s * (t(*_neg(v)) + t(*v))) * (1.0 / 64)
        else:
            arm = ((128 - 4 * s) * c + s * near4) * (1.0 / 128)
        got = torch.where(dirs == d, arm, got)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_the_cpu_takes_the_plain_version_and_counts_nothing():
    x = _picture("u16_16bit", "noise", (2, 9, 12), seed=5)
    trace.reset_launches()
    with trace.collect() as t:
        blur, work = kmn.mosquito_nr_smooth(x, 16, 2, True)
    want, want_work = kmn.mosquito_nr_smooth_ref(x, 16, 2, True)
    assert torch.equal(blur, want) and torch.equal(work, want_work)
    assert kmn.LAUNCHES == {"mosquito_nr_smooth": 0} and t.launches == {}
    assert [s[0] for s in t.spans] == ["vszip.kernel.mosquito_nr_smooth"]
    assert kmn.mosquito_nr_smooth(x, 16, 2, False)[1] is None
    xf = _picture("f32", "noise", (1, 6, 7), seed=6)
    assert kmn.mosquito_nr_smooth(xf, 8, 1, True)[1] is xf


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# (frames, height, width): the minimum, odd sizes, a width past two tiles that
# is off 16 bytes, one on the tile and a width whose last tile is partial
SHAPES = [(1, 4, 4), (3, 37, 53), (1, 45, 130), (3, 36, 128), (1, 70, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("picture", PICTURES)
@pytest.mark.parametrize("strength", [1, 16, 32])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("kind", list(KINDS))
def test_smooth_kernel_matches_the_plain_version(cuda, kind, radius, strength, picture, shape):
    x = _picture(kind, picture, shape, seed=sum(shape) + strength, device=cuda)
    want_work = (strength + len(picture)) % 2 == 0
    trace.reset_launches()
    blur, work = kmn.mosquito_nr_smooth(x, strength, radius, want_work)
    assert kmn.LAUNCHES == {"mosquito_nr_smooth": 1}
    want, want_w = kmn.mosquito_nr_smooth_ref(x, strength, radius, want_work)
    assert blur.is_cuda and blur.dtype == want.dtype and torch.equal(_bits(blur), _bits(want))
    if want_w is None:
        assert work is None
    else:
        assert work.dtype == want_w.dtype and torch.equal(_bits(work), _bits(want_w))


@pytest.mark.cuda
def test_smooth_kernel_refuses_what_it_does_not_take(cuda):
    x = _picture("u16_16bit", "noise", (2, 40, 48), seed=1, device=cuda)
    trace.reset_launches()
    with pytest.raises(ValueError, match="contiguous"):
        kmn.mosquito_nr_smooth(x.transpose(1, 2), 16, 2, True)
    for dtype in (torch.int32, torch.float16):
        with pytest.raises(ValueError, match="uint8"):
            kmn.mosquito_nr_smooth(x.to(dtype), 16, 2, True)
    with pytest.raises(ValueError, match="at least 4x4"):
        kmn.mosquito_nr_smooth(x[:, :3].contiguous(), 16, 2, True)
    with pytest.raises(ValueError, match="radius 3"):
        kmn.mosquito_nr_smooth(x, 16, 3, True)
    assert kmn.LAUNCHES == {"mosquito_nr_smooth": 0}
