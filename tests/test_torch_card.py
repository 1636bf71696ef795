"""The CUDA kernels on the card: each against its plain PyTorch version, the
slice (BoxBlur, Limiter, Deband) on the card against the port's CPU path, the launch counters, and the
wrappers' input checks.  Every test here needs an NVIDIA GPU and skips
without one.  This file imports no JAX (the card's machine has none), so it
runs there on its own, without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

Tolerance: every plane compared here is integer, so bit-exact (Deband m6's
f32 soft blend included: the kernel builds without FMA contraction and
rounds as the plain torch ops do).
"""

import numpy as np
import pytest
import torch

import vszip_tpu_torch as vt
from vszip_tpu_torch.kernels import boxblur as kb
from vszip_tpu_torch.kernels import deband as kd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _same(a, b):
    # uint16 compared as int32: torch lacks uint16 kernels on some devices
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.to(torch.int32), b.to(torch.int32)))


def _rand(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, torch.iinfo(dtype).max + 1, shape, generator=g,
                         device=device, dtype=torch.int32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=str)
@pytest.mark.parametrize("shape", [(2, 33, 77), (1, 7, 13), (3, 540, 960)], ids=str)
def test_kernels_match_plain(cuda, shape, dtype):
    x = _rand(shape, dtype, cuda)
    for r in (1, 3, 13, 22, 23, 40):
        if 2 * r >= min(shape[1:]):
            continue
        if r <= 22:
            assert _same(kb.ct_blur_int(x, r), kb.ct_blur_int_ref(x, r))
        for p in (1, 2, 5):
            assert _same(kb.rt_blur_h(x, r, p), kb.h_fixed_ref(x, r, p))
            assert _same(kb.rt_blur_v_multi(x, r, p), kb.v_fixed_ref(x, r, p))
        assert _same(kb.rt_blur_v(x, r), kb.v_fixed_ref(x, r))


def test_axis_radius_limits_are_per_axis(cuda):
    # a wide, short plane: the H window fits, the V window would not
    x = _rand((1, 9, 200), torch.uint16, cuda)
    assert _same(kb.rt_blur_h(x, 30, 2), kb.h_fixed_ref(x, 30, 2))
    with pytest.raises(ValueError, match="do not take radius"):
        kb.rt_blur_v(x, 30)


@pytest.mark.parametrize("width", [16, 8, 3])
def test_comptime_quirk_window_wider_than_row(cuda, width):
    # hpasses=0 skips the hradius check, so the H window may pass the row's
    # width; the mirror then repeats as NumPy's 'symmetric' pad does
    x = _rand((2, 64, width), torch.uint16, cuda)
    assert _same(kb.ct_blur_int(x, 10), kb.ct_blur_int_ref(x, 10))
    assert _same(kb.rt_blur_h(x, 10, 3), kb.h_fixed_ref(x, 10, 3))


@pytest.mark.parametrize("args", [
    {"hradius": 13, "vradius": 13},
    {"hradius": 13, "hpasses": 5, "vradius": 13, "vpasses": 5},
    {"hradius": 23, "vradius": 23},
    {"hradius": 4, "vradius": 9},
    {"hradius": 5, "vradius": 5, "hpasses": 0},
], ids=str)
def test_boxblur_on_card_matches_cpu(cuda, args):
    rng = np.random.default_rng(3)
    fmt = vt.get_format("YUV420P16")
    planes = [rng.integers(0, 1 << 16, (2,) + fmt.plane_dims(192, 128, p)[::-1],
                           dtype=np.uint16) for p in range(3)]
    cpu = vt.Clip.from_planes(planes, fmt, device="cpu")
    kb.reset_launches()
    got = vt.limiter(vt.boxblur(cpu.to(cuda), **args), tv_range=True)
    assert sum(kb.LAUNCHES.values()) > 0
    want = vt.limiter(vt.boxblur(cpu, **args), tv_range=True)
    for g, w in zip(got.planes, want.planes):
        assert g.is_cuda and _same(g.cpu(), w)


def test_wrappers_reject_what_kernels_do_not_take(cuda):
    x = _rand((2, 32, 48), torch.uint16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kb.rt_blur_h(x.transpose(1, 2), 3)
    with pytest.raises(ValueError, match="uint8/uint16"):
        kb.rt_blur_v(x.to(torch.int32), 3)
    with pytest.raises(ValueError, match="do not take radius"):
        kb.ct_blur_int(x, 16)
    with pytest.raises(ValueError, match="passes >= 1"):
        kb.rt_blur_v_multi(x, 3, 0)


def _offsets(shape, rmax, device, signed, seed=0):
    """Seeded offsets in [0, cap] (or [-cap, cap]), cap = min(rmax, the
    distance to the nearest edge)."""
    h, w = shape
    rng = np.random.default_rng(seed)
    ys = np.minimum(np.arange(h), h - 1 - np.arange(h))[:, None]
    xs = np.minimum(np.arange(w), w - 1 - np.arange(w))[None, :]
    cap = np.minimum(rmax, np.minimum(ys, xs))
    v = rng.integers(-rmax if signed else 0, rmax + 1, (h, w))
    return torch.from_numpy(np.clip(v, -cap if signed else 0, cap).astype(np.int32)).to(device)


@pytest.mark.parametrize("shape", [(2, 33, 77), (1, 7, 13), (2, 540, 960)], ids=str)
def test_deband_kernels_match_plain(cuda, shape):
    x = _rand(shape, torch.uint16, cuda, seed=2)
    for rmax in (1, 15, 100):
        v = _offsets(shape[1:], rmax, cuda, signed=False)
        for mode in kd.SEPARABLE_MODES:
            for bf in (True, False):
                thr3 = (12337, 20000, 6000)
                assert torch.equal(kd.deband_center(x, v, mode, bf, rmax, thr3),
                                   kd.deband_center_ref(x, v, mode, bf, rmax, thr3))
    for rmax in (15, 64, 200):
        v1 = _offsets(shape[1:], rmax, cuda, signed=True, seed=1)
        v2 = _offsets(shape[1:], rmax, cuda, signed=True, seed=2)
        key = (v1 + rmax) * (2 * rmax + 1) + (v2 + rmax)
        for bf in (True, False):
            assert torch.equal(kd.deband_m2_center(x, key, bf, rmax, 12337),
                               kd.deband_m2_center_ref(x, key, bf, rmax, 12337))


def test_deband_kernels_read_any_offset_plane(cuda):
    # offsets past the edges: B5 reads 0 there, B6 clamps, as the plain
    # versions do
    x = _rand((2, 40, 50), torch.uint16, cuda, seed=3)
    g = torch.Generator(device=cuda).manual_seed(4)
    wild = torch.randint(-300, 300, (40, 50), generator=g, device=cuda, dtype=torch.int32)
    for mode in kd.SEPARABLE_MODES:
        assert torch.equal(kd.deband_center(x, wild, mode, True, 15, (900, 900, 900)),
                           kd.deband_center_ref(x, wild, mode, True, 15, (900, 900, 900)))
    assert torch.equal(kd.deband_m2_center(x, wild, False, 15, 900),
                       kd.deband_m2_center_ref(x, wild, False, 15, 900))


@pytest.mark.parametrize("fmt,args", [
    ("YUV420P16", {"sample_mode": 1}),
    ("YUV420P16", {}),
    ("YUV420P16", {"sample_mode": 6, "thr": 30, "grain": [8, 4], "dynamic_grain": True}),
    ("YUV422P16", {"thr": 20}),
    ("YUV420P8", {"sample_mode": 4, "thr": 20}),
    ("GRAY16", {"range": 200, "thr": 40}),
], ids=str)
def test_deband_on_card_matches_cpu(cuda, fmt, args):
    rng = np.random.default_rng(5)
    f = vt.get_format(fmt)
    planes = [rng.integers(0, 1 << f.bits_per_sample,
                           (2,) + f.plane_dims(272, 160, p)[::-1]).astype(f.storage_dtype)
              for p in range(f.num_planes)]
    cpu = vt.Clip.from_planes(planes, f, device="cpu")
    kd.reset_launches()
    got = vt.deband(cpu.to(cuda), **args)
    assert sum(kd.LAUNCHES.values()) > 0  # every case runs B5 or B6 on some plane
    want = vt.deband(cpu, **args)
    for g, w in zip(got.planes, want.planes):
        assert g.is_cuda and _same(g.cpu(), w)


def test_deband_wrappers_reject_what_kernels_do_not_take(cuda):
    x = _rand((2, 32, 48), torch.uint16, cuda)
    v = torch.zeros((32, 48), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="uint16"):
        kd.deband_center(x.to(torch.int32), v, 1, True, 4, (1, 1, 1))
    with pytest.raises(ValueError, match="offset plane"):
        kd.deband_m2_center(x, v[:16], True, 4, 1)
    with pytest.raises(ValueError, match="modes"):
        kd.deband_center(x, v, 2, True, 4, (1, 1, 1))
