"""The CUDA kernels on the card: each against its plain PyTorch version, the
slice on the card against the port's CPU path, the launch counters, and the
wrappers' input checks.  Every test here needs an NVIDIA GPU and skips
without one.  This file imports no JAX (the card's machine has none), so it
runs there on its own, without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

Tolerance: all integer, so every comparison is bit-exact.
"""

import numpy as np
import pytest
import torch

import vszip_tpu_torch as vt
from vszip_tpu_torch.kernels import boxblur as kb

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
    cpu = vt.Clip.from_planes(planes, fmt)
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
