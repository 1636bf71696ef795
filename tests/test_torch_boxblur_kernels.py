"""The BoxBlur kernels' plain PyTorch versions held against the Pallas kernels
(run in interpret mode, as tests/test_boxblur_kernel.py runs them) and the
JAX package's jnp path; and the wrappers' dispatch on the CPU.  The CUDA
kernels themselves are held against these plain versions on the card, in
tests/test_torch_card.py and chip_smoke.py.

Tolerance: all integer, so every comparison is bit-exact.
"""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as plmod
import jax.numpy as jnp

from vszip_tpu.kernels import boxblur_pallas as kp
from vszip_tpu.ops.boxblur import _blur_int_rt_1d, _ct_blur_int
from vszip_tpu_torch import trace
from vszip_tpu_torch.kernels import boxblur as kt


@pytest.fixture
def interpret(monkeypatch):
    orig = plmod.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(kp.pl, "pallas_call", interp_call)


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)


def _jnp_rt(x, radius, axis, passes=1):
    for _ in range(passes):
        x = _blur_int_rt_1d(x, radius, axis)
    return x


@pytest.mark.parametrize(
    "shape,radius,dtype",
    [
        ((2, 48, 160), 5, np.uint16),
        ((1, 40, 136), 3, np.uint8),
        ((1, 33, 77), 8, np.uint16),
        ((1, 7, 13), 2, np.uint8),
    ],
    ids=str,
)
def test_ct_blur_int_ref_matches_pallas(shape, radius, dtype, interpret):
    x = _rand(shape, dtype, 11)
    got = kt.ct_blur_int_ref(torch.from_numpy(x), radius).numpy()
    np.testing.assert_array_equal(got, np.asarray(kp.ct_blur_int_pallas(jnp.asarray(x), radius)))
    np.testing.assert_array_equal(got, np.asarray(_ct_blur_int(jnp.asarray(x), radius)))


@pytest.mark.parametrize(
    "shape,radius,dtype",
    [
        ((2, 48, 160), 5, np.uint16),
        ((1, 40, 136), 7, np.uint8),
        ((1, 33, 130), 1, np.uint16),
    ],
    ids=str,
)
def test_fixed_refs_match_pallas(shape, radius, dtype, interpret):
    x = _rand(shape, dtype, 5)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    v = kt.v_fixed_ref(xt, radius).numpy()
    h = kt.h_fixed_ref(xt, radius).numpy()
    np.testing.assert_array_equal(v, np.asarray(kp.rt_blur_v_pallas(xj, radius)))
    np.testing.assert_array_equal(h, np.asarray(kp.rt_blur_h_pallas(xj, radius)))
    np.testing.assert_array_equal(v, np.asarray(_jnp_rt(xj, radius, 1)))
    np.testing.assert_array_equal(h, np.asarray(_jnp_rt(xj, radius, 2)))


@pytest.mark.parametrize(
    "shape,radius,passes,dtype",
    [
        ((2, 96, 160), 5, 3, np.uint16),
        ((1, 80, 136), 13, 5, np.uint8),
        ((1, 67, 130), 3, 2, np.uint16),
        ((1, 300, 140), 22, 5, np.uint16),
    ],
    ids=str,
)
def test_multipass_refs_match_pallas(shape, radius, passes, dtype, interpret):
    x = _rand(shape, dtype, 7)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    v = kt.v_fixed_ref(xt, radius, passes).numpy()
    np.testing.assert_array_equal(
        v, np.asarray(kp.rt_blur_v_multi_pallas(xj, radius, passes, 64)))
    np.testing.assert_array_equal(v, np.asarray(_jnp_rt(xj, radius, 1, passes)))
    h = kt.h_fixed_ref(xt, radius, passes).numpy()
    np.testing.assert_array_equal(
        h, np.asarray(kp.rt_blur_h_pallas(xj, radius, 256, passes)))


def test_giant_plane_takes_int64_sums():
    # (h + 2r) * 65535 >= 2^31: the JAX package's i64 fallback
    x = _rand((1, 32780, 3), np.uint16, 9)
    got = kt.v_fixed_ref(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(_blur_int_rt_1d(jnp.asarray(x), 2, 1)))


def test_wrappers_take_plain_version_on_cpu_without_counting():
    x = torch.from_numpy(_rand((2, 30, 41), np.uint16, 1))
    trace.reset_launches()
    assert torch.equal(kt.ct_blur_int(x, 4), kt.ct_blur_int_ref(x, 4))
    assert torch.equal(kt.rt_blur_h(x, 4, 3), kt.h_fixed_ref(x, 4, 3))
    assert torch.equal(kt.rt_blur_v_multi(x, 4, 3), kt.v_fixed_ref(x, 4, 3))
    assert torch.equal(kt.rt_blur_v(x, 4), kt.v_fixed_ref(x, 4))
    assert set(kt.LAUNCHES.values()) == {0}


def test_wrappers_raise_on_other_devices():
    x = torch.empty((1, 16, 16), dtype=torch.uint8, device="meta")
    for fn in (lambda: kt.ct_blur_int(x, 2), lambda: kt.rt_blur_h(x, 2, 2),
               lambda: kt.rt_blur_v_multi(x, 2, 2), lambda: kt.rt_blur_v(x, 2)):
        with pytest.raises(ValueError, match="no BoxBlur kernel for device meta"):
            fn()
    assert set(kt.LAUNCHES.values()) == {0}


def test_failed_build_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ce

    from vszip_tpu_torch import _build

    monkeypatch.setattr(ce, "CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("boxblur")
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("radius,passes,on_chip", [
    (13, 5, True), (23, 1, True), (1, 6, True), (13, 7, False), (1, 100, False),
    # the largest radius whose rings fit a block's 227 KB, and the next
    (897, 1, True), (898, 1, False), (179, 5, True), (180, 5, False),
    (149, 6, True), (150, 6, False), (539, 1, True), (539, 2, False),
], ids=str)
def test_v_fixed_takes_the_column_walk_past_the_rings(radius, passes, on_chip):
    # v_chip keeps passes * (2r + 1) + 20 rows of 128 bytes per warp and
    # unrolls at most 6 passes; past either the wrapper takes v_fixed's walk
    assert kt.v_fixed_on_chip(radius, passes) is on_chip


def test_h_fixed_warp_runs_are_the_kernels():
    # kernels/boxblur.py H_WARP_RUNS mirrors csrc/boxblur.cu kWarpRuns, whose
    # instantiations vz_h_fixed_warp launches on the run the wrapper chose
    import re
    from pathlib import Path

    src = (Path(kt.__file__).resolve().parents[1] / "csrc" / "boxblur.cu").read_text()
    body = re.search(r"constexpr int kWarpRuns\[\]\[3\] = \{(.*?)\};", src, re.S).group(1)
    runs = tuple((int(a), int(b)) for a, b, _ in re.findall(r"\{(\d+), (\d+), (\d+)\}", body))
    assert runs == kt.H_WARP_RUNS
    # every run's registers hold its chunks (at most 48 slots: r <= 23)
    assert [s for s, _ in runs] == sorted(s for s, _ in runs) and runs[-1][0] == 48


@pytest.mark.parametrize("w,radius,passes,in_registers", [
    # 1080p YUV420 planes at the benchmark's r 13, one pass (B1) and five (B2)
    (1920, 13, 1, True), (960, 13, 1, True), (1920, 13, 5, True), (960, 13, 5, True),
    # the runtime path's r 23 at one pass; B1's largest comptime radius
    (1920, 23, 1, True), (1920, 22, 1, True),
    # past the runs (r > 23), past a lane's registers (4K rows), r > w
    (1920, 24, 1, False), (3840, 13, 1, False), (3840, 1, 1, False), (12, 13, 1, False),
    # more passes need wider margins
    (2500, 13, 1, True), (2500, 13, 6, False),
], ids=str)
def test_h_fixed_in_registers_takes_the_1080p_planes(w, radius, passes, in_registers):
    assert kt.h_fixed_in_registers(w, radius, passes) is in_registers
