"""Deband's kernels and host state in the port, held against the JAX package:

* the plain versions of ``deband_center`` (B5) and ``deband_m2_center`` (B6)
  against the Pallas kernels, run in interpret mode on the inputs of
  tests/test_kernels_interpret.py;
* the port's native RNG precompute against the JAX package's and the
  pure-Python oracle, and the structure B6 relies on (ref2 = (-val1, val2));
* the port's error-diffusion demote against the JAX package's and the plain
  NumPy loop;
* the wrappers' dispatch on the CPU and a failed native build.

The CUDA kernels themselves are held against these plain versions on the
card, in tests/test_torch_card.py and chip_smoke.py.

Tolerance: all integer (or bit-identical float buffers), so every comparison
is exact.
"""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as plmod
import jax.numpy as jnp

from oracle.deband_rng_ref import precompute_ref
from vszip_tpu.kernels import deband_m2_pallas as kp6
from vszip_tpu.kernels import deband_pallas as kp5
from vszip_tpu.runtime import deband_rng as jrng
from vszip_tpu.runtime import dither as jdither
from vszip_tpu_torch import _build, trace
from vszip_tpu_torch.kernels import deband as kd
from vszip_tpu_torch.runtime import deband_rng as trng
from vszip_tpu_torch.runtime import dither as tdither


@pytest.fixture
def interpret(monkeypatch):
    orig = plmod.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    for mod in (kp5, kp6):
        monkeypatch.setattr(mod.pl, "pallas_call", interp_call)


def _edge_cap(h, w, r):
    ys = np.minimum(np.arange(h), h - 1 - np.arange(h))[:, None]
    xs = np.minimum(np.arange(w), w - 1 - np.arange(w))[None, :]
    return np.minimum(r, np.minimum(ys, xs))


# ---------------------------------------------------------------------------
# B5 / B6 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blur_first", [True, False], ids=["bf", "nobf"])
@pytest.mark.parametrize("mode", [1, 3, 4, 5, 6])
def test_deband_center_ref_matches_pallas(interpret, mode, blur_first):
    rng = np.random.default_rng(11)
    h, w = 96, 256
    x = rng.integers(0, 65536, (2, h, w), dtype=np.uint16)
    v = np.minimum(rng.integers(0, 16, (h, w)), _edge_cap(h, w, 15)).astype(np.int32)
    thr3 = (12337, 9000, 15000)
    want = np.asarray(kp5.deband_center_pallas(jnp.asarray(x), jnp.asarray(v), mode,
                                               blur_first, 15, thr3))
    got = kd.deband_center_ref(torch.from_numpy(x), torch.from_numpy(v), mode,
                               blur_first, 15, thr3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("blur_first", [True, False], ids=["bf", "nobf"])
def test_deband_m2_center_ref_matches_pallas(interpret, blur_first):
    rng = np.random.default_rng(7)
    h, w, r = 96, 256, 15
    x = rng.integers(0, 65536, (3, h, w), dtype=np.uint16)
    cap = _edge_cap(h, w, r)
    v1 = np.clip(rng.integers(-r, r + 1, (h, w)), -cap, cap).astype(np.int32)
    v2 = np.clip(rng.integers(-r, r + 1, (h, w)), -cap, cap).astype(np.int32)
    key = ((v1 + r) * (2 * r + 1) + (v2 + r)).astype(np.int32)
    want = np.asarray(kp6.deband_m2_center_pallas(jnp.asarray(x), jnp.asarray(key),
                                                  blur_first, r, 12337))
    got = kd.deband_m2_center_ref(torch.from_numpy(x), torch.from_numpy(key),
                                  blur_first, r, 12337)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_m2_offsets_round_trip_and_floor():
    v1 = torch.tensor([-128, -15, 0, 7, 200])
    v2 = torch.tensor([200, 3, -200, -128, 0])
    key = (v1 + 200) * 401 + (v2 + 200)
    g1, g2 = kd.m2_offsets(key, 200)
    assert torch.equal(g1, v1) and torch.equal(g2, v2)
    # keys outside the alphabet decode with floor division, as the kernel does
    g1, g2 = kd.m2_offsets(torch.tensor([-1, -32]), 15)
    assert g1.tolist() == [-16, -17] and g2.tolist() == [15, 15]


def test_taps_outside_the_plane():
    x = torch.arange(1, 13, dtype=torch.int32).view(1, 3, 4)
    far = torch.full((3, 4), 5)
    # separable taps read 0 outside the plane, the m2 gathers clamp
    assert int(kd.gather(x, far, 0, True).abs().sum()) == 0
    assert torch.equal(kd.gather(x, far, 0), x[:, 2:3].expand(1, 3, 4))
    assert torch.equal(kd.gather(x, 0, -far), x[:, :, :1].expand(1, 3, 4))


# ---------------------------------------------------------------------------
# create-time state
# ---------------------------------------------------------------------------

PRECOMPUTE = {
    "m2_420_dynamic": dict(w=36, h=20, num_frames=2, seed=99, sample_mode=2, range_=15,
                           ssw=1, ssh=1, algo_ref=1, algo_grain=1, param_ref=1.0,
                           param_grain=1.0, is_float=False, dynamic=True,
                           add_grain_y=True, add_grain_c=True, grain_y=257, grain_c=514),
    "m1_422_float": dict(w=30, h=18, num_frames=3, seed=-4, sample_mode=1, range_=31,
                         ssw=1, ssh=0, algo_ref=0, algo_grain=2, param_ref=1.0,
                         param_grain=1.5, is_float=True, dynamic=True,
                         add_grain_y=True, add_grain_c=False,
                         grain_y=float(np.float32(8 / 255)), grain_c=0),
    "m7_gauss_ref": dict(w=24, h=24, num_frames=1, seed=7, sample_mode=7, range_=6,
                         ssw=0, ssh=0, algo_ref=2, algo_grain=0, param_ref=2.0,
                         param_grain=1.0, is_float=False, dynamic=False,
                         add_grain_y=False, add_grain_c=True, grain_y=0, grain_c=771),
}
KEYS = ("ref1_dy", "ref1_dx", "ref2_dy", "ref2_dx", "c_ref1_dy", "c_ref1_dx",
        "c_ref2_dy", "c_ref2_dx", "grain_y", "grain_c", "grain_offsets")


@pytest.mark.parametrize("name", sorted(PRECOMPUTE))
def test_precompute_matches_jax_and_oracle(name):
    kw = PRECOMPUTE[name]
    got = trng.deband_precompute(**kw)
    ref = precompute_ref(**kw)
    want = jrng.deband_precompute(**kw)
    assert got["item_count"] == want["item_count"] == ref["item_count"]
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if k != "grain_offsets" or kw["dynamic"]:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("range_", [15, 200])
def test_m2_offsets_are_symmetric(range_):
    """B6 takes one key per pixel: it relies on ref2 = (-val1, val2) with
    val1 = ref1_dx and val2 = ref1_dy, for luma and for chroma whenever
    ssw == ssh; 4:2:2 chroma breaks it and takes the plain gathers."""
    kw = dict(w=272, h=272, num_frames=1, seed=3, sample_mode=2, range_=range_,
              algo_ref=1, algo_grain=1, param_ref=1.0, param_grain=1.0,
              is_float=False, dynamic=False, add_grain_y=False, add_grain_c=False,
              grain_y=0, grain_c=0)
    for ss in ((0, 0), (1, 1), (1, 0)):
        pre = trng.deband_precompute(ssw=ss[0], ssh=ss[1], **kw)
        want = jrng.deband_precompute(ssw=ss[0], ssh=ss[1], **kw)
        for k in KEYS[:8]:
            np.testing.assert_array_equal(pre[k], want[k], err_msg=k)
        assert np.array_equal(pre["ref2_dy"], -pre["ref1_dx"])
        assert np.array_equal(pre["ref2_dx"], pre["ref1_dy"])
        sym = (np.array_equal(pre["c_ref2_dy"], -pre["c_ref1_dx"])
               and np.array_equal(pre["c_ref2_dx"], pre["c_ref1_dy"]))
        assert sym == (ss[0] == ss[1])
        # range 200 reaches refEncode's -128 wrap; 15 never does
        assert bool((pre["ref1_dx"] == -128).any()) == (range_ == 200)


# ---------------------------------------------------------------------------
# error-diffusion demote
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 10])
def test_error_diffusion_matches_jax(bits):
    rng = np.random.default_rng(bits)
    plane = rng.integers(0, 65536, (40, 64), dtype=np.uint16)
    shift = 16 - bits
    args = (1.0 / (1 << shift), (1 << bits) - 1)
    got = tdither.error_diffusion_demote(plane, *args)
    np.testing.assert_array_equal(got, jdither.error_diffusion_demote(plane, *args))
    small = plane[:9, :13]
    np.testing.assert_array_equal(tdither.error_diffusion_demote(small, *args),
                                  tdither._error_diffusion_py(small, *args))


# ---------------------------------------------------------------------------
# dispatch and build
# ---------------------------------------------------------------------------

def test_wrappers_take_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 65536, (2, 20, 30), dtype=np.uint16))
    v = torch.from_numpy(np.minimum(rng.integers(0, 5, (20, 30)),
                                    _edge_cap(20, 30, 4)).astype(np.int32))
    trace.reset_launches()
    for mode in kd.SEPARABLE_MODES:
        assert torch.equal(kd.deband_center(x, v, mode, True, 4, (900, 900, 900)),
                           kd.deband_center_ref(x, v, mode, True, 4, (900, 900, 900)))
    key = (v + 4) * 9 + 4
    assert torch.equal(kd.deband_m2_center(x, key, False, 4, 900),
                       kd.deband_m2_center_ref(x, key, False, 4, 900))
    assert set(kd.LAUNCHES.values()) == {0}


def test_wrappers_raise_on_other_devices():
    x = torch.empty((1, 16, 16), dtype=torch.uint16, device="meta")
    v = torch.empty((16, 16), dtype=torch.int32, device="meta")
    for fn in (lambda: kd.deband_center(x, v, 1, True, 4, (1, 1, 1)),
               lambda: kd.deband_m2_center(x, v, True, 4, 1)):
        with pytest.raises(ValueError, match="no Deband kernel for device meta"):
            fn()
    assert set(kd.LAUNCHES.values()) == {0}


def test_failed_native_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build("dither", "deband_rng")
    assert _build.library_path("deband_rng").parent == tmp_path / "build"
