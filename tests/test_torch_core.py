"""The PyTorch port's core (format registry, parameter helpers, Clip) held
against vszip_tpu's, plus the port's import boundary.

Tolerances: none apply; every comparison here is exact (values, shapes,
dtypes and error messages).  The helpers at the top are shared by the other
``test_torch_*`` files.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vszip_tpu as vz
import vszip_tpu_torch as vt
from vszip_tpu.core import params as jparams
from vszip_tpu_torch.core import params as tparams

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def make_planes(fmt_name, rng, n=2, h=56, w=96):
    """Seeded random planes for `fmt_name` as NumPy arrays: full-range
    integers, or floats in [0, 1) rounded to the format's float type."""
    fmt = vz.get_format(fmt_name)
    planes = []
    for p in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, p)
        if fmt.sample_type.name == "INTEGER":
            planes.append(rng.integers(0, 1 << fmt.bits_per_sample, (n, ph, pw),
                                       dtype=fmt.storage_dtype))
        else:
            planes.append(rng.random((n, ph, pw), dtype=np.float32)
                          .astype(fmt.storage_dtype))
    return planes


def both_clips(fmt_name, planes):
    """The same planes as a vszip_tpu clip and a vszip_tpu_torch clip."""
    return (vz.Clip.from_planes(planes, vz.get_format(fmt_name)),
            vt.Clip.from_planes(planes, vt.get_format(fmt_name), device="cpu"))


def assert_planes_match(got, want):
    """Port planes (tensors) against JAX planes under the port's contract:
    integer planes bit-exact; f32 within rtol 2e-6 / atol 1e-6 (the
    tpu_parity criterion: XLA:CPU contracts the JAX tap ladders into FMA,
    the port keeps the reference's separate multiply and add); f16 within
    one f16 ulp of the JAX value."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-6)
        elif w.dtype == np.float16:
            ulp = np.spacing(np.abs(w)).astype(np.float64)
            d = np.abs(g.astype(np.float64) - w.astype(np.float64))
            assert (d <= ulp).all(), f"max f16 error {d.max()}"
        else:
            np.testing.assert_array_equal(g, w)


def same_error(fn_jax, fn_torch, exc=Exception):
    """Both calls raise `exc` with the same message; returns the message."""
    with pytest.raises(exc) as ej:
        fn_jax()
    with pytest.raises(exc) as et:
        fn_torch()
    assert type(ej.value).__name__ == type(et.value).__name__
    assert str(ej.value) == str(et.value)
    return str(et.value)


# ---------------------------------------------------------------------------
# import boundary
# ---------------------------------------------------------------------------

def test_import_loads_no_jax():
    code = ("import sys, vszip_tpu_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'vszip_tpu' or m.startswith('vszip_tpu.')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_package_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|vszip_tpu)(\.|\s|$)", re.M)
    files = sorted((ROOT / "vszip_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders


# ---------------------------------------------------------------------------
# format registry
# ---------------------------------------------------------------------------

def test_format_registry_matches():
    from vszip_tpu.core.format import _registry as jreg
    from vszip_tpu_torch.core.format import _registry as treg

    assert sorted(jreg()) == sorted(treg())
    np_to_torch = {np.uint8: torch.uint8, np.uint16: torch.uint16,
                   np.uint32: torch.uint32, np.float16: torch.float16,
                   np.float32: torch.float32}
    for name, jf in jreg().items():
        tf = vt.get_format(name)
        assert tf.name == jf.name == name
        assert tf.color_family.value == jf.color_family.value
        assert tf.sample_type.value == jf.sample_type.value
        assert (tf.bits_per_sample, tf.subsampling_w, tf.subsampling_h) == (
            jf.bits_per_sample, jf.subsampling_w, jf.subsampling_h)
        assert tf.num_planes == jf.num_planes
        assert tf.bytes_per_sample == jf.bytes_per_sample
        assert tf.storage_dtype == jf.storage_dtype
        assert tf.torch_dtype == np_to_torch[jf.storage_dtype.type]
        assert tf.hist_len() == jf.hist_len()
        for chroma in (False, True):
            for rng in ("FULL", "LIMITED"):
                assert tf.peak_value(chroma, vt.ColorRange[rng]) == jf.peak_value(
                    chroma, vz.ColorRange[rng])
                assert tf.lowest_value(chroma, vt.ColorRange[rng]) == jf.lowest_value(
                    chroma, vz.ColorRange[rng])
        assert tf.plane_dims(1920, 1080, 1) == jf.plane_dims(1920, 1080, 1)
    same_error(lambda: vz.get_format("YUV420P11"), lambda: vt.get_format("YUV420P11"),
               KeyError)


def test_format_validation_matches():
    same_error(lambda: vz.VideoFormat(vz.ColorFamily.GRAY, vz.SampleType.INTEGER, 11),
               lambda: vt.VideoFormat(vt.ColorFamily.GRAY, vt.SampleType.INTEGER, 11),
               ValueError)
    same_error(lambda: vz.VideoFormat(vz.ColorFamily.RGB, vz.SampleType.INTEGER, 8, 1, 1),
               lambda: vt.VideoFormat(vt.ColorFamily.RGB, vt.SampleType.INTEGER, 8, 1, 1),
               ValueError)
    assert vt.get_format("YUV420P16").replace(bits_per_sample=8) == vt.get_format("YUV420P8")


# ---------------------------------------------------------------------------
# parameter helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planes,num", [
    (None, 3), (0, 3), ([1, 2], 3), (np.int64(2), 3), ([0], 1),
    ([3], 3), ([-1], 3), ([1, 1], 3), ([0, 2, 0], 3),
], ids=str)
def test_parse_planes_matches(planes, num):
    try:
        want = jparams.parse_planes(planes, num, "Flt")
    except jparams.VSZipError as e:
        with pytest.raises(tparams.VSZipError) as et:
            tparams.parse_planes(planes, num, "Flt")
        assert str(et.value) == str(e)
    else:
        assert tparams.parse_planes(planes, num, "Flt") == want


@pytest.mark.parametrize("value,default,lo,hi", [
    (None, 5, 0, 10), (3, 5, 0, 10), (11, 5, 0, 10), (-1, 5, 0, 10),
    ([1, 2], 0, 0, 5), ([1, 9], 0, 0, 5), ([1, 2, 3, 4], 0, 0, 5),
    (None, [1, 2], 0, 5), (2.5, 0.0, 0.0, 3.0),
], ids=str)
def test_get_value_and_array_match(value, default, lo, hi):
    for name in ("get_value", "get_array"):
        if name == "get_value" and (isinstance(value, list) or isinstance(default, list)):
            continue
        fj, ft = getattr(jparams, name), getattr(tparams, name)
        try:
            want = fj(value, "k", default, lo, hi, "Flt")
        except jparams.VSZipError as e:
            with pytest.raises(tparams.VSZipError) as et:
                ft(value, "k", default, lo, hi, "Flt")
            assert str(et.value) == str(e)
        else:
            assert ft(value, "k", default, lo, hi, "Flt") == want
    assert issubclass(tparams.VSZipError, ValueError)
    same_error(lambda: jparams.require(False, "Flt", "no"),
               lambda: tparams.require(False, "Flt", "no"))


def test_compare_clips_matches():
    rng = np.random.default_rng(3)
    cases = [("GRAY8", 2, 16, 32), ("GRAY8", 2, 16, 30), ("YUV420P8", 2, 16, 32),
             ("YUV444P8", 2, 16, 32), ("GRAY16", 2, 16, 32), ("GRAY8", 3, 16, 32)]
    clips = [both_clips(f, make_planes(f, rng, n, h, w)) for f, n, h, w in cases]
    for aj, at in clips:
        for bj, bt in clips:
            for same_len, bigger in ((True, False), (False, False), (False, True)):
                try:
                    jparams.compare_clips([aj, None, bj], "Flt", same_len, bigger)
                except jparams.VSZipError as e:
                    with pytest.raises(tparams.VSZipError) as et:
                        tparams.compare_clips([at, None, bt], "Flt", same_len, bigger)
                    assert str(et.value) == str(e)
                else:
                    tparams.compare_clips([at, None, bt], "Flt", same_len, bigger)


# ---------------------------------------------------------------------------
# Clip
# ---------------------------------------------------------------------------

def test_from_planes_errors_match():
    rng = np.random.default_rng(4)
    y, u, v = make_planes("YUV420P16", rng, 2, 16, 32)
    jf, tf = vz.get_format("YUV420P16"), vt.get_format("YUV420P16")
    for planes in ((y, u), (y, u, v[0]), (y, u[:, :, :15], v), (y, v[:, :7], u)):
        same_error(lambda: vz.Clip.from_planes(planes, jf),
                   lambda: vt.Clip.from_planes(planes, tf, device="cpu"), ValueError)
    with pytest.raises(ValueError, match=r"plane 1 dtype torch.uint8 != torch.uint16"):
        vt.Clip.from_planes((y, u.astype(np.uint8), v), tf, device="cpu")


def test_constructors_default_to_the_card():
    rng = np.random.default_rng(4)
    planes = make_planes("YUV420P16", rng, 1, 8, 16)
    fmt = vt.get_format("YUV420P16")
    calls = (lambda: vt.Clip.from_planes(planes, fmt),
             lambda: vt.Clip.blank(fmt, 16, 8))
    for call in calls:
        if torch.cuda.is_available():
            assert all(p.is_cuda for p in call().planes)
        else:  # torch's own error, never a clip left on the CPU
            with pytest.raises((AssertionError, RuntimeError)):
                call()
    cpu = vt.Clip.from_planes([torch.from_numpy(p) for p in planes], fmt, device="cpu")
    assert all(p.device.type == "cpu" for p in cpu.planes)


def test_clip_accessors_match():
    rng = np.random.default_rng(5)
    planes = make_planes("YUV420P10", rng, 3, 16, 32)
    cj, ct = both_clips("YUV420P10", planes)
    assert all(isinstance(p, torch.Tensor) for p in ct.planes)
    for attr in ("num_planes", "num_frames", "width", "height"):
        assert getattr(ct, attr) == getattr(cj, attr)
    assert [ct.plane_dims(p) for p in range(3)] == [cj.plane_dims(p) for p in range(3)]
    assert ct.color_range().value == cj.color_range().value
    for cr in (0, 1, np.array([0, 1, 1])):
        assert (ct.with_props(_ColorRange=cr).color_range().value
                == cj.with_props(_ColorRange=cr).color_range().value)
    assert ct.with_props(_ColorRange=torch.tensor([0, 1])).color_range() is vt.ColorRange.FULL
    assert (vt.Clip.blank(vt.get_format("RGB24"), 8, 4, device="cpu").color_range()
            is vt.ColorRange.FULL)
    f1 = ct.frame(1)
    assert f1.num_frames == 1
    assert_planes_match(f1.planes, cj.frame(1).planes)
    host = ct.numpy()
    assert all(isinstance(p, np.ndarray) for p in host.planes)
    assert_planes_match(host.planes, cj.planes)
    moved = ct.with_props(A=torch.arange(3)).to("cpu")
    assert moved.props["A"].device.type == "cpu" and moved.format == ct.format
    swapped = ct.with_planes(ct.planes[::-1])
    assert swapped.planes[0] is ct.planes[2] and swapped.props is not ct.props
    for fmt in ("YUV420P16", "GRAYS", "RGB24", "YUV444PH"):
        for value in (None, 7, [1, 2, 3]):
            if value == [1, 2, 3] and fmt == "GRAYS":
                continue
            bj = vz.Clip.blank(vz.get_format(fmt), 12, 8, 2, value=value)
            bt = vt.Clip.blank(vt.get_format(fmt), 12, 8, 2, value=value, device="cpu")
            assert_planes_match(bt.planes, bj.planes)


def test_from_reference_carries_planes_and_props():
    rng = np.random.default_rng(6)
    planes = make_planes("YUV420P16", rng, 2, 16, 32)
    cj = vz.Clip.from_planes(planes, vz.get_format("YUV420P16")).device().with_props(
        _ColorRange=np.array([0, 0]), Note="x")
    ct = vt.from_reference([np.asarray(p) for p in cj.planes], "YUV420P16",
                           {k: np.asarray(v) if k == "_ColorRange" else v
                            for k, v in cj.props.items()}, device="cpu")
    assert ct.format == vt.get_format("YUV420P16")
    assert_planes_match(ct.planes, cj.planes)
    assert torch.equal(ct.props["_ColorRange"], torch.tensor([0, 0]))
    assert ct.props["Note"] == "x"
    assert ct.color_range().value == cj.color_range().value


def test_variable_clip_matches():
    rng = np.random.default_rng(8)
    aj, at = both_clips("GRAY8", make_planes("GRAY8", rng, 2, 8, 16))
    bj, bt = both_clips("GRAY16", make_planes("GRAY16", rng, 2, 8, 12))
    table = [(0, 1), (1, 0), (0, 0)]
    vj, vtc = vz.VariableClip([aj, bj], table), vt.VariableClip([at, bt], table)
    assert (vtc.num_frames, vtc.width, vtc.height) == (vj.num_frames, vj.width, vj.height)
    assert not vtc.format and repr(vtc.format) == repr(vj.format)
    assert vt.VariableClip([at, at], table).format == at.format
    for n in range(3):
        assert_planes_match(vtc.get_frame(n).planes, vj.get_frame(n).planes)
    same_error(lambda: vj.planes, lambda: vtc.planes)
    same_error(lambda: vj.format.num_planes, lambda: vtc.format.num_planes)
    same_error(lambda: vz.boxblur(vj), lambda: vt.boxblur(vtc))
    assert vt.WIPED_FORMAT is vtc.format
