"""SSIMULACRA2's building blocks in the port, held against the JAX package:
B13's plain version (``kernels.ssim.ssim_sums_ref``) against
``ssim_sums_pallas(interpret=True)`` for the three (need_ssim, need_err)
combinations and both band heights, the blur and the 2x2 downscale against
the JAX package evaluated op by op (``jax.disable_jit()``), the score on an
RGBS clip and on a clip long enough for two chunks, identical clips, and
every validation message.  The score on YUV and linear inputs is in
tests/test_torch_ssimulacra2_score.py.

Tolerances:
- B13's sums: rtol 1e-4, the JAX package's own bound for its kernel against
  its XLA path (tests/test_kernels_interpret.py): the Pallas kernel in
  interpret mode runs through XLA:CPU, which contracts the blur ladder into
  FMA, and the port rounds every product and sum.
- the blur (``kernels.ssim.blur_1d`` against ``_blur_1d``) and
  ``_downscale2``: bit-exact (``_downscale2`` is
  ``(((a+b)+c)+d)*0.25``, which the jitted JAX function equals too).
- The score: rtol 1e-3 / atol 1e-6, the metric's criterion
  (benchmarks/tpu_parity.py); the measured gap is in each assertion's
  message.  Identical clips: exactly 100.0.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vszip_tpu as vz
import vszip_tpu_torch as vt
from test_torch_core import same_error
from vszip_tpu.kernels.ssim_pallas import ssim_sums_pallas
from vszip_tpu_torch.kernels import ssim as ks

js = importlib.import_module("vszip_tpu.ops.ssimulacra2")
ts = importlib.import_module("vszip_tpu_torch.ops.ssimulacra2")


def score_pair(fmt, n, h, w, seed, props=None):
    """Seeded (reference, distorted) planes: floats in [0, 1) and their
    clip(x + 0.01, 0, 1) (the bench's recipe), or integers and a +-20 LSB
    perturbation."""
    rng = np.random.default_rng(seed)
    f = vz.get_format(fmt)
    if f.sample_type.name == "FLOAT":
        a = [rng.random((n,) + f.plane_dims(w, h, p)[::-1], dtype=np.float32)
             for p in range(f.num_planes)]
        b = [np.clip(p + np.float32(0.01), 0, 1).astype(np.float32) for p in a]
    else:
        peak = (1 << f.bits_per_sample) - 1
        a = [rng.integers(0, peak + 1, (n,) + f.plane_dims(w, h, p)[::-1]).astype(f.storage_dtype)
             for p in range(f.num_planes)]
        b = [np.clip(p.astype(np.int64) + rng.integers(-20, 21, p.shape), 0, peak)
             .astype(f.storage_dtype) for p in a]
    return a, b


def check_score(fmt, n, h, w, seed, props=None):
    """The port's score against the JAX package's; returns the port's."""
    a, b = score_pair(fmt, n, h, w, seed)
    props = props or {}
    want = np.asarray(js.ssimulacra2(vz.Clip.from_planes(a, vz.get_format(fmt), props),
                                     vz.Clip.from_planes(b, vz.get_format(fmt), props)
                                     ).props["SSIMULACRA2"])
    got = ts.ssimulacra2(vt.Clip.from_planes(a, vt.get_format(fmt), props, device="cpu"),
                         vt.Clip.from_planes(b, vt.get_format(fmt), props, device="cpu")
                         ).props["SSIMULACRA2"]
    assert got.dtype == torch.float64 and got.shape == (n,)
    got = got.numpy()
    gap = np.abs(got - want)
    np.testing.assert_allclose(
        got, want, rtol=1e-3, atol=1e-6,
        err_msg=f"max |d| {gap.max():.3e}, max rel {(gap / np.abs(want)).max():.3e}")
    return got


@pytest.mark.parametrize("ns,ne", [(True, True), (True, False), (False, True)], ids=str)
@pytest.mark.parametrize("shape", [(2, 130, 131), (1, 40, 2570)], ids=str)
def test_ssim_sums_plain_matches_pallas(ns, ne, shape):
    rng = np.random.default_rng(5)
    im1 = rng.random(shape, dtype=np.float32)
    im2 = rng.random(shape, dtype=np.float32)
    want = np.asarray(ssim_sums_pallas(jnp.asarray(im1), jnp.asarray(im2), ns, ne,
                                       interpret=True))
    got = ks.ssim_sums(torch.from_numpy(im1), torch.from_numpy(im2), ns, ne)
    assert got.dtype == torch.float64 and got.shape == (shape[0], 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    assert ks.band_rows(shape[2]) == (64 if shape[2] <= 2560 else 32)


def test_band_partials_are_row_order_sums():
    rng = np.random.default_rng(6)
    im1, im2 = (torch.from_numpy(rng.random((1, 70, 33), dtype=np.float32)) for _ in range(2))
    part = ks.ssim_partials_ref(im1, im2, True, True)
    assert part.shape == (1, 2, 6, 33) and part.dtype == torch.float32
    d1, art, det = ks.ssim_maps(im1, im2, True, True)
    acc = det[0, 64]
    for r in range(65, 70):
        acc = acc + det[0, r]
    assert torch.equal(part[0, 1, 4], acc)
    assert torch.equal(ks.ssim_sums_ref(im1, im2, True, True), ks.fold(part))


@pytest.mark.parametrize("h,w", [
    # band edges: one row short of, at and past one and two 64-row bands; a
    # last band of one row; 32-row bands past 2560 columns
    (63, 17), (64, 17), (65, 17), (127, 9), (128, 9), (129, 9), (16, 16), (33, 2561),
    (100, 2600),
], ids=str)
def test_band_partials_are_row_order_sums_at_band_edges(h, w):
    rng = np.random.default_rng(h * 10_000 + w)
    im1, im2 = (torch.from_numpy(rng.random((2, h, w), dtype=np.float32)) for _ in range(2))
    part = ks.ssim_partials_ref(im1, im2, True, True)
    b = ks.band_rows(w)
    assert part.shape == (2, -(-h // b), 6, w) and part.dtype == torch.float32
    maps = ks.ssim_maps(im1, im2, True, True)
    for band in range(part.shape[1]):
        rows = range(band * b, min(h, band * b + b))
        for k, m in enumerate(maps):
            m4 = (m * m) * (m * m)
            for j, v in enumerate((m, m4)):
                acc = v[:, rows[0]]
                for r in rows[1:]:
                    acc = acc + v[:, r]
                # the plain version also adds the band's zero rows past the
                # picture: + 0.0 leaves a sum of maps >= 0 as it is, but
                # turns -0.0 into +0.0 (compared bit for bit)
                want = acc + 0.0 if len(rows) < b else acc
                assert torch.equal(part[:, band, 2 * k + j].view(torch.int32),
                                   want.view(torch.int32)), (band, k, j)


@pytest.mark.parametrize("shape", [(2, 40, 50), (2, 9, 12), (1, 7, 5), (2, 4, 3), (1, 1, 2)],
                         ids=str)
@pytest.mark.parametrize("axis", [1, 2])
def test_blur_1d_equals_strict_jax(shape, axis):
    x = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    with jax.disable_jit():
        want = np.asarray(js._blur_1d(jnp.asarray(x), axis))
    got = ks.blur_1d(torch.from_numpy(x), axis)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 40, 50), (2, 41, 51), (1, 1, 3)], ids=str)
def test_downscale2_equals_jax(shape):
    x = np.random.default_rng(7).random(shape, dtype=np.float32)
    with jax.disable_jit():
        strict = np.asarray(js._downscale2(jnp.asarray(x)))
    jitted = np.asarray(jax.jit(js._downscale2)(jnp.asarray(x)))
    got = ts._downscale2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, strict)
    np.testing.assert_array_equal(got, jitted)


def test_plane_sums_paths_agree():
    # the whole-plane path (sides < 16) and B13's band partials agree to
    # f32 summation order
    rng = np.random.default_rng(8)
    im1, im2 = (torch.from_numpy(rng.random((2, 40, 48), dtype=np.float32)) for _ in range(2))
    band = ks.ssim_sums_ref(im1, im2, True, True)
    whole = torch.stack(ts._plane_sums_xla(im1, im2, True, True), dim=1)
    torch.testing.assert_close(band, whole, rtol=1e-5, atol=0)


def test_rgbs_score_matches_jax():
    check_score("RGBS", 2, 96, 144, 1)


def test_two_chunks_match_one(monkeypatch):
    # three frames in chunks of two: each frame's score is its own
    monkeypatch.setattr(ts, "CHUNK_PIXELS", 2 * 64 * 80)
    got = check_score("RGBS", 3, 64, 80, 2)
    monkeypatch.undo()
    a, b = score_pair("RGBS", 3, 64, 80, 2)
    one = ts.ssimulacra2(vt.Clip.from_planes(a, vt.get_format("RGBS"), device="cpu"),
                         vt.Clip.from_planes(b, vt.get_format("RGBS"), device="cpu"))
    np.testing.assert_array_equal(got, one.props["SSIMULACRA2"].numpy())


@pytest.mark.parametrize("fmt", ["RGBS", "YUV420P8"])
def test_identical_clips_score_exactly_100(fmt):
    a, _ = score_pair(fmt, 2, 70, 90, 3)
    c = vt.Clip.from_planes(a, vt.get_format(fmt), device="cpu")
    out = vt.ssimulacra2(c, c)
    assert out.props["SSIMULACRA2"].tolist() == [100.0, 100.0]
    assert out.planes is c.planes


def test_errors_match_jax():
    def clip(fmt, n=1, h=32, w=32):
        a, _ = score_pair(fmt, n, h, w, 4)
        if fmt == "RGBH":
            a = [p.astype(np.float16) for p in a]
        return (vz.Clip.from_planes(a, vz.get_format(fmt)),
                vt.Clip.from_planes(a, vt.get_format(fmt), device="cpu"))

    for x, y in ((clip("RGBS"), clip("RGBS", h=34)), (clip("RGBS"), clip("RGBS", n=2)),
                 (clip("RGBH"), clip("RGBS")), (clip("RGBS"), clip("RGBH"))):
        same_error(lambda: js.ssimulacra2(x[0], y[0]), lambda: ts.ssimulacra2(x[1], y[1]))
