"""BilateralDither's host point lists and kernels B17/B18 of the PyTorch port
held against vszip_tpu.

- ``generate`` and ``rnd_row_values`` of the port's copy equal the JAX
  package's: the spiral lists, and the void-and-cluster path at r = 7,
  subspl 4 (a size-19 matrix; the size-32 one takes 17 s per package).
- The plain versions ``dense_blur_ref`` and ``subspl_blur_ref`` equal
  ``dense_blur_pallas`` and ``subspl_blur_pallas`` run in interpret mode, for
  r <= 32 (the Pallas kernels' limit), u8/u16/f32 outputs, with and without
  a joint ref, the sub-sampled kernel in its static and its rolled form.
- Both equal the literal per-pixel oracle of tests/test_bilateral_dither.py
  on a seeded 20x24 plane.
- The wrappers take the plain versions on CPU tensors and count nothing.

Tolerance: bit-exact, except f32 outputs against the Pallas kernels in
interpret mode, which are held at rtol 2e-6: XLA:CPU compiles the
interpreted kernel body and contracts ``s + (v - cen) * w`` into an FMA
(a NumPy emulation with that FMA equals the interpreted output; the strict
one differs from it by 1 ulp in a few pixels), while the reference, the
CUDA kernels and the plain versions round the product first.  The plain
versions' f32 outputs are bit-exact against the literal oracle.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_bilateral_dither import _oracle
from vszip_tpu.ops import bilateral_dither_points as jpts
from vszip_tpu_torch import trace
from vszip_tpu_torch.kernels import bilateral_dither as kb
from vszip_tpu_torch.ops import bilateral_dither_points as tpts

jbd = importlib.import_module("vszip_tpu.ops.bilateral_dither")
tbd = importlib.import_module("vszip_tpu_torch.ops.bilateral_dither")

# (m, wmax, swmin, peak) of an 8-bit and a 16-bit plane at thr 8, flat 0.4, and
# of a float plane at thr 16, rounded to f32 as the op rounds them
PARAMS = {dt: tuple(float(np.float32(v)) for v in vals) for dt, vals in (
    (torch.uint8, (8.0, 4.8, 1.0, 255.0)), (torch.uint16, (2048.0, 1228.8, 1.0, 65535.0)),
    (torch.float32, (0.0625, 0.0375, 1 / 65535, 0.0)))}


@pytest.fixture
def interp(monkeypatch):
    import jax.experimental.pallas as plmod

    from vszip_tpu.kernels import bilateral_dither_pallas as kp

    orig = plmod.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(kp.pl, "pallas_call", interp_call)
    return kp


def smooth_plane(dtype, n, h, w, seed):
    """A smooth gradient quantised into 8-bit steps plus noise of one step,
    so that most taps get a weight between 0 and wmax."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = 0.3 + 0.4 * np.sin(x / 7.0 + y / 11.0) ** 2
    if dtype == torch.float32:
        v = np.floor(base * 256) / 256 + rng.uniform(-1 / 256, 1 / 256, (n, h, w))
        return v.astype(np.float32)
    peak = 255 if dtype == torch.uint8 else 65535
    step = (peak + 1) // 256
    v = (base * peak) // step * step + rng.integers(-step, step + 1, (n, h, w))
    return np.clip(v, 0, peak).astype(np.uint8 if dtype == torch.uint8 else np.uint16)


# ---------------------------------------------------------------------------
# host point lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,subspl", [(2, 0.0), (3, 1.0), (4, 0.0), (6, 8.0), (8, 0.0),
                                      (16, 0.0), (32, 200.0), (64, 4096.0), (7, 4.0)], ids=str)
def test_generate_matches_jax(r, subspl):
    got, k = tpts.generate(r, r, subspl)
    want, kj = jpts.generate(r, r, subspl)
    assert k == kj and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # every offset within +-(r-1): flat addressing equals 2-D addressing
    assert np.abs(got).max() <= r - 1


def test_row_values_and_start_rows_match_jax():
    np.testing.assert_array_equal(tpts.rnd_row_values(1081), jpts.rnd_row_values(1081))
    start = tbd._start_rows(37, "cpu")
    assert start.dtype == torch.int32
    lid = kb.list_ids(start, 53).numpy()
    np.testing.assert_array_equal(lid, jbd._list_ids(53, 37))


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

CASES = [(2, torch.uint8, False), (2, torch.float32, True), (5, torch.uint16, False),
         (8, torch.uint16, True), (8, torch.float32, False), (16, torch.uint8, True),
         (32, torch.uint16, False)]


def _inputs(r, dtype, has_ref, seed):
    n, h, w = 2, max(r, 21), max(r, 19) + 17
    x = smooth_plane(dtype, n, h, w, seed)
    ref = smooth_plane(dtype, n, h, w, seed + 1) if has_ref else None
    return x, ref


def _pads(x, ref, r):
    return (jbd._pad_cache(jnp.asarray(x), r, r),
            None if ref is None else jbd._pad_cache(jnp.asarray(ref), r, r))


def _tensors(x, ref):
    return torch.from_numpy(x), None if ref is None else torch.from_numpy(ref)


def _assert_matches_interpret(got, want):
    if want.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r,dtype,has_ref", CASES, ids=str)
def test_dense_plain_matches_pallas(interp, r, dtype, has_ref):
    x, ref = _inputs(r, dtype, has_ref, r)
    m, wmax, swmin, peak = PARAMS[dtype]
    want = np.asarray(interp.dense_blur_pallas(*_pads(x, ref, r), r, r, m, wmax, swmin, peak,
                                               dtype != torch.float32, x.dtype))
    got = kb.dense_blur_ref(*_tensors(x, ref), r, m, wmax, swmin, peak)
    assert got.dtype == dtype
    _assert_matches_interpret(got.numpy(), want)
    assert (got.numpy() != x).mean() > 0.1


# the static (unrolled) form compiles for seconds per case at r >= 16
@pytest.mark.parametrize("r,dtype,has_ref,static",
                         [c + (False,) for c in CASES] + [c + (True,) for c in CASES[:5]],
                         ids=str)
def test_subspl_plain_matches_pallas(interp, r, dtype, has_ref, static):
    x, ref = _inputs(r, dtype, has_ref, 10 + r)
    subspl = 200.0 if r == 32 else 0.0  # spiral lists (VNC at r = 32 takes 17 s)
    pts, k = tpts.generate(r, r, subspl)
    h, w = x.shape[1:]
    m, wmax, swmin, peak = PARAMS[dtype]
    dyx = jnp.asarray(np.stack([pts[:, :, 0], pts[:, :, 1]]).astype(np.int32))
    spts = tuple(tuple((int(a), int(b)) for a, b in lst) for lst in pts) if static else None
    want = np.asarray(interp.subspl_blur_pallas(
        *_pads(x, ref, r), jnp.asarray(jbd._list_ids(w, h)[None]), dyx, r, r, m, wmax,
        swmin, peak, dtype != torch.float32, x.dtype, static_pts=spts))
    got = kb.subspl_blur_ref(*_tensors(x, ref), r, tbd._start_rows(h, "cpu"),
                             torch.from_numpy(pts.astype(np.int16)), m, wmax, swmin, peak)
    assert got.dtype == dtype
    _assert_matches_interpret(got.numpy(), want)
    assert (got.numpy() != x).mean() > 0.1


# ---------------------------------------------------------------------------
# the literal oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,has_ref", [(torch.uint8, False), (torch.uint16, False),
                                           (torch.float32, False), (torch.uint16, True)],
                         ids=str)
@pytest.mark.parametrize("path", ["dense", "subspl"])
def test_plain_versions_match_literal_oracle(dtype, has_ref, path):
    r = 3 if path == "dense" else 4
    x, ref = (smooth_plane(dtype, 1, 20, 24, s)[0] for s in (7, 8))
    ref = ref if has_ref else None
    m, wmax, swmin, peak = PARAMS[dtype]
    xt, rt = (None if a is None else torch.from_numpy(a)[None] for a in (x, ref))
    if path == "dense":
        got = kb.dense_blur_ref(xt, rt, r, m, wmax, swmin, peak)
        want = _oracle(x, ref, r, m, wmax, swmin, peak, dtype != torch.float32)
    else:
        pts, k = tpts.generate(r, r, 0.0)
        got = kb.subspl_blur_ref(xt, rt, r, tbd._start_rows(20, "cpu"),
                                 torch.from_numpy(pts.astype(np.int16)), m, wmax, swmin, peak)
        want = _oracle(x, ref, r, m, wmax, swmin, peak, dtype != torch.float32, pts=pts, k=k)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_wrappers_take_plain_versions_on_cpu():
    trace.reset_launches()
    x = torch.from_numpy(smooth_plane(torch.uint16, 1, 20, 24, 3))
    m, wmax, swmin, peak = PARAMS[torch.uint16]
    pts, _ = tpts.generate(4, 4, 0.0)
    dyx, start = torch.from_numpy(pts.astype(np.int16)), tbd._start_rows(20, "cpu")
    assert torch.equal(kb.dense_blur(x, None, 4, m, wmax, swmin, peak),
                       kb.dense_blur_ref(x, None, 4, m, wmax, swmin, peak))
    assert torch.equal(kb.subspl_blur(x, x, 4, start, dyx, m, wmax, swmin, peak),
                       kb.subspl_blur_ref(x, x, 4, start, dyx, m, wmax, swmin, peak))
    assert kb.LAUNCHES == {"dense_blur": 0, "subspl_blur": 0}
