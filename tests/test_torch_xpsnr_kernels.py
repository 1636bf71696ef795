"""XPSNR's block-statistics kernels in the port, held against the JAX
package: the plain versions of ``luma_stats`` (B11) and ``chroma_sse`` (B12)
against ``luma_stats_pallas``/``chroma_sse_pallas`` run in interpret mode,
on a (3, 150, 256) luma plane (a ragged last band) with order 1 and 2 and
temporal on and off, and a (3, 75, 128) chroma plane with 32x32 and 16x32
blocks; the wrappers' dispatch on the CPU and on a device without a kernel.

The CUDA kernels themselves are held against these plain versions on the
card, in tests/test_torch_card.py and chip_smoke.py.

Tolerance: bit-exact (every value is an exact integer sum).
"""

import jax.experimental.pallas as plmod
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vszip_tpu.kernels import xpsnr_pallas as kp
from vszip_tpu_torch import trace
from vszip_tpu_torch.kernels import xpsnr as kx


@pytest.fixture
def interpret(monkeypatch):
    orig = plmod.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(kp.pl, "pallas_call", interp_call)


def _planes(shape, seed, peak=1024):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, peak, shape, dtype=np.uint16),
            rng.integers(0, peak, shape, dtype=np.uint16))


@pytest.mark.parametrize("order,temporal", [(1, True), (2, True), (1, False)], ids=str)
def test_luma_stats_plain_matches_pallas(interpret, order, temporal):
    org, rec = _planes((3, 150, 256), 11)
    want = kp.luma_stats_pallas(jnp.asarray(org), jnp.asarray(rec), order, temporal, 4)
    got = kx.luma_stats(torch.from_numpy(org), torch.from_numpy(rec), order, temporal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("by,bx", [(32, 32), (16, 32)], ids=str)
def test_chroma_sse_plain_matches_pallas(interpret, by, bx):
    org, rec = _planes((3, 75, 128), 12)
    want = kp.chroma_sse_pallas(jnp.asarray(org), jnp.asarray(rec), by, bx, 4)
    got = kx.chroma_sse(torch.from_numpy(org), torch.from_numpy(rec), by, bx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_luma_stats_8bit_and_one_frame(interpret):
    # uint8 planes, and a clip shorter than the second-order history
    org, rec = (a.astype(np.uint8) for a in _planes((1, 64, 70), 13, 256))
    want = kp.luma_stats_pallas(jnp.asarray(org), jnp.asarray(rec), 2, True, 2)
    got = kx.luma_stats(torch.from_numpy(org), torch.from_numpy(rec), 2, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrappers_take_plain_version_on_cpu_without_counting():
    org, rec = (torch.from_numpy(a) for a in _planes((2, 70, 130), 14))
    trace.reset_launches()
    got = kx.luma_stats(org, rec, 1, True)
    want = kx.luma_stats_ref(org, rec, 1, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(kx.chroma_sse(org, rec, 32, 32), kx.chroma_sse_ref(org, rec, 32, 32))
    assert set(kx.LAUNCHES.values()) == {0}


def test_wrappers_raise_on_other_devices():
    x = torch.empty((1, 64, 64), dtype=torch.uint16, device="meta")
    for fn in (lambda: kx.luma_stats(x, x, 1, True), lambda: kx.chroma_sse(x, x, 32, 32)):
        with pytest.raises(ValueError, match="no XPSNR kernel for device meta"):
            fn()
    assert set(kx.LAUNCHES.values()) == {0}
