"""The port's VCL2 transcendentals (vszip_tpu_torch/ops/vcl.py) against
vszip_tpu.ops.vcl on seeded inputs.

Tolerance: within 2 ulp.  Reason: XLA:CPU may contract the JAX polynomials'
``a*b + c`` into FMA, and the port rounds each product on its own.  The
port's rounding helper, which has no product to contract, must agree
exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vszip_tpu.ops import vcl as jvcl
from vszip_tpu_torch.ops import vcl as tvcl


def assert_ulp(got: torch.Tensor, want, max_ulp=2):
    g = got.numpy()
    w = np.asarray(want)
    assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    ulp = np.abs(g.view(np.int32).astype(np.int64) - w.view(np.int32).astype(np.int64))
    assert (same | ((np.sign(g) == np.sign(w)) & (ulp <= max_ulp))).all(), ulp.max()


def _inputs(seed, lo, hi, n=4096):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, n).astype(np.float32)


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (-60.0, 60.0), (-1e6, 1e6)], ids=str)
def test_atan_matches_jax(lo, hi):
    x = _inputs(1, lo, hi)
    x[:6] = [0.0, -0.0, np.sqrt(2) - 1, -(np.sqrt(2) + 1), 1e30, -1e-30]
    assert_ulp(tvcl.atan(torch.from_numpy(x)), jvcl.atan(jnp.asarray(x)))


@pytest.mark.parametrize("y", [0.1, 0.5, 2.0, -1.5, 0.0])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 40.0)], ids=str)
def test_pow_matches_jax(lo, hi, y):
    x = _inputs(2, lo, hi)
    x[:4] = [0.0, 1.0, 1e-39, 0.5]  # zero, one, a denormal (treated as zero)
    assert_ulp(tvcl.pow_(torch.from_numpy(x), y), jvcl.pow_(jnp.asarray(x), y))


def test_pow_deband_products():
    # the soft blend's products of four gates in [0, 1]
    rng = np.random.default_rng(3)
    x = np.prod(rng.uniform(0, 1, (4, 8192)).astype(np.float32), axis=0)
    assert_ulp(tvcl.pow_(torch.from_numpy(x), 0.1), jvcl.pow_(jnp.asarray(x), 0.1))


@pytest.mark.parametrize("lo,hi", [(-8.0, 8.0), (-1e4, 1e4), (1e-30, 1e-20)], ids=str)
def test_cbrt_matches_jax(lo, hi):
    x = _inputs(4, lo, hi)
    x[:3] = [0.0, -0.0, 1e-39]  # |x| <= 2^-126 underflows to 0
    assert_ulp(tvcl.cbrt(torch.from_numpy(x)), jvcl.cbrt(jnp.asarray(x)))


def test_round_half_away_matches_jax():
    x = np.array([0.5, -0.5, 1.5, -2.5, 2.4999998, 0.49999997, -7.0, 3.2], np.float32)
    got = tvcl._round_half_away(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jvcl._round_half_away(jnp.asarray(x))))
