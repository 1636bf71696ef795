"""EEDI3's kernel functions on the CPU: the plain versions of B8 (non-hp, with
and without the mclip gate), B9 (hp) and B10 (vcheck) held against the JAX
package.

The costs are compared with the JAX package evaluated under
``jax.disable_jit()``, which runs each operation on its own and so rounds as
the reference does; jitted, XLA:CPU contracts parts of the cost and the
4-tap into FMA and differs by ulps.  Against that strict evaluation:
- costs: equal, no tolerance;
- direction paths: equal to the JAX ``_dp`` on the strict costs (zero
  Viterbi argmin flips), on noise and on a smooth ramp with a soft diagonal
  edge, where near-ties occur; and equal to the literal oracle
  ``tests/oracle/eedi3_ref.py`` on tiny crops;
- interpolated lines: rtol 2e-6 / atol 1e-6;
- vcheck: the plain version against ``vcheck_pallas`` in interpret mode and
  the port's ``_vcheck`` against the JAX scan path, rtol 2e-6 / atol 1e-6
  (both JAX paths are jitted, so FMA may move the last bit).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle.eedi3_ref import interp_line_ref
from test_torch_card import smooth_rows
from vszip_tpu_torch import trace
from vszip_tpu_torch.kernels import eedi3 as ke

E = importlib.import_module("vszip_tpu.ops.eedi3")
T = importlib.import_module("vszip_tpu_torch.ops.eedi3")

# the op's scaled coefficients at its defaults: alpha/3, beta/255, gamma/255
# and 1 - alpha - beta from the unscaled pair
COEFS = tuple(float(np.float32(c)) for c in (0.2 / 3, 0.25 / 255, 20.0 / 255))
OMAB = float(np.float32(1.0) - np.float32(0.2) - np.float32(0.25))


def padded_rows(b, l, w, seed, smooth):
    """Four padded neighbour rows, (b, l, w + 192) f32 torch tensors."""
    if smooth:
        rows = smooth_rows(b, l, w, seed)
    else:
        rng = np.random.default_rng(seed)
        rows = [torch.from_numpy(rng.random((b, l, w), dtype=np.float32)) for _ in range(4)]
    return [T._pad_rows(r).contiguous() for r in rows]


def strict_costs(rows, hp, mdis, nrad):
    """The JAX package's cost matrix evaluated op by op."""
    fn = E._costs_hp if hp else E._costs_nonhp
    with jax.disable_jit():
        cs = fn(*[jnp.asarray(r.numpy()) for r in rows], mdis, nrad, *COEFS[:2], OMAB)
        return np.stack([np.asarray(c) for c in cs])


def port_costs(rows, hp, mdis, nrad):
    fn = T._costs_hp if hp else T._costs_nonhp
    return torch.stack(fn(*rows, mdis, nrad, *COEFS[:2], OMAB)).numpy()


CONTENT = [False, True]


@pytest.mark.parametrize("smooth", CONTENT, ids=["noise", "smooth"])
@pytest.mark.parametrize("hp,mdis,nrad", [(False, 4, 2), (False, 6, 3), (True, 3, 1),
                                          (True, 4, 3)], ids=str)
def test_costs_equal_strict_jax(hp, mdis, nrad, smooth):
    rows = padded_rows(2, 3, 70, mdis + nrad, smooth)
    np.testing.assert_array_equal(port_costs(rows, hp, mdis, nrad),
                                  strict_costs(rows, hp, mdis, nrad))


@pytest.mark.parametrize("smooth", CONTENT, ids=["noise", "smooth"])
@pytest.mark.parametrize("hp,mdis,nrad,masked,w", [
    (False, 5, 2, False, 90), (False, 5, 3, True, 90), (True, 3, 2, False, 90),
    (True, 4, 1, True, 90), (False, 20, 2, False, 48)], ids=str)
def test_fpath_zero_flips_against_strict_jax(hp, mdis, nrad, masked, w, smooth):
    rows = padded_rows(2, 4, w, 3 * mdis + nrad, smooth)
    gamma = COEFS[2]
    bm = None
    if masked:
        mask = np.random.default_rng(w).random((2, 4, w)) > 0.35
        bm = torch.from_numpy(mask)
        bmj = jnp.asarray(mask)
    cj = strict_costs(rows, hp, mdis, nrad)
    fj = np.asarray(E._dp(jnp.asarray(cj), bmj if masked else None, gamma, hp))
    jrows = [jnp.asarray(r.numpy()) for r in rows]
    with jax.disable_jit():
        if hp:
            oj = np.asarray(E._output_hp(*jrows, jnp.asarray(fj), w, bmj if masked else None,
                                         mdis))
        else:
            oj = np.asarray(E._output_nonhp(*jrows, jnp.asarray(fj), w, mdis))
    if hp and masked:  # no kernel: the op's plain path
        tc = torch.from_numpy(port_costs(rows, hp, mdis, nrad))
        fp = T._dp(tc, bm, gamma, True)
        out = T._output_hp(*rows, fp, w, bm, mdis)
    elif hp:
        out, fp = ke.eedi3_fused_hp(*rows, w, mdis, nrad, *COEFS, OMAB)
    else:
        out, fp = ke.eedi3_fused(*rows, w, mdis, nrad, *COEFS, OMAB, bm)
    assert fp.dtype == torch.int32 and out.dtype == torch.float32
    np.testing.assert_array_equal(fp.numpy(), fj)
    np.testing.assert_allclose(out.numpy(), oj, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hp", [False, True])
def test_fpath_ties_follow_the_reference_order(hp, masked):
    """Flat content (a black border) with beta = gamma = 0: every candidate
    ties, so the path is the candidate order alone (non-hp starts from the
    centre and keeps it; hp starts from -2)."""
    w, mdis, nrad = 48, 4, 2
    row = np.zeros((2, 3, w), np.float32)
    row[..., w // 2:] = np.random.default_rng(4).random((2, 3, w - w // 2), dtype=np.float32)
    rows = [T._pad_rows(torch.from_numpy(row.copy())).contiguous() for _ in range(4)]
    alpha = COEFS[0]
    fn = E._costs_hp if hp else E._costs_nonhp
    with jax.disable_jit():
        cj = np.stack([np.asarray(c) for c in fn(
            *[jnp.asarray(r.numpy()) for r in rows], mdis, nrad, alpha, 0.0, OMAB)])
    mask = np.random.default_rng(6).random((2, 3, w)) > 0.3 if masked else None
    fj = np.asarray(E._dp(jnp.asarray(cj), None if mask is None else jnp.asarray(mask), 0.0, hp))
    bm = None if mask is None else torch.from_numpy(mask)
    if hp and masked:
        fp = T._dp(torch.from_numpy(cj), bm, 0.0, True)
    elif hp:
        fp = ke.eedi3_fused_hp(*rows, w, mdis, nrad, alpha, 0.0, 0.0, OMAB)[1]
    else:
        fp = ke.eedi3_fused(*rows, w, mdis, nrad, alpha, 0.0, 0.0, OMAB, bm)[1]
    np.testing.assert_array_equal(fp.numpy(), fj)


@pytest.mark.parametrize("smooth", CONTENT, ids=["noise", "smooth"])
@pytest.mark.parametrize("hp,mdis,nrad", [(False, 3, 2), (True, 2, 1), (False, 4, 0)], ids=str)
def test_lines_match_literal_oracle(hp, mdis, nrad, smooth):
    w = 28
    rows = padded_rows(1, 2, w, 11, smooth)
    out, fp = (ke.eedi3_fused_hp(*rows, w, mdis, nrad, *COEFS, OMAB) if hp else
               ke.eedi3_fused(*rows, w, mdis, nrad, *COEFS, OMAB))
    for li in range(2):
        ref_out, ref_fp = interp_line_ref(*[r[0, li].numpy() for r in rows], w, mdis, nrad,
                                          *COEFS, np.float32(OMAB), hp=hp)
        np.testing.assert_array_equal(fp[0, li].numpy(), ref_fp)
        np.testing.assert_allclose(out[0, li].numpy(), ref_out, rtol=2e-6, atol=1e-6)


def vcheck_inputs(hp, seed, n_off=7, b=8, w=64, mdis=4):
    rng = np.random.default_rng(seed)
    drange = 2 * mdis if hp else mdis
    f = lambda *s: rng.random(s, dtype=np.float32)  # noqa: E731
    return (f(n_off, b, w), f(n_off, 3, b, w),
            rng.integers(-drange, drange + 1, (n_off, 3, b, w)).astype(np.int32),
            f(n_off, b, w), f(b, w), w, mdis)


RCP = tuple(float(np.float32(v)) for v in (1.0 / (32.0 / 255.0), 1.0 / (64.0 / 255.0),
                                            1.0 / 4.0, 4.0))


@pytest.mark.parametrize("vcheck", [1, 2, 3])
@pytest.mark.parametrize("hp", [False, True])
def test_vcheck_plain_matches_pallas_interpret(hp, vcheck):
    KV = importlib.import_module("vszip_tpu.kernels.vcheck_pallas")
    dl, nb, dm, cint, init, w, mdis = vcheck_inputs(hp, 3 * vcheck + hp)
    want = np.asarray(KV.vcheck_pallas(*map(jnp.asarray, (dl, nb, dm, cint, init)), w, mdis,
                                       hp, vcheck, *RCP, interpret=True))
    got = ke.vcheck(*map(torch.from_numpy, (dl, nb, dm, cint, init)), w, mdis, hp, vcheck,
                    *RCP)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("hp,vcheck,use_scp,dh,field", [
    (False, 1, False, False, 1), (False, 2, False, False, 1), (False, 3, False, False, 1),
    (True, 1, False, False, 1), (True, 2, False, False, 1), (True, 3, False, False, 1),
    (False, 2, True, True, 0), (False, 2, True, False, 0), (True, 2, False, True, 1),
    (False, 3, False, True, 0)], ids=str)
def test_vcheck_matches_jax_scan(monkeypatch, hp, vcheck, use_scp, dh, field):
    rng = np.random.default_rng(7 + vcheck + 10 * hp + dh)
    B, W, mdis = 2, 120, 4
    n_src = 6 if dh else 12
    n_interp = n_src if dh else n_src // 2
    n_dst = n_src * 2 if dh else n_src
    src = rng.random((B, n_src, W), dtype=np.float32)
    dst = rng.random((B, n_dst, W), dtype=np.float32)
    drange = 2 * mdis if hp else mdis
    dmap = rng.integers(-drange, drange + 1, (B, n_interp, W)).astype(np.int32)
    scp = rng.random((B, n_dst, W), dtype=np.float32) if use_scp else None
    rest = (field, n_interp, n_dst, n_src, dh, hp, vcheck, 32.0, 64.0, 4.0, W, mdis)

    monkeypatch.setattr(E, "_dp_on_tpu", lambda: False)
    want = np.asarray(E._vcheck(jnp.asarray(src), jnp.asarray(dst),
                                None if scp is None else jnp.asarray(scp),
                                jnp.asarray(dmap), *rest))
    got = T._vcheck(torch.from_numpy(src), torch.from_numpy(dst),
                    None if scp is None else torch.from_numpy(scp),
                    torch.from_numpy(dmap), *rest)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-6)


def test_plain_versions_launch_nothing():
    rows = padded_rows(1, 2, 40, 0, False)
    trace.reset_launches()
    ke.eedi3_fused(*rows, 40, 3, 1, *COEFS, OMAB)
    ke.eedi3_fused_hp(*rows, 40, 3, 1, *COEFS, OMAB)
    ke.vcheck(*map(torch.from_numpy, vcheck_inputs(False, 0)[:5]), 64, 4, False, 2, *RCP)
    assert ke.LAUNCHES == {"eedi3_fused": 0, "eedi3_fused_hp": 0, "vcheck": 0}


def test_wrappers_refuse_a_device_without_kernel():
    rows = [r.to("meta") for r in padded_rows(1, 1, 8, 0, False)]
    with pytest.raises(ValueError, match="no EEDI3 kernel"):
        ke.eedi3_fused(*rows, 8, 3, 1, *COEFS, OMAB)
    with pytest.raises(ValueError, match="no vcheck kernel"):
        ke.vcheck(*[torch.empty(s, device="meta") for s in
                    ((1, 1, 8), (1, 3, 1, 8), (1, 3, 1, 8), (1, 1, 8), (1, 8))],
                  8, 3, False, 2, *RCP)

