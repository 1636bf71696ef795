"""B14's plain version (``kernels/compress.py``) against the Pallas kernel
``compress_plane_pallas`` in interpret mode (the narrow regimes, the only
ones it takes; the shapes of tests/test_kernels_interpret.py) and against
the literal per-block oracle ``tests/oracle/compress_ref.py`` (narrow and
wide regimes), plus the wrapper's device dispatch.

Tolerance: bit-exact everywhere (uint8 planes).
"""

import importlib

import numpy as np
import pytest
import torch

from oracle.compress_ref import compress_block_ref
from vszip_tpu_torch import trace
from vszip_tpu_torch.kernels import compress as kz

tcomp = importlib.import_module("vszip_tpu_torch.ops.compress")
jcomp = importlib.import_module("vszip_tpu.ops.compress")


@pytest.fixture
def interp(monkeypatch):
    from vszip_tpu.kernels import compress_pallas as kp

    orig = kp.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(kp.pl, "pallas_call", interp_call)
    return kp


def _plain(x, codec, qscale=8, dc_prec=0, quality=50, chroma=False):
    qa, qb, wide, _ = tcomp._quant_setup(codec, qscale, dc_prec, quality, chroma)
    return kz.compress_plane(torch.from_numpy(x), qa, qb, codec == "jpeg", dc_prec,
                             wide).numpy(), wide


@pytest.mark.parametrize("codec,kw", [("mpeg2", dict(qscale=8, dc_prec=0)),
                                      ("mpeg2", dict(qscale=4, dc_prec=2)),
                                      ("mpeg2", dict(qscale=3, dc_prec=3)),
                                      ("jpeg", dict(quality=50)),
                                      ("jpeg", dict(quality=10)),
                                      ("jpeg", dict(quality=77))], ids=str)
def test_plain_matches_pallas_interpret(interp, codec, kw):
    import jax.numpy as jnp

    kp = interp
    rng = np.random.default_rng(3)
    h, w = 2 * kp.BH, 128
    x = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    qscale, dc_prec, quality = kw.get("qscale", 8), kw.get("dc_prec", 0), kw.get("quality", 50)
    qa64, qb64, wide, consts = jcomp._quant_setup(codec, qscale, dc_prec, quality, False)
    assert not wide
    level = 128 if codec == "jpeg" else 0
    qa_t = jnp.asarray(jcomp._tile_plane(qa64, kp.BH, w, np.int32)[0])
    qb_t = jnp.asarray(jcomp._tile_plane(qb64, kp.BH, w, np.int32)[0])
    want = np.asarray(kp.compress_plane_pallas(jnp.asarray(x), qa_t, qb_t, codec, consts,
                                               level))
    got, _ = _plain(x, codec, qscale, dc_prec, quality)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("codec,kw", [("mpeg2", dict(qscale=8)), ("mpeg2", dict(qscale=1)),
                                      ("mpeg2", dict(qscale=2, dc_prec=3)),
                                      ("mpeg2", dict(qscale=31, dc_prec=1)),
                                      ("jpeg", dict(quality=25)), ("jpeg", dict(quality=95)),
                                      ("jpeg", dict(quality=100, chroma=True)),
                                      ("jpeg", dict(quality=1, chroma=True))], ids=str)
def test_plain_matches_block_oracle(codec, kw):
    """Every 8x8 block of a plane (noise, flat, ramps and saturated blocks),
    both regimes: qscale 1/2 and quality 95/100 are wide."""
    rng = np.random.default_rng(len(str(kw)))
    x = rng.integers(0, 256, (1, 24, 32), dtype=np.uint8)
    x[0, :8, :8] = 255
    x[0, :8, 8:16] = 0
    x[0, 8:16, :8] = np.arange(8, dtype=np.uint8)[None, :] * 36
    x[0, 8:16, 8:16] = 77
    x[0, 16:24, :8] = np.tile(np.array([0, 255], np.uint8), (8, 4))
    got, wide = _plain(x, codec, **kw)
    assert wide == (kw.get("qscale", 8) <= 2 if codec == "mpeg2"
                    else kw["quality"] >= (87 if kw.get("chroma") else 78))
    args = dict(qscale=kw.get("qscale", 8), dc_prec=kw.get("dc_prec", 0),
                quality=kw.get("quality", 50), is_chroma=kw.get("chroma", False))
    for by in range(0, 24, 8):
        for bx in range(0, 32, 8):
            want = compress_block_ref(x[0, by:by + 8, bx:bx + 8], codec, **args)
            np.testing.assert_array_equal(got[0, by:by + 8, bx:bx + 8], want,
                                          err_msg=f"block ({by}, {bx})")


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    trace.reset_launches()
    x = np.random.default_rng(1).integers(0, 256, (2, 11, 13), dtype=np.uint8)
    got, _ = _plain(x, "mpeg2")
    assert got.shape == x.shape and got.dtype == np.uint8
    assert kz.LAUNCHES == {"compress_plane": 0}


def test_wrapper_raises_on_other_devices():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8, device="meta")
    qa, qb, _, _ = tcomp._quant_setup("mpeg2", 8, 0, 50, False)
    with pytest.raises(ValueError, match="no Compress kernel"):
        kz.compress_plane(x, qa, qb, False, 0, False)
