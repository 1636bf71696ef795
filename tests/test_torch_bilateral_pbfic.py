"""The port's Bilateral algorithm 1 (PBFIC) held against the JAX package on
seeded planes, on the CPU: integer, half and single formats, PBFICnum auto
and its odd chroma rule, a joint ``ref`` with more frames than the clip (both
algorithms), the bracket search and values outside the levels.  The
contract and why outputs differ: ``test_torch_bilateral.py``.
"""

import numpy as np
import pytest
import torch
from test_torch_bilateral import FORMATS, clips, hold, strict
from test_torch_core import both_clips

import vszip_tpu_torch as vt
from vszip_tpu.ops.bilateral import bilateral as jb


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("args", [
    {"sigmaS": 2, "sigmaR": 0.1, "algorithm": 1},
    {"sigmaS": 3, "sigmaR": 0.02, "algorithm": 1},
], ids=str)
def test_pbfic_matches_jitted_and_strict(fmt, args):
    """Held against the jitted package, and at the 4-level setting against
    its strict evaluation on one small frame (its scans run op by op)."""
    jc, tc = clips(fmt, 1)
    hold(vt.bilateral(tc, **args), jb(jc, **args), 1)
    if args["sigmaR"] >= 0.08:
        jc, tc = clips(fmt, 1, n=1, h=12, w=16)
        hold(vt.bilateral(tc, **args), strict(jc, args), 1)


@pytest.mark.parametrize("fmt,args", [
    ("YUV420P16", {"sigmaR": 0.1}),             # PBFICnum 4, chroma 5
    ("YUV420P16", {"sigmaR": 0.03}),            # 11 (odd): chroma stays 11
    ("YUV420P8", {"sigmaR": 0.01}),             # 24, chroma 25
    ("YUV444P16", {"sigmaR": 0.05}),            # 6, chroma 7
    ("YUV420P16", {"sigmaR": 0.1, "PBFICnum": [6, 256]}),
    ("RGB24", {"sigmaR": 0.1}),                 # RGB: no odd rule
], ids=str)
def test_pbficnum_auto_and_the_odd_chroma_rule(fmt, args):
    """PBFICnum's derivation does not depend on sigmaS; algorithm 1 forced,
    on one small frame, against the jitted package (the strict scans over up
    to 256 levels take minutes)."""
    args = dict(args, sigmaS=3.0, algorithm=1)
    jc, tc = clips(fmt, 3, n=1, h=16, w=24)
    hold(vt.bilateral(tc, **args), jb(jc, **args), 1)


@pytest.mark.parametrize("fmt", ["GRAY16", "YUV420P8", "GRAYS"])
@pytest.mark.parametrize("alg", [1, 2])
def test_joint_ref_with_more_frames(fmt, alg):
    jc, tc = clips(fmt, 5)
    jr, tr = clips(fmt, 6, n=4)
    args = {"sigmaS": 2, "sigmaR": 0.1, "algorithm": alg}
    got = vt.bilateral(tc, ref=tr, **args)
    hold(got, jb(jc, ref=jr, **args), alg)
    alone = vt.bilateral(tc, **args)
    assert not all(torch.equal(a, b) for a, b in zip(got.planes, alone.planes))


def test_pbfic_bracket_is_the_reference_loop():
    """The bracket search against the reference's loop: the first k in
    0..num-3 with pb[k] <= ref < pb[k+1], else num-2 (NaN, values below the
    first level and at or above pb[num-2] too)."""
    from vszip_tpu_torch.ops.bilateral import _bracket

    for num in (2, 3, 4, 17):
        pb = (np.arange(num) / np.float64(num - 1)).astype(np.float32)
        ref = np.concatenate([pb, pb - np.float32(1e-7), pb + np.float32(1e-7),
                              np.float32([-0.5, -0.0, 1.5, np.nan, np.inf, -np.inf]),
                              np.random.default_rng(num).random(200, dtype=np.float32)])
        want = np.full(ref.shape, num - 2)
        for k in range(num - 3, -1, -1):
            want = np.where((ref < pb[k + 1]) & (ref >= pb[k]), k, want)
        got = _bracket(torch.from_numpy(pb), torch.from_numpy(ref), num)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_pbfic_takes_values_outside_the_levels():
    """Float planes below 0 and above 1 take the last bracket, as in the
    JAX package (held against its strict evaluation)."""
    x = np.random.default_rng(10).random((1, 12, 16), dtype=np.float32)
    x[0, 3, 4], x[0, 5, 6], x[0, 9, 9] = -0.25, 1.5, 1.0
    jc, tc = both_clips("GRAYS", [x])
    args = {"sigmaS": 2.0, "sigmaR": 0.1, "algorithm": 1}
    hold(vt.bilateral(tc, **args), strict(jc, args), 1)
