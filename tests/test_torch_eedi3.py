"""vszip_tpu_torch.eedi3/eedi3h held against vszip_tpu.eedi3/eedi3h (jitted,
on the CPU) on seeded noise clips: fields 0-3, dh, hp, mclip (non-hp and
hp), sclip, vcheck 0-3, other coefficients, gray and 4:2:0/4:4:4 float
formats, the default mdis=20 at a narrow width; and every validation
message.  On the CPU the port runs the kernels' plain versions.

Tolerance: max |d| < 2e-6 on every plane (the ROADMAP's EEDI3 criterion).
The port rounds each f32 operation on its own, as the reference does;
XLA:CPU contracts parts of the JAX package's cost and 4-tap into FMA, which
moves the last bits.  On noise that never flips a Viterbi decision (the
direction paths themselves are held to the strict evaluation, zero flips,
in test_torch_eedi3_kernels.py).
"""

import numpy as np
import pytest

import vszip_tpu as vz
import vszip_tpu_torch as vt
from test_torch_core import both_clips, make_planes, same_error

CASES = [
    ("eedi3", "GRAYS", {"field": 0, "mdis": 4}),
    ("eedi3", "GRAYS", {"field": 1, "mdis": 4, "nrad": 3, "vcheck": 0}),
    ("eedi3", "YUV420PS", {"field": 2, "mdis": 3}),
    ("eedi3", "GRAYS", {"field": 3, "mdis": 3, "vcheck": 1}),
    ("eedi3", "GRAYS", {"field": 1, "dh": True, "mdis": 3, "vcheck": 3}),
    ("eedi3", "GRAYS", {"field": 0, "dh": True, "mdis": 5, "hp": True}),
    ("eedi3", "GRAYS", {"field": 1, "hp": True, "mdis": 3, "nrad": 1}),
    ("eedi3", "GRAYS", {"field": 1, "mdis": 4, "nrad": 0, "alpha": 0.4, "beta": 0.3,
                        "gamma": 40.0, "vthresh0": 20.0, "vthresh2": 2.0}),
    ("eedi3", "GRAYS", {"field": 1, "mdis": 4, "gamma": 0.0, "vcheck": 3}),
    ("eedi3", "YUV420PS", {"field": 1, "mdis": 3, "mclip": True}),
    ("eedi3", "GRAYS", {"field": 0, "mdis": 3, "hp": True, "mclip": True}),
    ("eedi3", "GRAYS", {"field": 1, "mdis": 3, "sclip": True}),
    ("eedi3", "GRAYS", {"field": 2, "mdis": 3, "sclip": True, "vcheck": 1}),
    ("eedi3", "GRAYS", {"field": 1, "dh": True}),
    ("eedi3h", "GRAYS", {"field": 1, "mdis": 3}),
    ("eedi3h", "YUV444PS", {"field": 0, "dh": True, "hp": True, "mdis": 3}),
    ("eedi3h", "GRAYS", {"field": 3, "mdis": 3, "mclip": True, "vcheck": 2}),
]


def _run_both(fn, fmt, args, seed, n=2, h=24, w=48):
    rng = np.random.default_rng(seed)
    cj, ct = both_clips(fmt, make_planes(fmt, rng, n, h, w))
    aj, at = dict(args), dict(args)
    if args.get("mclip"):
        m = (rng.random((n, h, w)) > 0.4).astype(np.uint8) * 255
        aj["mclip"], at["mclip"] = both_clips("GRAY8", [m])
    if args.get("sclip"):
        sn = 2 * n if args["field"] > 1 else n
        sh = 2 * h if args.get("dh") else h
        aj["sclip"], at["sclip"] = both_clips(fmt, make_planes(fmt, rng, sn, sh, w))
    return getattr(vt, fn)(ct, **at), getattr(vz, fn)(cj, **aj), ct


@pytest.mark.parametrize("fn,fmt,args", CASES, ids=str)
def test_eedi3_matches_jax(fn, fmt, args):
    got, want, ct = _run_both(fn, fmt, args, CASES.index((fn, fmt, args)))
    assert got.format == ct.format and got.props["_FieldBased"] == 0
    assert got.num_frames == want.num_frames and (got.width, got.height) == (want.width,
                                                                           want.height)
    for g, w in zip(got.planes, want.planes):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.abs(g - w).max() < 2e-6


def test_eedi3_errors():
    rng = np.random.default_rng(0)
    cj, ct = both_clips("GRAYS", make_planes("GRAYS", rng, 2, 24, 48))
    oj, ot = both_clips("GRAYS", make_planes("GRAYS", rng, 2, 23, 47))
    ij, it = both_clips("GRAY8", make_planes("GRAY8", rng, 2, 24, 48))
    yj, yt = both_clips("YUV420P8", make_planes("YUV420P8", rng, 2, 24, 48))
    sj, st = both_clips("GRAY8", make_planes("GRAY8", rng, 2, 22, 48))
    fj, ft = both_clips("GRAY8", make_planes("GRAY8", rng, 3, 24, 48))
    cases = [
        (ij, it, "eedi3", {"field": 1}),
        (cj, ct, "eedi3", {"field": 4}),
        (cj, ct, "eedi3", {"field": -1}),
        (cj, ct, "eedi3", {"field": 2, "dh": True}),
        (oj, ot, "eedi3", {"field": 1}),
        (oj, ot, "eedi3h", {"field": 1}),
        (cj, ct, "eedi3", {"field": 1, "alpha": 1.5}),
        (cj, ct, "eedi3", {"field": 1, "beta": -0.1}),
        (cj, ct, "eedi3", {"field": 1, "alpha": 0.8, "beta": 0.8}),
        (cj, ct, "eedi3", {"field": 1, "gamma": -1.0}),
        (cj, ct, "eedi3", {"field": 1, "nrad": 4}),
        (cj, ct, "eedi3", {"field": 1, "mdis": 41}),
        (cj, ct, "eedi3", {"field": 1, "mdis": 0}),
        (cj, ct, "eedi3", {"field": 1, "vcheck": 4}),
        (cj, ct, "eedi3", {"field": 1, "vthresh1": 0.0}),
        (cj, ct, "eedi3", {"field": 1, "mclip": (yj, yt)}),
        (cj, ct, "eedi3", {"field": 1, "mclip": (sj, st)}),
        (cj, ct, "eedi3", {"field": 1, "mclip": (fj, ft)}),
    ]
    msgs = set()
    for j, t, fn, args in cases:
        aj = {k: (v[0] if isinstance(v, tuple) else v) for k, v in args.items()}
        at = {k: (v[1] if isinstance(v, tuple) else v) for k, v in args.items()}
        msgs.add(same_error(lambda: getattr(vz, fn)(j, **aj), lambda: getattr(vt, fn)(t, **at)))
    assert len(msgs) == len(cases) - 2  # field 4/-1 and mdis 41/0 share a message
    assert "EEDI3H: width must be mod 2 when dh=False." in msgs
