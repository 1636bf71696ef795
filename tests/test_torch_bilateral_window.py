"""Bilateral's algorithm 2 window (``vszip_tpu_torch.kernels.bilateral``) on
the CPU: the plain version equals the per-plane torch ladder the op ran
before the window kernel existed (kept below, with its own helpers, as it
was), the op hands every algorithm-2 plane of a call to one
``bilateral_window`` call, the wrapper's checks refuse what the kernel does
not take, and the launch counter is registered.  The kernel itself runs
only on the card (``tests/test_torch_card.py``).
"""

import importlib
import math

import numpy as np
import pytest
import torch

import vszip_tpu_torch as vt
from vszip_tpu_torch import trace
from vszip_tpu_torch.kernels import bilateral as kbl

ob = importlib.import_module("vszip_tpu_torch.ops.bilateral")


# --- the former per-plane ladder, with its own helpers ------------------------

def _former_consts(hist_len, sigma_r):
    rng = float(hist_len - 1)
    upper = float(np.trunc(min(rng, sigma_r * 8.0 * rng + 0.5)))
    scale = np.float32(1.0 / (rng * float(sigma_r)))
    c = np.float32(1.0 / (math.sqrt(2.0 * math.pi) * sigma_r))
    return float(np.float32(upper)), float(scale), float(c)


def _former_weight(idx, consts):
    upper, scale, c = consts
    t = idx.to(torch.float32).clamp_(max=upper).mul_(scale)
    return t.mul_(t).mul_(-0.5).exp_().mul_(c)


def _former_index(cx, nb, is_int):
    if is_int:
        return torch.sub(cx, nb).abs_()
    ad = torch.sub(cx, nb).abs_().to(torch.float32)
    return ad.clamp_(max=1.0).mul_(65535.0).add_(0.5).to(torch.int32)


def _former_pad(x, r):
    h, w = x.shape[1], x.shape[2]
    iy = torch.arange(-r, h + r, device=x.device).clamp_(0, h - 1)
    ix = torch.arange(-r, w + r, device=x.device).clamp_(0, w - 1)
    return x[:, iy][:, :, ix]


def _former_truncated(src, ref, gs, sigma_r, hist_len, radius, step, peak, is_int):
    consts = _former_consts(hist_len, sigma_r)
    n, h, w = src.shape
    work = torch.int32 if is_int else src.dtype
    refp = _former_pad(ref.to(work), radius)
    srcp = (refp if src is ref else _former_pad(src.to(work), radius)).to(torch.float32)

    def tap(a, dy, dx):
        return a[:, radius + dy: radius + dy + h, radius + dx: radius + dx + w]

    cx = tap(refp, 0, 0)
    w0 = float(np.float32(gs[0]) * np.float32(consts[2]))
    wsum = torch.full(src.shape, w0, dtype=torch.float32, device=src.device)
    s = tap(srcp, 0, 0).mul(w0)
    radius2 = radius + 1
    for yy in range(1, radius2, step):
        for xx in range(1, radius2, step):
            swei = float(gs[yy * radius2 + xx])
            rsum, acc = None, None
            for dy, dx in ((-yy, xx), (yy, xx), (-yy, -xx), (yy, -xx)):
                rw = _former_weight(_former_index(cx, tap(refp, dy, dx), is_int), consts)
                rsum = rw.clone() if rsum is None else rsum.add_(rw)
                prod = rw.mul_(tap(srcp, dy, dx))
                acc = prod if acc is None else acc.add_(prod)
            wsum.add_(rsum.mul_(swei))
            s.add_(acc.mul_(swei))
    r = s.div_(wsum)
    if is_int:
        return r.add_(0.5).clamp_(0.0, peak).trunc_().to(torch.int32).to(src.dtype)
    return r.to(src.dtype)


# --- helpers -------------------------------------------------------------------

def _clip(fmt_name, n, h, w, seed):
    f = vt.get_format(fmt_name)
    rng = np.random.default_rng(seed)
    planes = []
    for p in range(f.num_planes):
        shape = (n,) + f.plane_dims(w, h, p)[::-1]
        if f.sample_type is vt.SampleType.FLOAT:
            planes.append(rng.random(shape, dtype=np.float32).astype(f.storage_dtype))
        else:
            planes.append(rng.integers(0, 1 << f.bits_per_sample, shape).astype(f.storage_dtype))
    return vt.Clip.from_planes(planes, f, device="cpu")


def _windows(clip, ref, specs, sigma_r):
    """A window per plane of `clip` that `specs` gives (radius, step, sigmaS)."""
    f = clip.format
    hist = f.hist_len()
    out = []
    for p, (radius, step, sigma_s) in enumerate(specs):
        x = clip.planes[p]
        rp = x if ref is None else ref.planes[p][:clip.num_frames]
        out.append(kbl.Window(x, rp, ob._gs_lut(radius, sigma_s).reshape(-1), sigma_r, hist,
                              radius, step, float(hist - 1),
                              f.sample_type is vt.SampleType.INTEGER))
    return out


def _same(a, b):
    if a.is_floating_point():
        return a.dtype == b.dtype and torch.equal(a.view(torch.int16 if a.element_size() == 2
                                                         else torch.int32),
                                                  b.view(torch.int16 if b.element_size() == 2
                                                         else torch.int32))
    return a.dtype == b.dtype and torch.equal(a, b)


LUMA, CHROMA = (3, 2, 2.0), (2, 1, 1.0)


# --- the plain version ------------------------------------------------------------

@pytest.mark.parametrize("fmt,sigma_r", [("GRAY8", 0.05), ("GRAY10", 0.02), ("GRAY16", 2.0),
                                         ("YUV420P16", 2.0), ("GRAYH", 0.1), ("GRAYS", 0.05)],
                         ids=str)
@pytest.mark.parametrize("with_ref", [False, True])
def test_plain_window_equals_the_former_ladder(fmt, sigma_r, with_ref):
    c = _clip(fmt, 2, 21, 37, 1)
    ref = _clip(fmt, 4, 21, 37, 2) if with_ref else None
    specs = [LUMA] + [CHROMA] * (c.format.num_planes - 1)
    wins = _windows(c, ref, specs, sigma_r)
    got = kbl.bilateral_window(wins)
    assert len(got) == len(wins)
    for g, win in zip(got, wins):
        assert _same(g, _former_truncated(*win))


@pytest.mark.parametrize("spec", [(1, 1, 0.5), (4, 3, 2.5), (7, 3, 5.0)], ids=str)
def test_plain_window_equals_the_former_ladder_at_other_radii(spec):
    c = _clip("GRAY16", 1, 17, 19, 3)
    (win,) = _windows(c, None, [spec], 0.1)
    assert _same(kbl.bilateral_window([win])[0], _former_truncated(*win))


def test_the_plain_version_counts_no_launch():
    c = _clip("YUV420P16", 2, 24, 40, 4)
    before = kbl.LAUNCHES["bilateral_window"]
    vt.bilateral(c, sigmaS=2.0, sigmaR=2.0, planes=[0, 1, 2])
    assert kbl.LAUNCHES["bilateral_window"] == before


# --- the op's one call per op call ------------------------------------------------

@pytest.mark.parametrize("fmt,args,planes", [
    ("YUV420P16", {"sigmaS": 2.0, "sigmaR": 2.0, "planes": [0, 1, 2]}, [(3, 2), (2, 1), (2, 1)]),
    ("YUV420P16", {"sigmaS": 2.0, "sigmaR": 2.0, "planes": [1]}, [(2, 1)]),
    ("YUV420P8", {"sigmaS": 3.0, "sigmaR": 0.05, "algorithm": [1, 2, 2]}, [(2, 1), (2, 1)]),
    ("GRAY16", {"sigmaS": 2.0, "sigmaR": 0.1, "algorithm": 1}, None),
    ("GRAY8", {"sigmaS": 0.0}, None),
], ids=str)
def test_the_op_hands_its_algorithm_2_planes_to_one_window_call(monkeypatch, fmt, args, planes):
    calls = []
    real = kbl.bilateral_window

    def spy(windows):
        calls.append([(w.radius, w.step) for w in windows])
        return real(windows)

    monkeypatch.setattr(kbl, "bilateral_window", spy)
    c = _clip(fmt, 2, 40, 64, 5)
    out = vt.bilateral(c, **args)
    assert calls == ([] if planes is None else [planes])
    assert [tuple(p.shape) for p in out.planes] == [tuple(p.shape) for p in c.planes]


def test_a_longer_ref_gives_its_first_frames_to_the_windows(monkeypatch):
    seen = []
    real = kbl.bilateral_window

    def spy(windows):
        seen.extend(windows)
        return real(windows)

    monkeypatch.setattr(kbl, "bilateral_window", spy)
    c, ref = _clip("GRAY16", 2, 24, 40, 6), _clip("GRAY16", 5, 24, 40, 7)
    vt.bilateral(c, ref=ref, sigmaS=2.0, sigmaR=0.1)
    (win,) = seen
    assert win.ref.shape == win.src.shape and win.ref.is_contiguous()
    assert torch.equal(win.ref, ref.planes[0][:2]) and win.src is c.planes[0]


def _as_views(c, crop):
    """`c` with each plane a non-contiguous view of the same samples: cut
    out of a larger zeroed plane (`crop`) or transposed out of a copy with
    its last two axes swapped."""
    planes = []
    for x in c.planes:
        if crop:
            n, h, w = x.shape
            big = torch.zeros((n, h + 2, w + 3), dtype=x.dtype, device=x.device)
            big[:, 1:-1, 1:-2] = x
            planes.append(big[:, 1:-1, 1:-2])
        else:
            planes.append(x.transpose(1, 2).contiguous().transpose(1, 2))
    assert not any(v.is_contiguous() for v in planes)
    return vt.Clip(tuple(planes), c.format, dict(c.props))


@pytest.mark.parametrize("fmt,args", [
    ("YUV420P16", {"sigmaS": 2.0, "sigmaR": 2.0, "planes": [0, 1, 2]}),
    ("GRAYH", {"sigmaS": 2.0, "sigmaR": 0.1}),
    ("YUV420P8", {"sigmaS": 3.0, "sigmaR": 0.05, "algorithm": [1, 2, 2]}),
], ids=str)
@pytest.mark.parametrize("with_ref", [False, True])
def test_planes_that_are_views_filter_as_their_copies(monkeypatch, fmt, args, with_ref):
    """A clip may hold views (``from_planes`` does not copy a tensor): the op
    hands the windows contiguous planes and gives what the copies give."""
    seen = []
    real = kbl.bilateral_window

    def spy(windows):
        seen.extend(windows)
        return real(windows)

    c = _clip(fmt, 2, 40, 64, 8)
    ref = _clip(fmt, 3, 40, 64, 9) if with_ref else None
    want = vt.bilateral(c, ref=ref, **args)
    monkeypatch.setattr(kbl, "bilateral_window", spy)
    got = vt.bilateral(_as_views(c, False), ref=None if ref is None else _as_views(ref, True),
                       **args)
    assert seen and all(w.src.is_contiguous() and w.ref.is_contiguous() for w in seen)
    assert all((w.ref is w.src) != with_ref for w in seen)
    assert all(_same(g, w_) for g, w_ in zip(got.planes, want.planes))


# --- the wrapper's checks ---------------------------------------------------------

def _win():
    (win,) = _windows(_clip("GRAY16", 2, 40, 64, 8), None, [LUMA], 2.0)
    return win


_REFUSED = {
    "dtype": (lambda w: [w._replace(src=w.src.to(torch.int32), ref=w.src.to(torch.int32))],
              "float32 planes"),
    "shape": (lambda w: [w._replace(src=w.src[0], ref=w.src[0])], "float32 planes"),
    "contiguity": (lambda w: [w._replace(src=w.src.transpose(1, 2), ref=w.src.transpose(1, 2))],
                   "contiguous"),
    "ref": (lambda w: [w._replace(ref=w.src[:, :39].contiguous())], "ref must be"),
    "ref_dtype": (lambda w: [w._replace(ref=w.src.to(torch.uint8))], "ref must be"),
    "planes": (lambda w: [w] * 4, "1 to 3 planes"),
    "no_planes": (lambda w: [], "1 to 3 planes"),
    "frames": (lambda w: [w, w._replace(src=w.src[:1], ref=w.src[:1])], "frame count"),
    "dtypes": (lambda w: [w, w._replace(src=w.src.to(torch.uint8), ref=w.src.to(torch.uint8),
                                        is_int=True)], "share their"),
    "peak": (lambda w: [w, w._replace(peak=255.0)], "peak"),
    "is_int": (lambda w: [w._replace(is_int=False)], "is_int"),
    "radius": (lambda w: [w._replace(radius=0, gs=np.ones(1, np.float32))], "radius 0"),
    "step": (lambda w: [w._replace(step=0)], "step 0"),
    "weights": (lambda w: [w._replace(gs=w.gs[:9])], "with 9 spatial weights"),
    "device": (lambda w: [w], "no Bilateral kernel for device cpu"),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_the_check_refuses_what_the_kernel_does_not_take(case):
    make, msg = _REFUSED[case]
    with pytest.raises(ValueError, match=msg):
        kbl._check(make(_win()))


def test_a_cuda_window_beside_cpu_ones_is_refused_not_run_plain():
    win = _win()
    meta = win._replace(src=torch.empty(win.src.shape, dtype=win.src.dtype, device="meta"),
                        ref=torch.empty(win.src.shape, dtype=win.src.dtype, device="meta"))
    with pytest.raises(ValueError, match="share their device"):
        kbl.bilateral_window([win, meta])


# --- the kernel's layout as the wrapper and tests see it ----------------------------

def test_spatial_weights_follow_the_plugin_order():
    for radius, step in ((3, 2), (2, 1), (7, 3), (16, 3)):
        gs = ob._gs_lut(radius, radius / 1.5).reshape(-1)
        win = kbl.Window(None, None, gs, 0.1, 65536, radius, step, 65535.0, True)
        want = [gs[yy * (radius + 1) + xx] for yy in range(1, radius + 1, step)
                for xx in range(1, radius + 1, step)]
        got = kbl.spatial_weights(win)
        assert got.dtype == np.float32 and got.tolist() == want
        assert got.size == kbl._samples(radius, step) ** 2


def test_the_window_kernel_is_a_launch_counter():
    view = trace.counters()
    assert "bilateral_window" in view and view["bilateral_window"] == kbl.LAUNCHES[
        "bilateral_window"]
    saved = kbl.LAUNCHES["bilateral_window"]
    try:
        kbl.LAUNCHES["bilateral_window"] += 2
        assert view["bilateral_window"] == saved + 2
        trace.reset_launches()
        assert view["bilateral_window"] == 0
    finally:
        kbl.LAUNCHES["bilateral_window"] = saved
