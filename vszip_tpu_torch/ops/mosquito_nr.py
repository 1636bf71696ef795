"""MosquitoNR: direction-aware mosquito-noise reducer with wavelet detail
restore.

The PyTorch counterpart of ``vszip_tpu.ops.mosquito_nr`` (reference
src/filters/mosquito_nr.zig, the f32 variant mosquito_nr_float.zig and
src/vapoursynth/mosquito_nr.zig), with the same validation and messages.
Per plane:

1. Work plane: integer inputs are lifted to bits+4 fixed point (<< 4) with a
   2-pixel reflect-101 border; floats are used raw.
2. Direction pass: 8 directional SADs over the radius-1 or radius-2 stencil;
   the smallest picks the direction (ties keep the lower index), an exact
   zero means "flat" (copy).
3. Directional blend with integer coefficients from `strength` (rounded
   >>6/>>7/>>8 fixed point for ints, power-of-two multiplies for floats).
4. Optional detail restore (`restore` < 128 blends, 0 disables): a CDF-5/3
   style lifting wavelet, V then H, of the original and the smoothed plane;
   their LL bands mix by restore/128 and the inverse transform rebuilds the
   output from the mixed LL and the smoothed plane's detail bands.

Plain torch on either device (no kernel: the JAX package has none either).
Integers run in int32, which is bit-identical to the reference's i16 lanes
for every valid pixel range; floats in f32, each product and sum rounded
on its own.  By default only luma is processed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import ColorFamily, SampleType
from ..core.params import VSZipError, get_array, parse_planes, require
from ..trace import spanned

FILTER_NAME = "MosquitoNR"


def _pad2(x: torch.Tensor) -> torch.Tensor:
    """2-pixel reflect-101 border on both axes."""
    x = torch.cat([x[:, 1:3].flip(1), x, x[:, -3:-1].flip(1)], dim=1)
    return torch.cat([x[:, :, 1:3].flip(2), x, x[:, :, -3:-1].flip(2)], dim=2)


def _half(a, is_int):
    return (a >> 1) if is_int else a * 0.5


def _sads(t, radius, is_int):
    """Direction per pixel (0-7, or 8 for flat) from the tap view `t(dy, dx)`."""
    c = t(0, 0)

    def A(v):
        return (v - c).abs()

    def H(a, b):
        return (_half(a + b, is_int) - c).abs()

    if radius == 1:
        sad = [
            A(t(0, -1)) + A(t(0, 1)),
            A(t(-1, -1)) + A(t(1, 1)),
            A(t(-1, 0)) + A(t(1, 0)),
            A(t(-1, 1)) + A(t(1, -1)),
            H(t(0, -1), t(-1, -1)) + H(t(0, 1), t(1, 1)),
            H(t(-1, -1), t(-1, 0)) + H(t(1, 1), t(1, 0)),
            H(t(-1, 0), t(-1, 1)) + H(t(1, 0), t(1, -1)),
            H(t(0, 1), t(-1, 1)) + H(t(0, -1), t(1, -1)),
        ]
    else:
        sad = [
            A(t(0, -1)) + A(t(0, 1)) + A(t(0, -2)) + A(t(0, 2)),
            A(t(-1, -1)) + A(t(1, 1)) + A(t(-2, -2)) + A(t(2, 2)),
            A(t(-1, 0)) + A(t(1, 0)) + A(t(-2, 0)) + A(t(2, 0)),
            A(t(-1, 1)) + A(t(1, -1)) + A(t(-2, 2)) + A(t(2, -2)),
            A(t(-1, -2)) + A(t(1, 2)) + H(t(0, -1), t(-1, -1)) + H(t(0, 1), t(1, 1)),
            A(t(-2, -1)) + A(t(2, 1)) + H(t(-1, -1), t(-1, 0)) + H(t(1, 1), t(1, 0)),
            A(t(-2, 1)) + A(t(2, -1)) + H(t(-1, 0), t(-1, 1)) + H(t(1, 0), t(1, -1)),
            A(t(-1, 2)) + A(t(1, -2)) + H(t(-1, 1), t(0, 1)) + H(t(1, -1), t(0, -1)),
        ]
    best = sad[0]
    idx = torch.zeros(c.shape, dtype=torch.int32, device=c.device)
    for i in range(1, 8):
        lt = sad[i] < best
        idx = torch.where(lt, i, idx)
        best = torch.where(lt, sad[i], best)
    return torch.where(best == 0, 8, idx)


def _blend(t, dirs, strength, radius, is_int):
    c = t(0, 0)
    s = strength if is_int else float(np.float32(strength))
    if radius == 1:
        coef0, coef1, coef2 = 64 - 2 * s, 128 - 4 * s, s
        lo_shift, hi_shift = 6, 7
    else:
        coef0, coef1, coef2 = 128 - 4 * s, 256 - 8 * s, s
        coef3 = 2 * s
        lo_shift, hi_shift = 7, 8

    def lo(acc):
        if is_int:
            return (acc + (1 << (lo_shift - 1))) >> lo_shift
        return acc * (1.0 / (1 << lo_shift))

    def hi(acc):
        if is_int:
            return (acc + (1 << (hi_shift - 1))) >> hi_shift
        return acc * (1.0 / (1 << hi_shift))

    if radius == 1:
        arms = [
            lambda: lo(coef0 * c + coef2 * (t(0, -1) + t(0, 1))),
            lambda: lo(coef0 * c + coef2 * (t(-1, -1) + t(1, 1))),
            lambda: lo(coef0 * c + coef2 * (t(-1, 0) + t(1, 0))),
            lambda: lo(coef0 * c + coef2 * (t(-1, 1) + t(1, -1))),
            lambda: hi(coef1 * c + coef2 * (t(-1, -1) + t(0, -1) + t(0, 1) + t(1, 1))),
            lambda: hi(coef1 * c + coef2 * (t(-1, -1) + t(-1, 0) + t(1, 0) + t(1, 1))),
            lambda: hi(coef1 * c + coef2 * (t(-1, 1) + t(-1, 0) + t(1, 0) + t(1, -1))),
            lambda: hi(coef1 * c + coef2 * (t(-1, 1) + t(0, 1) + t(0, -1) + t(1, -1))),
        ]
    else:
        arms = [
            lambda: lo(coef0 * c + coef2 * (t(0, -2) + t(0, -1) + t(0, 1) + t(0, 2))),
            lambda: lo(coef0 * c + coef2 * (t(-2, -2) + t(-1, -1) + t(1, 1) + t(2, 2))),
            lambda: lo(coef0 * c + coef2 * (t(-2, 0) + t(-1, 0) + t(1, 0) + t(2, 0))),
            lambda: lo(coef0 * c + coef2 * (t(-2, 2) + t(-1, 1) + t(1, -1) + t(2, -2))),
            lambda: hi(coef1 * c + coef3 * (t(-1, -2) + t(1, 2))
                       + coef2 * (t(-1, -1) + t(0, -1) + t(0, 1) + t(1, 1))),
            lambda: hi(coef1 * c + coef3 * (t(-2, -1) + t(2, 1))
                       + coef2 * (t(-1, -1) + t(-1, 0) + t(1, 0) + t(1, 1))),
            lambda: hi(coef1 * c + coef3 * (t(-2, 1) + t(2, -1))
                       + coef2 * (t(-1, 1) + t(-1, 0) + t(1, 0) + t(1, -1))),
            lambda: hi(coef1 * c + coef3 * (t(-1, 2) + t(1, -2))
                       + coef2 * (t(-1, 1) + t(0, 1) + t(0, -1) + t(1, -1))),
        ]
    out = c
    for i, arm in enumerate(arms):
        out = torch.where(dirs == i, arm(), out)
    return out


def _q2(v, is_int):
    return (v >> 2) if is_int else v * 0.25


def _q1(v, is_int):
    return (v >> 1) if is_int else v * 0.5


def _even_right(e, n, nd):
    """The even neighbour below each odd sample j: e[j+1], or e[nd-1] (index
    n-2) past the end of an even-length axis."""
    return torch.cat([e[:, 1:], e[:, nd - 1:nd]], dim=1) if n % 2 == 0 else e[:, 1:nd + 1]


def _detail_sides(d, na, nd):
    dl = torch.cat([d[:, :1], d[:, :na - 1]], dim=1)
    dr = d if na == nd else torch.cat([d, d[:, nd - 1:nd]], dim=1)
    return dl, dr


def _fwd_axis(x, axis, is_int):
    """Lifting forward along `axis`: (approx, detail)."""
    x = x.movedim(axis, 1)
    n = x.shape[1]
    na, nd = (n + 1) // 2, n // 2
    e, o = x[:, 0::2], x[:, 1::2]
    d = o - _q1(e[:, :nd] + _even_right(e, n, nd), is_int)
    dl, dr = _detail_sides(d, na, nd)
    a = e + _q2(dl + dr, is_int)
    return a.movedim(1, axis), d.movedim(1, axis)


def _inv_axis(a, d, axis, n, is_int):
    a, d = a.movedim(axis, 1), d.movedim(axis, 1)
    na, nd = (n + 1) // 2, n // 2
    dl, dr = _detail_sides(d, na, nd)
    e = a - _q2(dl + dr, is_int)
    o = d + _q1(e[:, :nd] + _even_right(e, n, nd), is_int)
    out = torch.empty(a.shape[:1] + (n,) + a.shape[2:], dtype=a.dtype, device=a.device)
    out[:, 0::2] = e
    out[:, 1::2] = o
    return out.movedim(1, axis)


def _mosquito_plane(x, strength: int, restore: int, radius: int, bits: int, is_int: bool,
                    chroma: bool):
    n, h, w = x.shape
    if is_int:
        work = x.to(torch.int32) << 4
        lo_clamp, hi_clamp = 0, (1 << bits) - 1
    else:
        work = x.to(torch.float32)
        lo_clamp, hi_clamp = (-0.5, 0.5) if chroma else (0.0, 1.0)
    p = _pad2(work)

    def tap(dy, dx):
        return p[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]

    dirs = _sads(tap, radius, is_int)
    blur = _blend(tap, dirs, strength, radius, is_int)

    out = blur
    if restore != 0:
        va_o, _ = _fwd_axis(work, 1, is_int)
        ll_o, _ = _fwd_axis(va_o, 2, is_int)
        va_b, vd_b = _fwd_axis(blur, 1, is_int)
        ll_b, hd_b = _fwd_axis(va_b, 2, is_int)
        if restore == 128:
            ll = ll_o
        elif is_int:
            ll = (restore * ll_o + (128 - restore) * ll_b + 64) >> 7
        else:
            wo = np.float32(restore / 128.0)
            ll = float(wo) * ll_o + float(np.float32(1.0) - wo) * ll_b
        out = _inv_axis(_inv_axis(ll, hd_b, 2, w, is_int), vd_b, 1, h, is_int)

    if is_int:
        return ((out + 8) >> 4).clamp(lo_clamp, hi_clamp).to(x.dtype)
    return out.clamp(lo_clamp, hi_clamp)


@spanned("vszip.op.mosquito_nr")
def mosquito_nr(clip: Clip, strength=None, restore=None, radius=None, planes=None) -> Clip:
    fmt = clip.format
    ok_int = fmt.sample_type is SampleType.INTEGER and 8 <= fmt.bits_per_sample <= 16
    ok_float = fmt.sample_type is SampleType.FLOAT and fmt.bits_per_sample == 32
    require(ok_int or ok_float, FILTER_NAME,
            "only constant-format 8..16 bit integer or 32 bit float input is supported.")
    require(fmt.color_family is not ColorFamily.RGB, FILTER_NAME, "input must be YUV or Gray.")
    # default = luma only (reference src/vapoursynth/mosquito_nr.zig:114)
    if planes is None:
        selected = [True] + [False] * (fmt.num_planes - 1)
    else:
        selected = parse_planes(planes, fmt.num_planes, FILTER_NAME)
    strength_a = get_array(strength, "strength", 16, 0, 32, FILTER_NAME)
    restore_a = get_array(restore, "restore", 128, 0, 128, FILTER_NAME)
    radius_a = get_array(radius, "radius", 2, 1, 2, FILTER_NAME)
    for p in range(fmt.num_planes):
        if not selected[p]:
            continue
        pw, ph = clip.plane_dims(p)
        if pw < 4 or ph < 4:
            raise VSZipError(f"{FILTER_NAME}: input is too small (need at least 4x4 per "
                             "processed plane).")
    is_int = fmt.sample_type is SampleType.INTEGER
    out = []
    for p, x in enumerate(clip.planes):
        if not selected[p] or strength_a[p] == 0:
            out.append(x)
            continue
        out.append(_mosquito_plane(x, int(strength_a[p]), int(restore_a[p]), int(radius_a[p]),
                                   fmt.bits_per_sample, is_int,
                                   p > 0 and fmt.color_family is ColorFamily.YUV))
    return clip.with_planes(out)
