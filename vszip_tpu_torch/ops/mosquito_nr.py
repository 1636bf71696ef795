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

Steps 1-3 are ``kernels.mosquito_nr.mosquito_nr_smooth``: one CUDA launch a
plane on the card, its plain torch version on the CPU (the JAX package has
no kernel).  Step 4 is plain torch on either device.  Integers run in
int32, which is bit-identical to the reference's i16 lanes for every valid
pixel range; floats in f32, each product and sum rounded on its own.  By
default only luma is processed.

Each processed plane opens two spans, ``vszip.op.mosquito_nr.smooth``
(steps 1-3, the kernel's launch on the card) and
``vszip.op.mosquito_nr.restore`` (step 4 and the output's rounding, clamp
and cast), and counts itself in ``PLANES``:
``mosquito_nr_smoothed``, ``mosquito_nr_restored`` (restore != 0) and
``mosquito_nr_mixed`` (0 < restore < 128, the LL mix).
Unlike other spans inside an op, both reach the profiler's trace
(``profiled``), where the benchmark attributes each device operation to its
stage: two ranges a plane cost a few microseconds of host time under the
profiler, against a call's tens of launches and milliseconds of device
time.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..core.clip import Clip
from ..core.format import ColorFamily, SampleType
from ..core.params import VSZipError, get_array, parse_planes, require
from ..kernels import mosquito_nr as kmn

FILTER_NAME = "MosquitoNR"
PLANES = trace.register_launches({"mosquito_nr_smoothed": 0, "mosquito_nr_restored": 0,
                                  "mosquito_nr_mixed": 0})


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
    with trace.span("vszip.op.mosquito_nr.smooth"):
        PLANES["mosquito_nr_smoothed"] += 1
        # a clip may hold views; the kernel takes contiguous planes
        blur, work = kmn.mosquito_nr_smooth(x.contiguous(), strength, radius, restore != 0)
    if is_int:
        lo_clamp, hi_clamp = 0, (1 << bits) - 1
    else:
        lo_clamp, hi_clamp = (-0.5, 0.5) if chroma else (0.0, 1.0)

    with trace.span("vszip.op.mosquito_nr.restore"):
        out = blur
        if restore != 0:
            PLANES["mosquito_nr_restored"] += 1
            va_o, _ = _fwd_axis(work, 1, is_int)
            ll_o, _ = _fwd_axis(va_o, 2, is_int)
            va_b, vd_b = _fwd_axis(blur, 1, is_int)
            ll_b, hd_b = _fwd_axis(va_b, 2, is_int)
            if restore == 128:
                ll = ll_o
            else:
                PLANES["mosquito_nr_mixed"] += 1
                if is_int:
                    ll = (restore * ll_o + (128 - restore) * ll_b + 64) >> 7
                else:
                    wo = np.float32(restore / 128.0)
                    ll = float(wo) * ll_o + float(np.float32(1.0) - wo) * ll_b
            out = _inv_axis(_inv_axis(ll, hd_b, 2, w, is_int), vd_b, 1, h, is_int)

        if is_int:
            return ((out + 8) >> 4).clamp(lo_clamp, hi_clamp).to(x.dtype)
        return out.clamp(lo_clamp, hi_clamp)


@trace.spanned("vszip.op.mosquito_nr")
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
