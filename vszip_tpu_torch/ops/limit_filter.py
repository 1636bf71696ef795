"""LimitFilter: mvsfunc-style soft limiter between a filtered and source clip.

The PyTorch counterpart of ``vszip_tpu.ops.limit_filter`` (reference
src/filters/limit_filter.zig, src/vapoursynth/limit_filter.zig), with the
same arguments and messages.  Thresholds are given at 8-bit scale and scaled
to the clip depth with ``scale_value`` in the FULL color range (pinned by the
reference's goldens, as in the JAX package).  Per pixel, in f32:

    diff = flt - ref;  thr1 = bright_thr if diff > 0 else dark_thr
    thr2 = thr1 * elast
    |diff| <= thr1 -> flt
    |diff| >= thr2 -> src
    else          -> src + (flt - src) * (thr2 - |diff|) / (thr2 - thr1)

Integer outputs round half-up (``trunc(out + 0.5)``).  Unprocessed planes
pass through from the *flt* clip.
"""

from __future__ import annotations

import torch

from ..core.clip import Clip
from ..core.format import ColorRange, SampleType
from ..core.params import compare_clips, get_array, parse_planes, require, scale_value
from ..trace import spanned

FILTER_NAME = "LimitFilter"


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _limit_plane(f, s, r, dark_thr: float, bright_thr: float, elast: float,
                 is_int: bool):
    ff = f.to(torch.float32)
    sf = s.to(torch.float32)
    diff = ff - r.to(torch.float32)
    diff_abs = diff.abs()
    thr1 = torch.where(diff > 0, _f32(bright_thr, f.device), _f32(dark_thr, f.device))
    thr2 = thr1 * _f32(elast, f.device)
    ramp = sf + (ff - sf) * (thr2 - diff_abs) / (thr2 - thr1)
    out = torch.where(diff_abs <= thr1, ff, torch.where(diff_abs >= thr2, sf, ramp))
    if is_int:
        return out.add_(0.5).trunc_().to(torch.int32).to(f.dtype)
    return out.to(f.dtype)


@spanned("vszip.op.limit_filter")
def limit_filter(flt: Clip, src: Clip, ref: Clip | None = None, dark_thr=None,
                 bright_thr=None, elast=None, planes=None) -> Clip:
    fmt = flt.format
    require(
        not (fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 32),
        FILTER_NAME, "not supported Int format.",
    )
    clips = [flt, src] + ([ref] if ref is not None else [])
    compare_clips(clips, FILTER_NAME, same_len=True)
    process = parse_planes(planes, fmt.num_planes, FILTER_NAME)
    dark = get_array(dark_thr, "dark_thr", 1.0, 0.0, 255.0, FILTER_NAME)
    bright = get_array(bright_thr, "bright_thr", 1.0, 0.0, 255.0, FILTER_NAME)
    elast_a = get_array(elast, "elast", 2.0, 0.0, 65535.0, FILTER_NAME)
    dark = [scale_value(v, flt, color_range=ColorRange.FULL) for v in dark]
    bright = [scale_value(v, flt, color_range=ColorRange.FULL) for v in bright]

    is_int = fmt.sample_type is SampleType.INTEGER
    rclip = ref if ref is not None else src
    out = []
    for p in range(fmt.num_planes):
        if not process[p]:
            out.append(flt.planes[p])
            continue
        out.append(
            _limit_plane(flt.planes[p], src.planes[p], rclip.planes[p],
                         float(dark[p]), float(bright[p]), float(elast_a[p]), is_int)
        )
    return flt.with_planes(out)
