"""Limiter: clamp planes to explicit or range-derived min/max.

The PyTorch counterpart of ``vszip_tpu.ops.limiter`` (reference
src/vapoursynth/limiter.zig and src/filters/limiter.zig), with the same three
modes and messages:

* explicit ``min``/``max`` arrays (both required, one entry per plane);
* ``tv_range=True``: TV-range tables — YUV gets 16..235 luma / 16..240
  chroma scaled by bit depth, RGB gets 16..235 on all planes; float YUV is
  0..1 luma / -0.5..0.5 chroma regardless of tv_range;
* default: full-range tables (0..2^bits-1 for ints).

``mask=True`` treats a YUV clip like RGB (full-range-style limits on
chroma).  Integer planes are clamped in int32 (int64 for 32-bit planes):
torch has no clamp, maximum or minimum for uint16 or uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import ColorFamily, ColorRange, SampleType
from ..core.params import VSZipError, parse_planes
from ..trace import spanned

FILTER_NAME = "Limiter"


def _range_limits(fmt, yuv: bool, tv_range: bool, plane: int):
    """The comptime tables (reference src/filters/limiter.zig:66-91)."""
    if fmt.sample_type is SampleType.FLOAT:
        if yuv and plane > 0:
            return -0.5, 0.5
        return 0.0, 1.0
    bits = fmt.bits_per_sample
    if not tv_range:
        return 0, (1 << bits) - 1
    lo = 16 << (bits - 8)
    if yuv and plane > 0:
        return lo, 240 << (bits - 8)
    return lo, 235 << (bits - 8)


def _clamp(x: torch.Tensor, lo, hi) -> torch.Tensor:
    if x.dtype.is_floating_point:
        # the bounds round to the plane's dtype first, as in the JAX package;
        # NumPy rounds a double to f16 once, where torch.tensor goes via f32
        np_dtype = {torch.float16: np.float16, torch.float32: np.float32}[x.dtype]
        lo_t = torch.from_numpy(np.asarray(lo, np_dtype)).to(x.device)
        hi_t = torch.from_numpy(np.asarray(hi, np_dtype)).to(x.device)
        return torch.minimum(torch.maximum(lo_t, x), hi_t)
    wide = torch.int64 if x.dtype == torch.uint32 else torch.int32
    return x.to(wide).clamp(int(lo), int(hi)).to(x.dtype)


@spanned("vszip.op.limiter")
def limiter(clip: Clip, min=None, max=None, tv_range: bool = False,
            mask: bool = False, planes=None) -> Clip:
    fmt = clip.format
    num_planes = fmt.num_planes
    process = parse_planes(planes, num_planes, FILTER_NAME)
    is_int = fmt.sample_type is SampleType.INTEGER
    peak = fmt.peak_value(False, ColorRange.FULL)

    has_min, has_max = min is not None, max is not None
    if has_min and not has_max:
        raise VSZipError(f"{FILTER_NAME}: min array is set but max array is not.")
    if has_max and not has_min:
        raise VSZipError(f"{FILTER_NAME}: max array is set but min array is not.")

    if has_min:
        # a bare scalar is a length-1 array (VS map semantics)
        min = [min] if not isinstance(min, (list, tuple)) else list(min)
        max = [max] if not isinstance(max, (list, tuple)) else list(max)
        if len(min) != num_planes:
            raise VSZipError(
                f"{FILTER_NAME}: min array must have the same number of elements as planes."
            )
        if len(max) != num_planes:
            raise VSZipError(
                f"{FILTER_NAME}: max array must have the same number of elements as planes."
            )
        mins, maxs = [], []
        for i in range(num_planes):
            if is_int:
                for nm, v in (("min", min[i]), ("max", max[i])):
                    if float(v) > peak:
                        raise VSZipError(
                            f"{FILTER_NAME}: {nm} value must be less than or equal to peak value."
                        )
                    if int(v) < 0:
                        raise VSZipError(
                            f"{FILTER_NAME}: {nm} value must be greater than or equal to 0."
                        )
                mins.append(int(min[i]))
                maxs.append(int(max[i]))
            else:
                mins.append(float(min[i]))
                maxs.append(float(max[i]))
            if mins[i] > maxs[i]:
                raise VSZipError(
                    f"{FILTER_NAME}: min value must be less than or equal to max value."
                )
    else:
        yuv = fmt.color_family is ColorFamily.YUV and not mask
        lims = [_range_limits(fmt, yuv, tv_range, p) for p in range(num_planes)]
        mins = [l[0] for l in lims]
        maxs = [l[1] for l in lims]

    out = []
    for p, x in enumerate(clip.planes):
        if not process[p]:
            out.append(x)
            continue
        out.append(_clamp(x, mins[p], maxs[p]))
    return clip.with_planes(out)
