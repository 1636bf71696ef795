"""Checkmate: temporal + spatial dot-crawl / rainbow reducer.

The PyTorch counterpart of ``vszip_tpu.ops.checkmate`` (reference
src/filters/checkmate.zig + src/vapoursynth/checkmate.zig), with the same
validation and messages: 8-bit only, all planes; a 5-frame window (n-2 ..
n+2, clamped at the clip's ends) when ``tthr2 > 0``, else 3 frames; the
first and last two rows pass through.  Every plane goes through
``kernels.checkmate.checkmate`` (B15): its CUDA kernel on a CUDA tensor,
its plain version on a CPU tensor.
"""

from __future__ import annotations

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, require
from ..kernels import checkmate as kernels
from ..trace import spanned

FILTER_NAME = "Checkmate"


@spanned("vszip.op.checkmate")
def checkmate(clip: Clip, thr: int = 12, tmax: int = 12, tthr2: int = 0) -> Clip:
    fmt = clip.format
    require(
        fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 8,
        FILTER_NAME, "only 8 bit int format supported.",
    )
    thr, tmax, tthr2 = int(thr), int(tmax), int(tthr2)
    if tmax < 1 or tmax > 255:
        raise VSZipError(f"{FILTER_NAME}: tmax value should be in range [1;255].")
    if tthr2 < 0:
        raise VSZipError(f"{FILTER_NAME}: tthr2 should be non-negative.")
    if thr < 0 or thr > 255:
        raise VSZipError(f"{FILTER_NAME}: thr value should be in range [0;255].")
    min_w = clip.width >> fmt.subsampling_w
    min_h = clip.height >> fmt.subsampling_h
    if min_w < 3 or min_h < 5:
        raise VSZipError(
            f"{FILTER_NAME}: clip too small; every plane must be at least 3 "
            "wide and 5 tall."
        )
    return clip.with_planes([kernels.checkmate(p.contiguous(), thr, tmax, tthr2)
                             for p in clip.planes])
