"""CombMask: interlace comb detector with optional motion mask + expansion.

The PyTorch counterpart of ``vszip_tpu.ops.comb_mask`` (reference
src/filters/comb_mask.zig + src/vapoursynth/comb_mask.zig), with the same
validation and messages: 8-bit only, all planes, metric 0 or 1 with
reflect-101 rows, the motion mask when ``mthresh > 0`` (frame 0 compared
with itself) and the expand after it, with the reference's quirks (see
``kernels/comb_mask.py``).  Every plane goes through
``kernels.comb_mask.comb_mask`` (B16): its CUDA kernel on a CUDA tensor, any
width included, its plain version on a CPU tensor.
"""

from __future__ import annotations

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, require
from ..kernels import comb_mask as kernels
from ..trace import spanned

FILTER_NAME = "CombMask"


@spanned("vszip.op.comb_mask")
def comb_mask(clip: Clip, cthresh: int = 6, mthresh: int = 9,
              expand: bool = True, metric: bool = False) -> Clip:
    fmt = clip.format
    require(
        fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 8,
        FILTER_NAME, "only 8 bit int format supported.",
    )
    cthresh, mthresh = int(cthresh), int(mthresh)
    metric_1 = bool(metric)
    cth_max = 65025 if metric_1 else 255
    if cthresh > cth_max or cthresh < 0:
        raise VSZipError(
            f"{FILTER_NAME}: cthresh must be between 0 and {cth_max} when "
            f"metric = {str(metric_1).lower()}."
        )
    if mthresh > 255 or mthresh < 0:
        raise VSZipError(f"{FILTER_NAME}: mthresh must be between 0 and 255.")
    min_h = clip.height >> fmt.subsampling_h
    if min_h < 3:
        raise VSZipError(
            f"{FILTER_NAME}: clip too small; every plane must be at least 3 rows tall."
        )
    return clip.with_planes([kernels.comb_mask(p.contiguous(), cthresh, mthresh, metric_1,
                                               bool(expand)) for p in clip.planes])
