"""AdaptiveBinarize: OpenCV-style adaptive threshold against a second clip.

The PyTorch counterpart of ``vszip_tpu.ops.adaptive_binarize`` (reference
src/vapoursynth/adaptive_binarize.zig): 8-bit integer only;
``dst = 255 if (src2 - src1 >= c) else 0`` on every plane, the difference
taken in int16 (clip2 is typically a blurred version of clip; a longer clip2
gives its first frames).  Sets ``_ColorRange`` FULL.
"""

from __future__ import annotations

import torch

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import compare_clips, require
from ..trace import spanned

FILTER_NAME = "AdaptiveBinarize"


def _binarize(s1, s2, c: int):
    diff = s2.to(torch.int16) - s1.to(torch.int16)
    return (diff >= c).to(torch.uint8).mul_(255)


@spanned("vszip.op.adaptive_binarize")
def adaptive_binarize(clip: Clip, clip2: Clip, c: int = 3) -> Clip:
    fmt = clip.format
    compare_clips([clip, clip2], FILTER_NAME, same_len=False, bigger_than=True)
    require(
        fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 8,
        FILTER_NAME, "only 8 bit int format supported.",
    )
    # src2 - src1 ranges [-255, 255]; clamping keeps comparisons intact
    c = max(-256, min(256, int(c)))
    n = clip.num_frames
    out = [_binarize(clip.planes[p], clip2.planes[p][:n], c)
           for p in range(fmt.num_planes)]
    return clip.with_planes(out).with_props(_ColorRange=0)
