"""CombMaskMT: MTCombMask-style vertical comb detector.

The PyTorch counterpart of ``vszip_tpu.ops.comb_mask_mt`` (reference
src/filters/comb_mask_mt.zig + src/vapoursynth/comb_mask_mt.zig), plain
torch on either device, as the JAX package's is plain jnp: per plane (all
planes, 8-bit only) ``prod = (up - c) * (down - c)``; 255/0 when thY1 ==
thY2, else the ramp ``min((prod - thY1) * 256 // (thY2 - thY1), 255)``
between the two thresholds (floor division, as in the JAX package).  The
first and last rows are 0.
"""

from __future__ import annotations

import torch

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, require
from ..trace import spanned

FILTER_NAME = "CombMaskMT"


def _comb_mask_mt_plane(x: torch.Tensor, thy1: int, thy2: int) -> torch.Tensor:
    xi = x.to(torch.int32)
    c = xi[:, 1:-1]
    prod = (xi[:, :-2] - c) * (xi[:, 2:] - c)
    if thy1 == thy2:
        mid = (prod > thy2).to(torch.uint8) * 255
    else:
        gray = torch.div((prod - thy1) * 256, thy2 - thy1, rounding_mode="floor").clamp(max=255)
        mid = torch.where(prod < thy1, 0, torch.where(prod > thy2, 255, gray)).to(torch.uint8)
    zrow = torch.zeros_like(mid[:, :1])
    return torch.cat([zrow, mid, zrow], dim=1)


@spanned("vszip.op.comb_mask_mt")
def comb_mask_mt(clip: Clip, thY1: int = 30, thY2: int = 30) -> Clip:
    fmt = clip.format
    require(
        fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 8,
        FILTER_NAME, "only 8 bit int format supported.",
    )
    thY1, thY2 = int(thY1), int(thY2)
    if thY1 > 255 or thY1 < 0:
        raise VSZipError(f"{FILTER_NAME}: thY1 value should be in range [0;255]")
    if thY2 > 255 or thY2 < 0:
        raise VSZipError(f"{FILTER_NAME}: thY2 value should be in range [0;255]")
    if thY1 > thY2:
        raise VSZipError(f"{FILTER_NAME}: thY1 can't be greater than thY2")
    min_h = clip.height >> fmt.subsampling_h
    if min_h < 3:
        raise VSZipError(
            f"{FILTER_NAME}: clip too small; every plane must be at least 3 rows tall."
        )
    return clip.with_planes([_comb_mask_mt_plane(p, thY1, thY2) for p in clip.planes])
