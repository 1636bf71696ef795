"""PackRGB: planar RGB -> interleaved single-plane u32.

The PyTorch counterpart of ``vszip_tpu.ops.packrgb`` (reference
src/vapoursynth/packrgb.zig).  RGB24 packs to BGRA bytes (alpha 255): as a
little-endian u32 that is ``B | G<<8 | R<<16 | 0xFF000000``.  RGB30 packs to
10:10:10:2: ``B | G<<10 | R<<20 | 0b11<<30``.  Output is a GRAY32 (u32) clip
of the same dimensions.  The packing runs in int64 (torch's uint32 lacks
shifts and ORs on some devices) and is cast at the end.
"""

from __future__ import annotations

import torch

from ..core.clip import Clip
from ..core.format import get_format
from ..core.params import require
from ..trace import spanned

FILTER_NAME = "PackRGB"


def _pack(r, g, b, is_rgb24: bool):
    r64, g64, b64 = (p.to(torch.int64) for p in (r, g, b))
    if is_rgb24:
        packed = b64 | (g64 << 8) | (r64 << 16) | 0xFF000000
    else:
        packed = b64 | (g64 << 10) | (r64 << 20) | (0b11 << 30)
    return packed.to(torch.uint32)


@spanned("vszip.op.packrgb")
def packrgb(clip: Clip) -> Clip:
    fmt = clip.format
    is_rgb24 = fmt.name == "RGB24"
    require(
        fmt.name in ("RGB24", "RGB30"),
        FILTER_NAME, "only RGB24 and RGB30 inputs are supported!",
    )
    r, g, b = clip.planes
    return Clip((_pack(r, g, b, is_rgb24),), get_format("GRAY32"), dict(clip.props))
