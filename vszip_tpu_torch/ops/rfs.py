"""RFS: replace-frame-selector.

The PyTorch counterpart of ``vszip_tpu.ops.rfs`` (reference
src/vapoursynth/rfs.zig): a boolean per-frame table selects clipb over
clipa; an optional ``planes`` subset restricts replacement to those planes
(a per-plane select).  ``mismatch=True`` allows dimension/format divergence:
the reference wipes the output VideoInfo to variable format and serves
frames wholesale from either source; here that returns a ``VariableClip``
lazy union (see core.clip), since ragged frames can't share one tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.clip import Clip, VariableClip
from ..core.params import VSZipError, parse_planes
from ..trace import spanned

FILTER_NAME = "RFS"

# torch's where takes every signed integer type on every device; unsigned
# planes are selected through a view of the same width
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def _replace_table(frames, num_frames: int) -> np.ndarray:
    replace = np.zeros(num_frames, bool)
    for f in frames or []:
        f = int(f)
        if f < 0:
            raise VSZipError(
                f"{FILTER_NAME}: frame index ({f}) must be non-negative."
            )
        if f >= num_frames:
            raise VSZipError(
                f"{FILTER_NAME}: frame index ({f}) > last frame index "
                f"({num_frames - 1})."
            )
        replace[f] = True
    return replace


def _select(rep, b, a):
    view = _SIGNED.get(a.dtype)
    if view is None:
        return torch.where(rep, b, a)
    return torch.where(rep, b.view(view), a.view(view)).view(a.dtype)


@spanned("vszip.op.rfs")
def rfs(clipa: Clip, clipb: Clip, frames=None, planes=None,
        mismatch: bool = False):
    dims_match = (clipa.width, clipa.height) == (clipb.width, clipb.height)
    fmt_match = clipa.format == clipb.format
    if not dims_match and not mismatch:
        raise VSZipError(
            f"{FILTER_NAME}: Clip dimensions don't match, enable mismatch if "
            "you want variable format."
        )
    if not fmt_match and not mismatch:
        raise VSZipError(
            f"{FILTER_NAME}: Clip formats don't match, enable mismatch if "
            "you want variable format."
        )

    num_frames = clipa.num_frames
    replace = _replace_table(frames, num_frames)

    if planes is not None:
        sel = parse_planes(planes, clipa.format.num_planes, FILTER_NAME)
    else:
        sel = [True] * clipa.format.num_planes

    if dims_match and fmt_match:
        # Fixed-format path (identical under mismatch=True: the reference
        # only wipes VideoInfo fields that actually diverge).
        rep = torch.from_numpy(replace).to(clipa.planes[0].device).view(-1, 1, 1)
        out = []
        for p in range(clipa.format.num_planes):
            a = clipa.planes[p]
            if not sel[p]:
                out.append(a)
                continue
            out.append(_select(rep, clipb.planes[p][:num_frames], a))
        return clipa.with_planes(out)

    # Variable-format path.  A planes subset would need ShufflePlanes over
    # incompatible clips, which the reference's create-time invoke rejects.
    if planes is not None and not all(sel):
        raise VSZipError(
            f"{FILTER_NAME}: planes subset requires matching clip formats."
        )
    table = [
        (1, min(n, clipb.num_frames - 1)) if replace[n] else (0, n)
        for n in range(num_frames)
    ]
    return VariableClip((clipa, clipb), table)
