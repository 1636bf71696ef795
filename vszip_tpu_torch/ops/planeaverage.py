"""PlaneAverage: per-plane average with exclude list (+ optional diff vs a
second clip).

The PyTorch counterpart of ``vszip_tpu.ops.planeaverage`` (reference
src/filters/planeaverage.zig + src/vapoursynth/planeaverage.zig).  Sums run
in f64: integer sums are exact (every sum < 2^53) and normalize by
``2^bits - 1``; float sums depend on the summation order (within rtol 1e-12
of the JAX package's).  ``exclude`` values are dropped from the average (but
not from the diff denominator).  Results are frame props ``{prop}Avg`` /
``{prop}Diff``, shaped (N, planes processed), on a copy of clipa; default
planes = [0].  Scalar divisions divide by device tensors (on CUDA, torch
divides by a host scalar through its reciprocal).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, compare_clips, parse_planes
from ..trace import spanned

FILTER_NAME = "PlaneAverage"
_F64 = torch.float64


def _f64(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=_F64, device=device)


def _avg_plane(x, exclude_vals, peak: float, is_int: bool):
    v = x.to(_F64)
    if exclude_vals:
        # compare at i32/f32 width like the reference (no wrap-around matches)
        cmp = x.to(torch.int32) if is_int else x.to(torch.float32)
        keep = torch.ones(x.shape, dtype=torch.bool, device=x.device)
        for e in exclude_vals:
            keep &= cmp != e
        total = keep.sum(dim=(1, 2)).to(_F64)
        acc = torch.where(keep, v, 0.0).sum(dim=(1, 2))
    else:
        total = torch.full((x.shape[0],), float(x.shape[1] * x.shape[2]), dtype=_F64,
                           device=x.device)
        acc = v.sum(dim=(1, 2))
    avg = torch.where(total == 0, 0.0, acc / torch.clamp(total, min=1.0))
    if is_int:
        avg = avg / _f64(peak, x.device)
    return avg


def _diff_plane(x, ref, peak: float, is_int: bool):
    wide = torch.int32 if is_int else torch.float32
    d = (x.to(wide) - ref.to(wide)).abs_().to(_F64)
    diff = d.sum(dim=(1, 2)) / _f64(float(x.shape[1] * x.shape[2]), x.device)
    if is_int:
        diff = diff / _f64(peak, x.device)
    return diff


@spanned("vszip.op.plane_average")
def plane_average(clipa: Clip, exclude=None, clipb: Clip | None = None,
                  planes=None, prop: str = "psm") -> Clip:
    fmt = clipa.format
    is_int = fmt.sample_type is SampleType.INTEGER
    if clipb is not None:
        compare_clips([clipa, clipb], FILTER_NAME, same_len=False, bigger_than=True)
    process = parse_planes(planes, fmt.num_planes, FILTER_NAME, default_all=False)
    if planes is None:
        process = [True] + [False] * (fmt.num_planes - 1)

    if exclude is not None and is_int and fmt.bits_per_sample == 32:
        raise VSZipError(
            f"{FILTER_NAME}: exclude is not supported for 32-bit integer clips."
        )
    # the JAX package holds the values as int64 (floats: f32) and compares at
    # int32 (f32) width
    ex = ([int(np.int64(int(e)).astype(np.int32)) for e in (exclude or [])] if is_int
          else [float(np.float32(float(e))) for e in (exclude or [])])
    peak = float((1 << fmt.bits_per_sample) - 1) if is_int else 1.0

    avgs, diffs = [], []
    n = clipa.num_frames
    for p in range(fmt.num_planes):
        if not process[p]:
            continue
        avgs.append(_avg_plane(clipa.planes[p], ex, peak, is_int))
        if clipb is not None:
            diffs.append(_diff_plane(clipa.planes[p], clipb.planes[p][:n], peak, is_int))

    props = {f"{prop}Avg": torch.stack(avgs, dim=-1)}
    if clipb is not None:
        props[f"{prop}Diff"] = torch.stack(diffs, dim=-1)
    return clipa.with_props(**props)
