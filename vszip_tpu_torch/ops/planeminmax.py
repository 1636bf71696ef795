"""PlaneMinMax: (thresholded) per-plane min/max + optional diff vs clipb.

The PyTorch counterpart of ``vszip_tpu.ops.planeminmax`` (reference
src/filters/planeminmax.zig + src/vapoursynth/planeminmax.zig).  With
``minthr``/``maxthr`` > 0 the reference builds a histogram (floats are binned
at ``u16(v*65535 + 0.5)``, clamped) and walks from each end until the
cumulative count exceeds ``trunc(total*thr)``.  The walk is a monotone
threshold search; as in the JAX package it runs as a vectorized binary search
over the bin range, ``(hist_size+1).bit_length()`` steps of one counting pass
each (identical result).  With both thr 0 it's a plain min/max.  Props
``{prop}Min/Max/Diff`` on a copy of clipa.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import ColorFamily, SampleType
from ..core.params import VSZipError, compare_clips, parse_planes, require
from ..trace import spanned

FILTER_NAME = "PlaneMinMax"
_F64 = torch.float64


def _bin_index(x, is_int: bool):
    if is_int:
        return x.to(torch.int32)
    v = (x.to(torch.float32) * 65535.0).add_(0.5)  # x may be the clip's own f32 plane
    # lossyCast u16: clamp then truncate
    return v.clamp_(0.0, 65535.0).to(torch.int32)


def _minmax_thr(x, hist_size: int, minthr: float, maxthr: float, is_int: bool):
    bins = _bin_index(x, is_int)
    n = x.shape[0]
    dev = x.device
    total = float(x.shape[1] * x.shape[2])
    # reference truncates total * f32(thr) (src/filters/planeminmax.zig:40-41)
    totalmin = float(np.trunc(total * np.float64(np.float32(minthr))))
    totalmax = float(np.trunc(total * np.float64(np.float32(maxthr))))

    # smallest u with count(bins <= u) > totalmin, else peak
    lo = torch.zeros((n,), dtype=torch.int32, device=dev)
    hi = torch.full((n,), hist_size, dtype=torch.int32, device=dev)  # exclusive
    # the search spans hist_size+1 states (the reference's RGB24 minthr=0.1
    # golden needs the last step)
    steps = max(1, (hist_size + 1).bit_length())
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        cnt = (bins <= mid.view(n, 1, 1)).sum(dim=(1, 2))
        ok = cnt > totalmin
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid + 1)
    retmin = torch.clamp(lo, max=hist_size - 1)

    # largest u with count(bins >= u) > totalmax, else 0
    lo2 = torch.full((n,), -1, dtype=torch.int32, device=dev)  # exclusive lower
    hi2 = torch.full((n,), hist_size - 1, dtype=torch.int32, device=dev)
    for _ in range(steps):
        mid = torch.div(lo2 + hi2 + 1, 2, rounding_mode="floor")
        cnt = (bins >= mid.view(n, 1, 1)).sum(dim=(1, 2))
        ok = cnt > totalmax
        lo2 = torch.where(ok, mid, lo2)
        hi2 = torch.where(ok, hi2, mid - 1)
    retmax = torch.clamp(lo2, min=0)
    return retmin, retmax


def _minmax_plain(x):
    # torch has no uint16 min/max reductions on some devices
    w = x.to(torch.int32) if x.dtype == torch.uint16 else x
    return w.amin(dim=(1, 2)).to(x.dtype), w.amax(dim=(1, 2)).to(x.dtype)


def _diff(x, ref, peakf: float, is_int: bool):
    if is_int:
        d = (x.to(_F64) - ref.to(_F64)).abs_()
    else:
        d = (x.to(torch.float32) - ref.to(torch.float32)).abs_().to(_F64)
    diff = d.sum(dim=(1, 2)) / torch.tensor(float(x.shape[1] * x.shape[2]), dtype=_F64,
                                            device=x.device)
    if is_int:
        diff = diff / torch.tensor(peakf, dtype=_F64, device=x.device)
    return diff


@spanned("vszip.op.plane_minmax")
def plane_minmax(clipa: Clip, minthr: float = 0.0, maxthr: float = 0.0,
                 clipb: Clip | None = None, planes=None,
                 prop: str = "psm") -> Clip:
    fmt = clipa.format
    is_int = fmt.sample_type is SampleType.INTEGER
    require(
        not (is_int and fmt.bits_per_sample == 32),
        FILTER_NAME, "not supported Int format.",
    )
    if clipb is not None:
        compare_clips([clipa, clipb], FILTER_NAME, same_len=False, bigger_than=True)
    process = parse_planes(planes, fmt.num_planes, FILTER_NAME, default_all=False)
    if planes is None:
        process = [True] + [False] * (fmt.num_planes - 1)
    for key, thr in (("maxthr", maxthr), ("minthr", minthr)):
        if thr < 0 or thr > 1:
            raise VSZipError(
                f"{FILTER_NAME}: {key} should be a float between 0.0 and 1.0"
            )
    hist_size = 65536 if not is_int else (1 << fmt.bits_per_sample)
    peakf = float(hist_size - 1)
    no_thr = maxthr == 0 and minthr == 0
    do_chroma = any(process[1:])
    if (do_chroma and not no_thr
            and fmt.color_family is ColorFamily.YUV
            and fmt.sample_type is SampleType.FLOAT):
        raise VSZipError(
            f"{FILTER_NAME}: you can't use maxthr/minthr with float chroma, "
            "use planes=[0] or maxthr/minthr=0"
        )

    mins, maxs, diffs = [], [], []
    n = clipa.num_frames
    for p in range(fmt.num_planes):
        if not process[p]:
            continue
        x = clipa.planes[p]
        if no_thr:
            mi, ma = _minmax_plain(x)
            if fmt.sample_type is SampleType.FLOAT:
                mi, ma = mi.to(torch.float32), ma.to(torch.float32)
        else:
            mi, ma = _minmax_thr(x, hist_size, float(minthr), float(maxthr), is_int)
            if not is_int:
                scale = torch.tensor(65535.0, dtype=torch.float32, device=x.device)
                mi = mi.to(torch.float32) / scale
                ma = ma.to(torch.float32) / scale
        mins.append(mi)
        maxs.append(ma)
        if clipb is not None:
            diffs.append(_diff(x, clipb.planes[p][:n], peakf, is_int))

    props = {
        f"{prop}Min": torch.stack(mins, dim=-1),
        f"{prop}Max": torch.stack(maxs, dim=-1),
    }
    if clipb is not None:
        props[f"{prop}Diff"] = torch.stack(diffs, dim=-1)
    return clipa.with_props(**props)
