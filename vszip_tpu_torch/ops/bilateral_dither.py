"""BilateralDither: flat-kernel bilateral smoother for debanding
(Dither_bilateral16 lineage).

The PyTorch counterpart of ``vszip_tpu.ops.bilateral_dither`` (reference
src/filters/bilateral_dither.zig + bilateral_dither_subspl.zig +
src/vapoursynth/bilateral_dither.zig), with the same validation, messages
and per-plane parameters.  Per pixel a window neighbour weighs ``clamp(m -
|ref_diff|, 0, wmax)`` and the output is ``center + sum(w * diff) /
max(sum_w, sum_w_min)``.  Two paths:

* dense (``1e-3 <= subspl < 4``): every offset of the (2r-1)^2 window, through
  ``kernels.bilateral_dither.dense_blur`` (B17);
* sub-sampled (``subspl >= 4``, or below 1e-3 as the default 0): the
  precomputed point lists of ``bilateral_dither_points.generate``, one list
  per pixel picked by the row's LCG start and advanced every 4 pixels,
  through ``kernels.bilateral_dither.subspl_blur`` (B18).

Either kernel runs on a CUDA tensor at every radius the op allows, and its
plain version on a CPU tensor.  ``m``, ``wmax`` and ``swmin`` are computed in
NumPy f32 exactly as the JAX package does and reach the kernels as f32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, get_array, parse_planes, require
from ..kernels import bilateral_dither as kernels
from ..trace import spanned
from .bilateral_dither_points import NBR_POINT_LISTS, generate, rnd_row_values

FILTER_NAME = "BilateralDither"


@lru_cache(maxsize=32)
def _start_rows(h: int, device: str) -> torch.Tensor:
    """(h,) int32 start list of each row (reference
    bilateral_dither.zig:124-134): the row's LCG value >> 8, modulo 23."""
    rows = rnd_row_values(h)
    start = ((rows >> 8) % NBR_POINT_LISTS).astype(np.int32)
    return torch.from_numpy(start).to(device)


@lru_cache(maxsize=32)
def _table(r: int, subspl: float, device: str) -> tuple[torch.Tensor, int]:
    """The (23, k, 2) int16 (dy, dx) point table and k."""
    pts, k = generate(r, r, subspl)
    return torch.from_numpy(pts.astype(np.int16)).to(device), k


def _f32(v) -> float:
    return float(np.float32(v))


@spanned("vszip.op.bilateral_dither")
def bilateral_dither(clip: Clip, ref: Clip | None = None, radius=None, thr=None, flat=None,
                     wmin=None, subspl=None, planes=None) -> Clip:
    fmt = clip.format
    is_int = fmt.sample_type is SampleType.INTEGER
    if is_int:
        require(8 <= fmt.bits_per_sample <= 16, FILTER_NAME,
                "integer input must be 8..16 bit")
    else:
        require(fmt.bits_per_sample == 32, FILTER_NAME, "float input must be 32 bit")
    radius_a = get_array(radius, "radius", 16, 2, 16384, FILTER_NAME)
    thr_a = get_array(thr, "thr", 2.5, 0.0, 65535.0, FILTER_NAME)
    flat_a = get_array(flat, "flat", 0.4, 0.0, 1.0, FILTER_NAME)
    wmin_a = get_array(wmin, "wmin", 0.0, 0.0, 65535.0, FILTER_NAME)
    subspl_a = get_array(subspl, "subspl", 0.0, 0.0, 4096.0, FILTER_NAME)
    require(clip.width >= 16 and clip.height >= 16, FILTER_NAME, "input must be 16x16 min")
    process = parse_planes(planes, fmt.num_planes, FILTER_NAME)

    scale = float(1 << (fmt.bits_per_sample - 8)) if is_int else 1.0 / 256.0
    unit = 1.0 if is_int else 1.0 / 65535.0
    peak = float((1 << fmt.bits_per_sample) - 1) if is_int else 0.0

    if ref is not None:
        if (ref.format != fmt or ref.width != clip.width or ref.height != clip.height
                or ref.num_frames != clip.num_frames):
            raise VSZipError(
                f'{FILTER_NAME}: "ref" must have the same format and dimensions as "clip"')

    out = []
    for p, x in enumerate(clip.planes):
        if not process[p]:
            out.append(x)
            continue
        pw, ph = clip.plane_dims(p)
        r = int(radius_a[p])
        if pw < r or ph < r:
            raise VSZipError(f'{FILTER_NAME}: picture size must be greater than "radius"')
        thr32 = np.float32(thr_a[p])
        m = _f32(max(float(thr32 * np.float32(scale)), unit))
        wmax = max(float(thr32 * np.float32(1.0 - np.float32(flat_a[p])) * np.float32(scale)),
                   unit)
        x = x.contiguous()
        rp = ref.planes[p].contiguous() if ref is not None else None
        sub = float(subspl_a[p])
        if sub >= 4.0 or sub < 1e-3:
            dyx, k = _table(r, sub, str(x.device))
            swmin = max(float(np.float32(wmin_a[p]) * np.float32(wmax) * np.float32(k)), unit)
            out.append(kernels.subspl_blur(x, rp, r, _start_rows(ph, str(x.device)), dyx, m,
                                           _f32(wmax), _f32(swmin), peak))
        else:
            area = float((2 * r - 1) * (2 * r - 1))
            swmin = max(float(np.float32(wmin_a[p]) * np.float32(wmax) * np.float32(area)),
                        unit)
            out.append(kernels.dense_blur(x, rp, r, m, _f32(wmax), _f32(swmin), peak))
    return clip.with_planes(out)
