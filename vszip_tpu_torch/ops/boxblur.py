"""BoxBlur: separable box blur with the reference's exact dual-path semantics.

The PyTorch counterpart of ``vszip_tpu.ops.boxblur``, with the same
validation messages, dispatch rule and arithmetic:

* Runtime path (reference src/filters/boxblur_runtime.zig): H passes then V
  passes.  Integer passes are the fixed-point running box sum with the
  duplicate-edge mirror, in the kernels of ``kernels/boxblur.py``.  Float
  single passes evaluate an f32 tap ladder; float multipass runs every pass
  of both axes through the reference's sliding f32 accumulator, bit for bit.
* Comptime path (reference src/filters/boxblur_comptime.zig, selected when
  hradius==vradius<=22 and 1 pass each): integer planes take the fused
  comptime kernel; float planes a direct FIR in both axes with the hybrid
  mirror, f16 narrowing between the axes.

Dispatch rule (reference src/vapoursynth/boxblur.zig:188):
``use_rt = hradius != vradius or hradius > 22 or hpasses > 1 or vpasses > 1``
(including the quirk that the comptime path ignores pass counts, so e.g.
hpasses=0 with hradius==vradius still blurs both axes).

Float add order is part of the result: every sum below is a separate torch
op in the JAX package's order, and eager torch ops do not contract into FMA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, parse_planes, require
from ..kernels import boxblur as kernels
from ..trace import spanned

FILTER_NAME = "BoxBlur"


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=device)


def _dup_taps(x: torch.Tensor, radius: int, axis: int):
    """The 2r+1 shifted views of `x` along `axis` under the duplicate-edge
    mirror, offsets -r .. r in ascending order."""
    n = x.shape[axis]
    xp = x.index_select(axis, kernels.dup_index(n, radius, x.device))
    for off in range(-radius, radius + 1):
        yield xp.narrow(axis, off + radius, n)


def _hybrid_taps(x: torch.Tensor, radius: int, axis: int):
    """The 2r+1 shifted views under the comptime hybrid mirror."""
    n = x.shape[axis]
    for off in range(-radius, radius + 1):
        yield x.index_select(axis, kernels.hybrid_index(n, off, x.device))


def _tap_ladder(taps, div: torch.Tensor) -> torch.Tensor:
    acc = None
    for tap in taps:
        term = div * tap
        acc = term if acc is None else acc + term
    return acc


def _blur_float_rt_1d(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """One float box-mean pass as an f32 tap ladder (the JAX package's
    documented deviation from the reference's running sum; single-pass
    floats only)."""
    div = _f32(1.0 / (2 * radius + 1), x.device)
    acc = _tap_ladder(_dup_taps(x.to(torch.float32), radius, axis), div)
    return acc.to(x.dtype)


def _blur_float_exact_1d(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """One float box-mean pass replicating the reference's sliding f32
    accumulator bit for bit (src/filters/boxblur_runtime.zig blurFloat):
    ``sum = (src[r] + 2*src[0] + ... + 2*src[r-1]) * div``, then for every x
    ``sum += (s1[x] - s2[x]) * div`` with the three-phase mirror schedule.
    The x-sequential dependence is a loop over the axis whose state is every
    row of the batch at once.  f16 accumulates in f32 and narrows per
    output."""
    length = x.shape[axis]
    div = _f32(1.0 / (2 * radius + 1), x.device)
    two = _f32(2.0, x.device)
    xm = x.to(torch.float32).movedim(axis, 0)  # (len, ...)

    init = xm[radius]
    for i in range(radius):  # ascending adds, matching the scalar loop
        init = init + xm[i] * two
    init = init * div

    s1_idx = np.empty(length, np.int64)
    s2_idx = np.empty(length, np.int64)
    for xx in range(length):
        if xx <= radius:
            s1_idx[xx], s2_idx[xx] = radius + xx, radius - xx
        elif xx < length - radius:
            s1_idx[xx], s2_idx[xx] = radius + xx, xx - radius - 1
        else:
            s1_idx[xx] = 2 * length - radius - xx - 1
            s2_idx[xx] = xx - radius - 1
    s1 = torch.from_numpy(s1_idx).to(x.device)
    s2 = torch.from_numpy(s2_idx).to(x.device)
    deltas = (xm.index_select(0, s1) - xm.index_select(0, s2)) * div

    out = torch.empty_like(deltas)
    s = init
    for xx in range(length):
        s = s + deltas[xx]
        out[xx] = s
    return out.movedim(0, axis).to(x.dtype)


def _rt_blur(x: torch.Tensor, hradius: int, hpasses: int, vradius: int,
             vpasses: int, is_int: bool) -> torch.Tensor:
    hb = hradius > 0 and hpasses > 0
    vb = vradius > 0 and vpasses > 0
    if is_int:
        if hb:
            x = kernels.rt_blur_h(x, hradius, hpasses)
        if vb:
            x = (kernels.rt_blur_v_multi(x, vradius, vpasses) if vpasses > 1
                 else kernels.rt_blur_v(x, vradius))
        return x
    # float multipass: the reference's sliding-accumulator rounding compounds
    # per pass, so every pass of both axes takes the bit-exact accumulator
    blur1d = (_blur_float_exact_1d if hpasses > 1 or vpasses > 1
              else _blur_float_rt_1d)
    if hb:
        for _ in range(hpasses):
            x = blur1d(x, hradius, 2)
    if vb:
        for _ in range(vpasses):
            x = blur1d(x, vradius, 1)
    return x


def _ct_blur_float(x: torch.Tensor, radius: int) -> torch.Tensor:
    # Reference accumulates acc += div * tap in f32, tap order k=0..ksize-1,
    # in BOTH axes (vBlurFloat then hBlurFloat).
    div = _f32(1.0 / (2 * radius + 1), x.device)
    acc = _tap_ladder(_hybrid_taps(x.to(torch.float32), radius, 1), div)
    tmp = acc.to(x.dtype).to(torch.float32)  # f16 narrows between axes
    return _tap_ladder(_hybrid_taps(tmp, radius, 2), div).to(x.dtype)


@spanned("vszip.op.boxblur.plane", profiled=False)
def _boxblur_plane(x: torch.Tensor, use_rt: bool, hradius: int, hpasses: int,
                   vradius: int, vpasses: int, is_int: bool) -> torch.Tensor:
    if is_int:
        x = x.contiguous()
    if use_rt:
        return _rt_blur(x, hradius, hpasses, vradius, vpasses, is_int)
    if is_int:
        return kernels.ct_blur_int(x, hradius)
    return _ct_blur_float(x, hradius)


@spanned("vszip.op.boxblur.derive", profiled=False)
def _derive(clip: Clip, planes, hradius, hpasses, vradius, vpasses):
    """Validate the call; (planes to process, hradius, hpasses, vradius,
    vpasses, the runtime path?, integer samples?)."""
    fmt = clip.format
    require(
        not (fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 32),
        FILTER_NAME, "not supported Int format.",
    )
    process = parse_planes(planes, fmt.num_planes, FILTER_NAME)
    hradius, vradius = int(hradius), int(vradius)
    hpasses, vpasses = int(hpasses), int(vpasses)
    require(hradius >= 0 and vradius >= 0, FILTER_NAME, "radius must be >= 0")

    vb = vradius > 0 and vpasses > 0
    hb = hradius > 0 and hpasses > 0
    require(vb or hb, FILTER_NAME, "nothing to be performed")

    for p in range(fmt.num_planes):
        if not process[p]:
            continue
        pw, ph = clip.plane_dims(p)
        if hb and 2 * hradius >= pw:
            raise VSZipError(
                f"{FILTER_NAME}: hradius too large; 2*hradius must be < the "
                "(smallest processed) plane width."
            )
        if vb and 2 * vradius >= ph:
            raise VSZipError(
                f"{FILTER_NAME}: vradius too large; 2*vradius must be < the "
                "(smallest processed) plane height."
            )

    use_rt = (hradius != vradius) or (hradius > 22) or (hpasses > 1) or (vpasses > 1)
    is_int = fmt.sample_type is SampleType.INTEGER
    return process, hradius, hpasses, vradius, vpasses, use_rt, is_int


@spanned("vszip.op.boxblur")
def boxblur(clip: Clip, planes=None, hradius: int = 1, hpasses: int = 1,
            vradius: int = 1, vpasses: int = 1) -> Clip:
    """vszip.BoxBlur equivalent (reference src/vapoursynth/boxblur.zig:131)."""
    process, hradius, hpasses, vradius, vpasses, use_rt, is_int = _derive(
        clip, planes, hradius, hpasses, vradius, vpasses)
    out = []
    for p, x in enumerate(clip.planes):
        if not process[p]:
            out.append(x)
            continue
        out.append(
            _boxblur_plane(x, use_rt, hradius, hpasses, vradius, vpasses, is_int)
        )
    return clip.with_planes(out)
