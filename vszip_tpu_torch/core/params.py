"""Parameter validation mirroring the reference's arg helpers.

The same helpers, with the same message text, as ``vszip_tpu.core.params``:
``mapGetPlanes`` (reference src/helper.zig:128-158), ``getArray`` /
``Maps.getArray`` (src/helper.zig:340-452), ``compareNodes``
(src/helper.zig:166-215) and ``scaleValue`` (src/helper.zig:306-338).  All of it is plain Python that runs before any
tensor is touched, so the kernels only ever see pre-checked parameters.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np

from .format import ColorRange, SampleType

if TYPE_CHECKING:
    from .clip import Clip


class VSZipError(ValueError):
    """Create-time validation error (reference: map.setError + null return)."""


def require(cond: bool, filter_name: str, msg: str) -> None:
    if not cond:
        raise VSZipError(f"{filter_name}: {msg}")


def parse_planes(planes, num_planes: int, filter_name: str,
                 default_all: bool = True) -> list[bool]:
    """planes arg -> [bool] per plane (reference src/helper.zig:128-158)."""
    if planes is None:
        return [default_all] * num_planes
    if isinstance(planes, (int, np.integer)):
        planes = [planes]
    process = [False] * num_planes
    for e in planes:
        e = int(e)
        if e < 0 or e >= num_planes:
            raise VSZipError(f"{filter_name}: plane index out of range")
        if process[e]:
            raise VSZipError(f"{filter_name}: plane specified twice.")
        process[e] = True
    return process


def get_value(value, key: str, default, min_, max_, filter_name: str):
    """Range-checked scalar (reference Maps.getValue, src/helper.zig:419-429)."""
    if value is None:
        value = default
    if value < min_ or value > max_:
        raise VSZipError(
            f'{filter_name}: parameter "{key}={value}" out of range [{min_}..{max_}].'
        )
    return value


def get_array(value, key: str, default, min_, max_, filter_name: str,
              max_len: int = 3) -> list:
    """Per-plane array with last-element broadcast
    (reference getArray/Maps.getArray, src/helper.zig:340-452):
    at most `max_len` elements; missing entries repeat the last; each
    element range-checked."""
    if value is None:
        if isinstance(default, (list, tuple)):
            value = list(default)
        else:
            value = [default]
    elif not isinstance(value, (list, tuple)):
        value = [value]
    else:
        value = list(value)
    if len(value) > max_len:
        raise VSZipError(
            f'{filter_name}: parameter "{key}" has too many elements '
            f"(got {len(value)}, max {max_len})."
        )
    out = []
    for i in range(max_len):
        v = value[min(i, len(value) - 1)]
        if v < min_ or v > max_:
            raise VSZipError(
                f'{filter_name}: parameter "{key}[{i}]={v}" out of range '
                f"[{min_}..{max_}]."
            )
        out.append(v)
    return out


def compare_clips(clips: Sequence["Clip"], filter_name: str,
                  same_len: bool = True, bigger_than: bool = False) -> None:
    """Clip-compatibility checks (reference compareNodes,
    src/helper.zig:166-215)."""
    c0 = clips[0]
    for c in clips[1:]:
        if c is None:
            continue
        if (c0.width, c0.height) != (c.width, c.height):
            raise VSZipError(
                f"{filter_name}: all input clips must have the same width and height."
            )
        if c0.format.color_family is not c.format.color_family:
            raise VSZipError(
                f"{filter_name}: all input clips must have the same color family."
            )
        if (c0.format.subsampling_w, c0.format.subsampling_h) != (
            c.format.subsampling_w,
            c.format.subsampling_h,
        ):
            raise VSZipError(
                f"{filter_name}: all input clips must have the same subsampling."
            )
        if c0.format.bits_per_sample != c.format.bits_per_sample:
            raise VSZipError(
                f"{filter_name}: all input clips must have the same bit depth."
            )
        if same_len and c0.num_frames != c.num_frames:
            raise VSZipError(
                f"{filter_name}: all input clips must have the same length."
            )
        if bigger_than and c0.num_frames > c.num_frames:
            raise VSZipError(
                f"{filter_name}: second clip has less frames than input clip."
            )


def scale_value(value: float, clip: "Clip", depth_in: int = 8, chroma: bool = False,
                sample_type_in: SampleType = SampleType.INTEGER,
                color_range=None) -> float:
    """8-bit-scale parameter -> clip depth (reference scaleValue,
    src/helper.zig:306-338): scales by (peak-lowest) ratio in the clip's
    color range, rounds+clamps for integer outputs.  `color_range` overrides
    the frame-prop probe when a filter's measured behavior pins it (see
    limit_filter)."""
    fmt_out = clip.format
    # reference compares bit depths only (src/helper.zig:322-324)
    if depth_in == fmt_out.bits_per_sample:
        return float(value)
    fmt_in = fmt_out.replace(bits_per_sample=depth_in, sample_type=sample_type_in,
                             subsampling_w=0, subsampling_h=0)
    rng = clip.color_range() if color_range is None else color_range
    in_peak = fmt_in.peak_value(chroma, rng)
    in_low = fmt_in.lowest_value(chroma, rng)
    out_peak = fmt_out.peak_value(chroma, rng)
    out_low = fmt_out.lowest_value(chroma, rng)
    out = float(value) * (out_peak - out_low) / (in_peak - in_low)
    if fmt_out.sample_type is SampleType.INTEGER:
        out = max(min(round(out), fmt_out.peak_value(False, ColorRange.FULL)), 0)
    return float(out)
