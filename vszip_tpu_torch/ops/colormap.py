"""ColorMap: Gray8 -> RGB24 pseudo-color via the 22 OpenCV colormaps.

The PyTorch counterpart of ``vszip_tpu.ops.colormap`` (reference
src/filters/color_map.zig + src/vapoursynth/color_map.zig).  The anchor
tables (public OpenCV colormap data, 9..510 f32 anchors per channel) live in
colormap_data.npz beside this module; create-time they are resampled on the
host to a 256-entry u8 LUT per channel with linear interpolation and
``trunc(v*255 + 0.5)`` rounding, then each output plane is one indexed load
``lut[x]``.  Output carries RGB24 full-range props (_Matrix RGB, _Transfer
sRGB, _Primaries BT709, _ColorRange FULL).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import get_format
from ..core.params import VSZipError
from ..trace import spanned

FILTER_NAME = "ColorMap"

COLOR_NAMES = [
    "autumn", "bone", "jet", "winter", "rainbow", "ocean", "summer",
    "spring", "cool", "hsv", "pink", "hot", "parula", "magma", "inferno",
    "plasma", "viridis", "cividis", "twilight", "twilight_shifted", "turbo",
    "deepgreen",
]


@lru_cache(maxsize=1)
def _tables():
    return dict(np.load(Path(__file__).with_name("colormap_data.npz")))


@lru_cache(maxsize=32)
def _lut(color: int) -> np.ndarray:
    """(3, 256) uint8: the R, G and B tables of colormap `color`."""
    anchors = _tables()[COLOR_NAMES[color]]
    n = anchors.shape[1]
    lut = np.zeros((3, 256), np.uint8)
    for i in range(256):
        p = np.float32(i) * np.float32(n - 1) / np.float32(255.0)
        lo = int(np.floor(p))
        hi = min(lo + 1, n - 1)
        frac = np.float32(p - lo)
        for c in range(3):
            v = anchors[c, lo] + (anchors[c, hi] - anchors[c, lo]) * frac
            lut[c, i] = np.trunc(v * np.float32(255.0) + np.float32(0.5))
    return lut


@spanned("vszip.op.colormap")
def colormap(clip: Clip, color: int = 20) -> Clip:
    if clip.format.name != "GRAY8":
        raise VSZipError(f"{FILTER_NAME}: only Gray8 format is supported.")
    if color < 0 or color > 21:
        raise VSZipError(f'{FILTER_NAME}: "color" should be between 0 and 21.')
    x = clip.planes[0]
    lut = torch.from_numpy(_lut(int(color))).to(x.device)
    idx = x.to(torch.int64)
    r, g, b = (lut[c][idx] for c in range(3))
    props = dict(clip.props)
    props.update(_Matrix=0, _Transfer=13, _Primaries=1, _ColorRange=0)
    return Clip((r, g, b), get_format("RGB24"), props)
