"""Video format model for the PyTorch port.

The same ``VideoFormat``/``get_format`` registry as ``vszip_tpu.core.format``
(VapourSynth-style preset names, the reference's byte-width storage model:
8-bit -> uint8, 9..16-bit -> uint16, 32-bit int -> uint32, half -> float16,
single -> float32), carried over as its own module because importing
``vszip_tpu`` pulls in JAX.  ``torch_dtype`` is the tensor dtype planes of a
format are stored as; ``storage_dtype`` stays the NumPy dtype.
"""

from __future__ import annotations

import dataclasses
import enum
from functools import lru_cache

import numpy as np
import torch


class ColorFamily(enum.Enum):
    GRAY = "GRAY"
    YUV = "YUV"
    RGB = "RGB"


class SampleType(enum.Enum):
    INTEGER = "INTEGER"
    FLOAT = "FLOAT"


class ColorRange(enum.Enum):
    FULL = "FULL"
    LIMITED = "LIMITED"


# Bit depths accepted by the reference's BPSType.select
# (reference src/helper.zig:25-56).
_VALID_INT_BITS = (8, 9, 10, 12, 14, 16, 32)
_VALID_FLOAT_BITS = (16, 32)

_TORCH_DTYPES = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
}


@dataclasses.dataclass(frozen=True)
class VideoFormat:
    """Constant per-clip pixel format.  Hashable."""

    color_family: ColorFamily
    sample_type: SampleType
    bits_per_sample: int
    subsampling_w: int = 0
    subsampling_h: int = 0

    def __post_init__(self):
        valid = (
            _VALID_INT_BITS
            if self.sample_type is SampleType.INTEGER
            else _VALID_FLOAT_BITS
        )
        if self.bits_per_sample not in valid:
            raise ValueError(
                f"unsupported {self.sample_type.value} bit depth "
                f"{self.bits_per_sample}"
            )
        if self.color_family is not ColorFamily.YUV and (
            self.subsampling_w or self.subsampling_h
        ):
            raise ValueError("only YUV formats may be subsampled")

    # -- derived properties -------------------------------------------------

    @property
    def num_planes(self) -> int:
        return 1 if self.color_family is ColorFamily.GRAY else 3

    @property
    def bytes_per_sample(self) -> int:
        if self.sample_type is SampleType.FLOAT:
            return 2 if self.bits_per_sample == 16 else 4
        if self.bits_per_sample == 8:
            return 1
        return 2 if self.bits_per_sample <= 16 else 4

    @property
    def storage_dtype(self) -> np.dtype:
        """NumPy dtype planes of this format are stored as."""
        if self.sample_type is SampleType.FLOAT:
            return np.dtype(np.float16 if self.bits_per_sample == 16 else np.float32)
        return np.dtype({1: np.uint8, 2: np.uint16, 4: np.uint32}[self.bytes_per_sample])

    @property
    def torch_dtype(self) -> torch.dtype:
        """Tensor dtype planes of this format are stored as."""
        return _TORCH_DTYPES[self.storage_dtype]

    @property
    def name(self) -> str:
        fam = self.color_family
        if fam is ColorFamily.GRAY:
            if self.sample_type is SampleType.FLOAT:
                return "GRAYH" if self.bits_per_sample == 16 else "GRAYS"
            return f"GRAY{self.bits_per_sample}"
        if fam is ColorFamily.RGB:
            if self.sample_type is SampleType.FLOAT:
                return "RGBH" if self.bits_per_sample == 16 else "RGBS"
            return f"RGB{self.bits_per_sample * 3}"
        ss = {(1, 1): "420", (1, 0): "422", (0, 0): "444", (2, 2): "410", (2, 0): "411", (0, 1): "440"}[
            (self.subsampling_w, self.subsampling_h)
        ]
        if self.sample_type is SampleType.FLOAT:
            return f"YUV{ss}P" + ("H" if self.bits_per_sample == 16 else "S")
        return f"YUV{ss}P{self.bits_per_sample}"

    def replace(self, **kw) -> "VideoFormat":
        return dataclasses.replace(self, **kw)

    def plane_dims(self, width: int, height: int, plane: int) -> tuple[int, int]:
        """(w, h) of `plane` for a clip of the given luma dimensions."""
        if plane == 0 or self.color_family is not ColorFamily.YUV:
            return width, height
        return width >> self.subsampling_w, height >> self.subsampling_h

    # -- peak / lowest / histogram helpers (reference src/helper.zig:217-304)

    def peak_value(self, chroma: bool = False, range_: ColorRange = ColorRange.FULL) -> float:
        if self.sample_type is SampleType.FLOAT:
            return 0.5 if chroma else 1.0
        if range_ is ColorRange.LIMITED:
            return float((240 if chroma else 235) << (self.bits_per_sample - 8))
        return float((1 << self.bits_per_sample) - 1)

    def lowest_value(self, chroma: bool = False, range_: ColorRange = ColorRange.FULL) -> float:
        if self.sample_type is SampleType.FLOAT:
            return -0.5 if chroma else 0.0
        if range_ is ColorRange.LIMITED:
            return float(16 << (self.bits_per_sample - 8))
        return 0.0

    def hist_len(self) -> int:
        """Histogram bin count (reference src/helper.zig:217-223)."""
        if self.sample_type is SampleType.INTEGER:
            return 1 << self.bits_per_sample
        return 65536


@lru_cache(maxsize=1)
def _registry() -> dict[str, VideoFormat]:
    G, Y, R = ColorFamily.GRAY, ColorFamily.YUV, ColorFamily.RGB
    I, F = SampleType.INTEGER, SampleType.FLOAT
    fmts: dict[str, VideoFormat] = {}
    for bits in _VALID_INT_BITS:
        fmts[f"GRAY{bits}"] = VideoFormat(G, I, bits)
    fmts["GRAYH"] = VideoFormat(G, F, 16)
    fmts["GRAYS"] = VideoFormat(G, F, 32)
    for ss_name, (ssw, ssh) in {
        "420": (1, 1), "422": (1, 0), "444": (0, 0),
        "410": (2, 2), "411": (2, 0), "440": (0, 1),
    }.items():
        for bits in (8, 9, 10, 12, 14, 16):
            fmts[f"YUV{ss_name}P{bits}"] = VideoFormat(Y, I, bits, ssw, ssh)
        fmts[f"YUV{ss_name}PH"] = VideoFormat(Y, F, 16, ssw, ssh)
        fmts[f"YUV{ss_name}PS"] = VideoFormat(Y, F, 32, ssw, ssh)
    fmts["RGB24"] = VideoFormat(R, I, 8)
    fmts["RGB27"] = VideoFormat(R, I, 9)
    fmts["RGB30"] = VideoFormat(R, I, 10)
    fmts["RGB36"] = VideoFormat(R, I, 12)
    fmts["RGB42"] = VideoFormat(R, I, 14)
    fmts["RGB48"] = VideoFormat(R, I, 16)
    fmts["RGBH"] = VideoFormat(R, F, 16)
    fmts["RGBS"] = VideoFormat(R, F, 32)
    return fmts


def get_format(name: str) -> VideoFormat:
    """Look up a preset format by its VapourSynth-style name (e.g. YUV420P16)."""
    try:
        return _registry()[name]
    except KeyError:
        raise KeyError(f"unknown preset format {name!r}") from None


def __getattr__(name: str):
    # Allow `formats.YUV420P16` style access.
    reg = _registry()
    if name in reg:
        return reg[name]
    raise AttributeError(name)
