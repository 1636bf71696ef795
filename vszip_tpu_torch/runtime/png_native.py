"""ctypes binding for the native PNG scanline unfilter
(``runtime/native/png_unfilter.cpp``, a copy of the JAX package's).

The library is built with g++ into ``build/vszip_tpu_torch/`` at its first
use (``_build``).  Unlike the JAX package's binding, this one never falls
back to the pure-Python reconstruction: a failed build raises.  The
pure-Python ``io.png._unfilter_py`` is the plain version the tests hold the
library against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build

_UNFILTER = _build.entry("png_unfilter", "vszip_png_unfilter", ctypes.POINTER(ctypes.c_uint8),
                         ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                         ctypes.POINTER(ctypes.c_uint8), restype=ctypes.c_int32)


def unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reconstruct the h x stride scanline bytes of `raw` (h rows of a filter
    byte and `stride` filtered bytes; `bpp` bytes per complete pixel)."""
    src = np.frombuffer(raw, np.uint8, h * (1 + stride))
    out = np.empty((h, stride), np.uint8)
    rc = _UNFILTER(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int32(h), np.int32(stride), np.int32(bpp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise ValueError(f"bad PNG filter type {rc}")
    return out
