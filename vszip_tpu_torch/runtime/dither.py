"""ctypes binding for the native error-diffusion demote (zimg
``dither_type="error_diffusion"`` semantics; ``runtime/native/dither.cpp``,
a copy of the JAX package's).

Deband's <16-bit round trip uses it on the host, one frame at a time.  The
op takes the native library or raises: a failed build is an error, not a
reason to run the sequential loop in Python.  ``_error_diffusion_py`` is
the plain version the tests hold the library against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build

_DEMOTE = _build.entry("dither", "vszip_error_diffusion_u16", ctypes.POINTER(ctypes.c_uint16),
                       ctypes.POINTER(ctypes.c_uint16), ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_float, ctypes.c_int32, restype=None)


def _error_diffusion_py(plane: np.ndarray, scale: float, peak: int) -> np.ndarray:
    f32 = np.float32
    h, w = plane.shape
    out = np.empty((h, w), np.uint16)
    err_top = np.zeros(w + 2, f32)
    err_cur = np.zeros(w + 2, f32)
    c7, c5, c3, c1 = (f32(7 / 16), f32(5 / 16), f32(3 / 16), f32(1 / 16))
    xs_all = plane.astype(f32) * f32(scale)
    for i in range(h):
        xs = xs_all[i]
        err_left = f32(0.0)
        for j in range(w):
            je = j + 1
            err = f32(err_left * c7)
            err = f32(err + f32(err_top[je + 1] * c3))
            err = f32(err + f32(err_top[je] * c5))
            err = f32(err + f32(err_top[je - 1] * c1))
            x = f32(xs[j] + err)
            q = min(max(int(np.rint(x)), 0), peak)
            e = f32(x - f32(q))
            err_left = e
            err_cur[je] = e
            out[i, j] = q
        err_top, err_cur = err_cur, err_top
    return out


def error_diffusion_demote(plane: np.ndarray, scale: float, peak: int) -> np.ndarray:
    """Demote one (H, W) uint16 plane with FS error diffusion (u16 out)."""
    plane = np.ascontiguousarray(plane, np.uint16)
    h, w = plane.shape
    out = np.empty((h, w), np.uint16)
    _DEMOTE(
        plane.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        w, h, ctypes.c_float(scale), peak,
    )
    return out
