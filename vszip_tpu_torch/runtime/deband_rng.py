"""ctypes binding for the native Deband RNG precompute
(``runtime/native/deband_rng.cpp``, a copy of the JAX package's).

The library is built with g++ into ``build/vszip_tpu_torch/`` at its first
use (``_build``); a failed build raises.  The outputs are NumPy arrays: the
create-time state, which ``ops/deband.py`` places on the device once per
parameter set.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build

_PRECOMPUTE = _build.entry(
    "deband_rng", "vszip_deband_precompute", *[ctypes.c_int32] * 10, *[ctypes.c_double] * 2,
    *[ctypes.c_int32] * 6, *[ctypes.c_float] * 2, *[ctypes.POINTER(ctypes.c_int32)] * 8,
    *[ctypes.POINTER(ctypes.c_int16)] * 2, *[ctypes.POINTER(ctypes.c_float)] * 2,
    ctypes.POINTER(ctypes.c_uint32), restype=None)


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def deband_precompute(w: int, h: int, num_frames: int, seed: int,
                      sample_mode: int, range_: int, ssw: int, ssh: int,
                      algo_ref: int, algo_grain: int, param_ref: float,
                      param_grain: float, is_float: bool, dynamic: bool,
                      add_grain_y: bool, add_grain_c: bool,
                      grain_y, grain_c) -> dict:
    """Returns ref (dy, dx) planes, grain buffers, and grain offsets."""
    cw, ch = w >> ssw, h >> ssh
    # The native loop visits ceil(w / 2^ssw) chroma columns per row: one
    # more than cw when a subsampled dimension is odd.  Room for that keeps
    # it inside the buffer; the first ch*cw values are what it computes.
    room = (ch + 2) * (cw + 1)
    r = {k: np.zeros(h * w, np.int32)
         for k in ("ref1_dy", "ref1_dx", "ref2_dy", "ref2_dx")}
    r.update({k: np.zeros(room, np.int32)
              for k in ("c_ref1_dy", "c_ref1_dx", "c_ref2_dy", "c_ref2_dx")})
    item_count = ((w + 255) & ~127) * h
    total = item_count * (3 if dynamic else 1)
    gyi = np.zeros(total if (add_grain_y and not is_float) else 1, np.int16)
    gci = np.zeros(total if (add_grain_c and not is_float) else 1, np.int16)
    gyf = np.zeros(total if (add_grain_y and is_float) else 1, np.float32)
    gcf = np.zeros(total if (add_grain_c and is_float) else 1, np.float32)
    offs = np.zeros(max(num_frames, 1), np.uint32)

    _PRECOMPUTE(
        w, h, num_frames, np.int32(np.uint32(seed & 0xFFFFFFFF)).item()
        if seed < 0 or seed > 2**31 - 1 else seed,
        sample_mode, range_, ssw, ssh, algo_ref, algo_grain,
        float(param_ref), float(param_grain), int(is_float), int(dynamic),
        int(add_grain_y), int(add_grain_c),
        int(grain_y) if not is_float else 0,
        int(grain_c) if not is_float else 0,
        float(grain_y) if is_float else 0.0,
        float(grain_c) if is_float else 0.0,
        _ptr(r["ref1_dy"], ctypes.c_int32), _ptr(r["ref1_dx"], ctypes.c_int32),
        _ptr(r["ref2_dy"], ctypes.c_int32), _ptr(r["ref2_dx"], ctypes.c_int32),
        _ptr(r["c_ref1_dy"], ctypes.c_int32), _ptr(r["c_ref1_dx"], ctypes.c_int32),
        _ptr(r["c_ref2_dy"], ctypes.c_int32), _ptr(r["c_ref2_dx"], ctypes.c_int32),
        _ptr(gyi, ctypes.c_int16), _ptr(gci, ctypes.c_int16),
        _ptr(gyf, ctypes.c_float), _ptr(gcf, ctypes.c_float),
        _ptr(offs, ctypes.c_uint32),
    )
    for k in ("ref1_dy", "ref1_dx", "ref2_dy", "ref2_dx"):
        r[k] = r[k].reshape(h, w)
    for k in ("c_ref1_dy", "c_ref1_dx", "c_ref2_dy", "c_ref2_dx"):
        r[k] = r[k][: ch * cw].reshape(ch, cw)
    r["grain_y"] = gyf if is_float else gyi
    r["grain_c"] = gcf if is_float else gci
    r["grain_offsets"] = offs
    r["item_count"] = item_count
    return r
