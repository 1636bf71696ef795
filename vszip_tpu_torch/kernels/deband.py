"""Deband centre kernels: CUDA wrappers, their plain PyTorch versions, and
launch counters.

Each wrapper takes the plane ``x`` as an ``(N, H, W)`` uint16 tensor at the
16-bit internal depth and one ``(H, W)`` int32 offset plane shared by all
frames, and returns the mode's pre-grain centre as ``(N, H, W)`` int32.  It
dispatches on the tensor's device:

* a CPU tensor takes the plain PyTorch version beside the wrapper;
* a CUDA tensor launches the hand-written kernel in ``csrc/deband.cu`` or
  raises.  Nothing falls back to the plain version.

====================  ===========================================  ==============
wrapper               replaces                                     CUDA kernel
====================  ===========================================  ==============
``deband_center``     ``deband_center_pallas``                     center_kernel
                      (vszip_tpu/kernels/deband_pallas.py:85)
``deband_m2_center``  ``deband_m2_center_pallas``                  m2_tile_kernel
                      (vszip_tpu/kernels/deband_m2_pallas.py:119)  (m2_kernel)
====================  ===========================================  ==============

Both compute the same function as their TPU kernel, with the same
signature, and define what a tap outside the plane reads as the JAX
package's CPU path does: ``deband_center`` reads 0 there (its zero-padded
``_sep_taps``), ``deband_m2_center`` clamps the coordinate into the plane
(its ``_gather``).  Luma offsets never leave the plane (they are bounded by
the edge distances); 4:2:2 chroma in modes 4-6 does, because the JAX
package takes the row magnitude for the column taps there too.  The TPU
kernels' limits (``rmax <= 16``, ``w >= 128``, 64-row bands with 16-row
halos, the select chains over the offset alphabet, u32 frame pairing) are
TPU workarounds and are not carried over: on Hopper a tap is an indexed
load.  ``m2_tile_kernel`` stages a 64x64 tile with its halo of rmax rows and
columns in shared memory, at plane-clamped coordinates, two frames to a
32-bit position, and reads the four taps there; past the range whose tiles
fit a block's shared memory (``m2_on_chip``: rmax > 50) the wrapper takes
``m2_kernel``, whose taps are loads from device memory.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, trace

# Launches made on the CUDA path, per wrapper.  Each wrapper adds one where
# it launches its kernel and nowhere else; the plain versions never count.
LAUNCHES = trace.register_launches({"deband_center": 0, "deband_m2_center": 0})

SEPARABLE_MODES = (1, 3, 4, 5, 6)

# ``m2_tile`` (csrc/deband.cu) holds a tile of (M2_TILE_Y + 2 rmax) x
# (M2_TILE_X + 2 pad) positions, pad = rmax rounded up to 8 columns, for two
# frames at a time, 8 bytes a position (the pair's 32-bit tile and the next
# pair's two 16-bit tiles), at most _build.MAX_SMEM_BYTES a block (the kernel's
# kM2TileY, kM2TileX, M2Tile and kMaxSmemBytes).
M2_TILE_Y = 64
M2_TILE_X = 64


def m2_tile_shape(rmax: int) -> tuple[int, int]:
    """(rows, columns) of the tiles ``m2_tile`` stages at `rmax`."""
    return M2_TILE_Y + 2 * rmax, M2_TILE_X + 2 * (-(-rmax // 8) * 8)


def m2_on_chip(rmax: int) -> bool:
    """Whether ``m2_tile`` takes B6 at `rmax` (its tiles fit a block's
    shared memory: rmax <= 50); else the wrapper takes ``m2_kernel``, whose
    taps are loads from device memory."""
    rows, cols = m2_tile_shape(rmax)
    return rows * cols * 8 <= _build.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def gather(x: torch.Tensor, dy, dx, outside_zero: bool = False) -> torch.Tensor:
    """``x[n, y+dy, x+dx]`` for every (n, y, x): (N, H, W) `x`, (H, W)
    integer offsets (or 0).  A coordinate outside the plane is clamped into
    it (the JAX package's ``_gather``), or with `outside_zero` reads 0 (its
    zero-padded ``_sep_taps``)."""
    n, h, w = x.shape
    dev = x.device
    yy = torch.arange(h, device=dev, dtype=torch.int64).view(h, 1) + dy
    xx = torch.arange(w, device=dev, dtype=torch.int64).view(1, w) + dx
    flat = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).expand(h, w).reshape(-1)
    out = x.reshape(n, h * w).index_select(1, flat).view(n, h, w)
    if outside_zero:
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        out = torch.where(inside, out, torch.zeros((), dtype=x.dtype, device=dev))
    return out


def sep_taps(c: torch.Tensor, vmap: torch.Tensor, mode: int):
    """The taps (r1, r3, r2, r4) of a separable mode from one magnitude
    plane: rows at ±vmap for modes 1 and 4-7, columns at ±vmap for modes
    3-7 (mode 3 takes them as r1/r3), 0 outside the plane; the unused pair
    aliases the centre (the JAX package's ``_sep_taps`` and its caller)."""
    r2 = r4 = c
    if mode != 1:
        r2, r4 = gather(c, 0, vmap, True), gather(c, 0, -vmap, True)
    if mode == 3:
        return r2, r4, c, c
    return gather(c, vmap, 0, True), gather(c, -vmap, 0, True), r2, r4


def deband_center_ref(x: torch.Tensor, vmap: torch.Tensor, mode: int,
                      blur_first: bool, rmax: int, thr3) -> torch.Tensor:
    """Plain version of ``deband_center``: ``sep_taps``, then the mode's
    centre arithmetic."""
    from ..ops.deband import _mode_center

    c = x.to(torch.int32)
    return _mode_center(mode, blur_first, True, c, *sep_taps(c, vmap, mode), *thr3)


def m2_offsets(key: torch.Tensor, rmax: int):
    """(val1, val2) from the joint key ``(val1+rmax)*(2rmax+1) + (val2+rmax)``,
    with floor division, in int64."""
    na = 2 * rmax + 1
    k = key.to(torch.int64)
    return (torch.div(k, na, rounding_mode="floor") - rmax,
            torch.remainder(k, na) - rmax)


def deband_m2_center_ref(x: torch.Tensor, key: torch.Tensor, blur_first: bool,
                         rmax: int, thr: int) -> torch.Tensor:
    """Plain version of ``deband_m2_center``: the four taps
    r1 = (y+val2, x+val1), r3 = (y-val2, x-val1), r2 = (y-val1, x+val2),
    r4 = (y+val1, x-val2), then neo's avg_4 centre."""
    from ..ops.deband import _mode_center

    v1, v2 = m2_offsets(key, rmax)
    c = x.to(torch.int32)
    r1, r3 = gather(c, v2, v1), gather(c, -v2, -v1)
    r2, r4 = gather(c, -v1, v2), gather(c, v1, -v2)
    return _mode_center(2, blur_first, True, c, r1, r3, r2, r4, thr, 0, 0)


# ---------------------------------------------------------------------------
# entry points (the library is built by ``_build`` at the first launch)
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_CENTER = _build.kernel("deband", "vz_deband_center", _P, _P, _P, *[_I] * 8)
_M2_CENTER = _build.kernel("deband", "vz_deband_m2_center", _P, _P, _P, *[_I] * 6)
_M2_TILE = _build.kernel("deband", "vz_deband_m2_tile", _P, _P, _P, *[_I] * 6)


def _check(x: torch.Tensor, plane: torch.Tensor, rmax: int) -> None:
    """Raise unless the kernels take `x` and the offset `plane`."""
    if x.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no Deband kernel for device {x.device}")
    if x.dtype != torch.uint16 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("vszip_tpu_torch: Deband kernels take a contiguous (N, H, W) "
                         f"uint16 tensor, got {x.dtype} {tuple(x.shape)}")
    if (plane.dtype != torch.int32 or tuple(plane.shape) != tuple(x.shape[1:])
            or not plane.is_contiguous() or plane.device != x.device):
        raise ValueError("vszip_tpu_torch: Deband kernels take a contiguous (H, W) int32 "
                         f"offset plane on {x.device}, got {plane.dtype} "
                         f"{tuple(plane.shape)} on {plane.device}")
    if rmax < 0:
        raise ValueError(f"vszip_tpu_torch: Deband kernels take rmax >= 0, got {rmax}")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@trace.spanned("vszip.kernel.deband_center", profiled=False)
def deband_center(x: torch.Tensor, vmap: torch.Tensor, mode: int,
                  blur_first: bool, rmax: int, thr3) -> torch.Tensor:
    """Pre-grain centre of the separable int modes 1, 3, 4, 5, 6 (B5)."""
    if x.device.type == "cpu":
        return deband_center_ref(x, vmap, mode, blur_first, rmax, thr3)
    _check(x, vmap, rmax)
    if mode not in SEPARABLE_MODES:
        raise ValueError(f"vszip_tpu_torch: deband_center takes modes {SEPARABLE_MODES}, "
                         f"got {mode}")
    n, h, w = x.shape
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    thr, thr1, thr2 = (int(t) for t in thr3)
    _CENTER(x.device, x.data_ptr(), vmap.data_ptr(), out.data_ptr(), n, h, w, mode,
            int(blur_first), thr, thr1, thr2)
    LAUNCHES["deband_center"] += 1
    return out


@trace.spanned("vszip.kernel.deband_m2_center", profiled=False)
def deband_m2_center(x: torch.Tensor, key: torch.Tensor, blur_first: bool,
                     rmax: int, thr: int) -> torch.Tensor:
    """Pre-grain centre of int mode 2 from the joint offset key (B6)."""
    if x.device.type == "cpu":
        return deband_m2_center_ref(x, key, blur_first, rmax, thr)
    _check(x, key, rmax)
    n, h, w = x.shape
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    launch = _M2_TILE if m2_on_chip(rmax) else _M2_CENTER
    launch(x.device, x.data_ptr(), key.data_ptr(), out.data_ptr(), n, h, w, rmax,
           int(blur_first), int(thr))
    LAUNCHES["deband_m2_center"] += 1
    return out
