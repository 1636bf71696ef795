"""BilateralDither's two window kernels (B17, B18): CUDA wrappers, their plain
PyTorch versions, and the launch counters.

Both evaluate, for every pixel of an (N, H, W) plane, the flat-kernel
bilateral of the reference (src/filters/bilateral_dither.zig): over a set of
window offsets (dy, dx), each tap weighs ``w = max(min(m - |vr - cen_ref|,
wmax), 0)`` (vr the tap and cen_ref the centre of the joint ``ref`` plane,
or of the source without one) and sums ``s += (v - cen) * w``, ``sw += w``
in f32, in the reference's order; the output is ``p = cen + s / max(sw,
swmin)``, stored as ``floor(clip(p, 0, peak) + 0.5)`` for integer planes.
Taps outside the plane read its 'symmetric' mirror (i < 0 -> -1 - i,
i >= n -> 2n - 1 - i); the op keeps r <= the plane's sides, so one
reflection suffices.

- ``dense_blur`` replaces ``dense_blur_pallas``
  (vszip_tpu/kernels/bilateral_dither_pallas.py:201): every offset of the
  (2r-1)^2 window 1-r..r-1, in (dy, dx) row-major order.
- ``subspl_blur`` replaces ``subspl_blur_pallas`` (:233): the k offsets of
  one of 23 point lists, in list order.  Pixel (y, x) takes list
  ``(start[y] + (x >> 2)) % 23``; ``dyx`` is the (23, k, 2) int16 table of
  (dy, dx) pairs from ``ops.bilateral_dither_points.generate``.  Its first
  point is the centre (0, 0), which adds ``w`` to ``sw``.

The JAX package's CPU path addresses sub-sampled taps as flat indices into
the padded cache "with slack" (``_tap_indices``); every offset ``generate``
returns lies within +-(r-1), so that equals the 2-D addressing here.

Each wrapper dispatches on the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor launches its kernel in
``csrc/bilateral_dither.cu`` or raises.  Nothing falls back.  The kernels
read the native u8/u16/f32 planes; the plain versions build the padded f32
cache.  Every constant (``m``, ``wmax``, ``swmin``) arrives as the f32 value
the op rounded it to, and the division is IEEE (never by a host scalar,
which CUDA torch turns into a reciprocal multiply).
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build, trace

# Launches made on the CUDA path.  Each wrapper adds one where it launches
# its kernel and nowhere else; the plain versions never count.
LAUNCHES = trace.register_launches({"dense_blur": 0, "subspl_blur": 0})

NBR_POINT_LISTS = 23
_DTYPES = (torch.uint8, torch.uint16, torch.float32)


# ---------------------------------------------------------------------------
# plain PyTorch versions (ops/bilateral_dither.py:36-126 of vszip_tpu)
# ---------------------------------------------------------------------------

def _mirror(n: int, r: int, device) -> torch.Tensor:
    """Source index of each of the n + 2r positions of a 'symmetric' pad."""
    i = torch.arange(-r, n + r, device=device)
    return torch.where(i < 0, -1 - i, torch.where(i >= n, 2 * n - 1 - i, i))


def pad_cache(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H + 2r, W + 2r) f32 'symmetric'-padded cache of (N, H, W) `x`."""
    _, h, w = x.shape
    xf = x.to(torch.float32)
    return xf.index_select(1, _mirror(h, r, x.device)).index_select(2, _mirror(w, r, x.device))


def _store(cen, s, sw, swmin, peak, dtype):
    # tensor / tensor: an IEEE division on either device
    p = cen + s / sw.clamp(min=swmin)
    if dtype == torch.float32:
        return p
    return torch.floor(p.clamp(0.0, peak) + 0.5).to(torch.int32).to(dtype)


def _weight(vr, cen_ref, m, wmax):
    return (m - (vr - cen_ref).abs()).clamp(max=wmax).clamp(min=0.0)


def dense_blur_ref(x: torch.Tensor, ref: torch.Tensor | None, r: int, m: float, wmax: float,
                   swmin: float, peak: float) -> torch.Tensor:
    """Plain version of ``dense_blur``: one torch pass per tap of the
    (2r-1)^2 window, (dy, dx) row-major."""
    n, h, w = x.shape
    src = pad_cache(x, r)
    rc = src if ref is None else pad_cache(ref, r)
    cen = src[:, r:r + h, r:r + w]
    cen_ref = rc[:, r:r + h, r:r + w]
    s = torch.zeros_like(cen)
    sw = torch.zeros_like(cen)
    for dy in range(1, 2 * r):
        for dx in range(1, 2 * r):
            v = src[:, dy:dy + h, dx:dx + w]
            wgt = _weight(rc[:, dy:dy + h, dx:dx + w], cen_ref, m, wmax)
            s = s + (v - cen) * wgt
            sw = sw + wgt
    return _store(cen, s, sw, swmin, peak, x.dtype)


def list_ids(start: torch.Tensor, w: int) -> torch.Tensor:
    """(H, W) point-list id of every pixel: the row's start list, advanced
    by one every 4 pixels."""
    groups = torch.arange(w, device=start.device) >> 2
    return (start.to(torch.int64).view(-1, 1) + groups.view(1, -1)) % NBR_POINT_LISTS


def subspl_blur_ref(x: torch.Tensor, ref: torch.Tensor | None, r: int, start: torch.Tensor,
                    dyx: torch.Tensor, m: float, wmax: float, swmin: float,
                    peak: float) -> torch.Tensor:
    """Plain version of ``subspl_blur``: one gather per tap of the k-point
    lists, in list order."""
    n, h, w = x.shape
    hp, wp = h + 2 * r, w + 2 * r
    src = pad_cache(x, r).reshape(n, hp * wp)
    rc = src if ref is None else pad_cache(ref, r).reshape(n, hp * wp)
    ys = torch.arange(h, device=x.device).view(h, 1)
    xs = torch.arange(w, device=x.device).view(1, w)
    base = (ys + r) * wp + xs + r
    lid = list_ids(start, w)
    off = dyx.to(torch.int64)[..., 0] * wp + dyx.to(torch.int64)[..., 1]  # (23, k)
    cen = src[:, base.reshape(-1)].view(n, h, w)
    cen_ref = rc[:, base.reshape(-1)].view(n, h, w)
    s = torch.zeros_like(cen)
    sw = torch.zeros_like(cen)
    for j in range(dyx.shape[1]):
        idx = (base + off[:, j][lid]).reshape(-1)
        v = src[:, idx].view(n, h, w)
        wgt = _weight(rc[:, idx].view(n, h, w), cen_ref, m, wmax)
        s = s + (v - cen) * wgt
        sw = sw + wgt
    return _store(cen, s, sw, swmin, peak, x.dtype)


# ---------------------------------------------------------------------------
# entry points (the library is built by ``_build`` at the first launch)
# ---------------------------------------------------------------------------

# pointers, then dtype, has_ref, n, h, w, r (and k), m, wmax, swmin, peak
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DENSE = _build.kernel("bilateral_dither", "vz_bd_dense", *[_P] * 3, *[_I] * 6, *[_F] * 4)
_SUBSPL = _build.kernel("bilateral_dither", "vz_bd_subspl", *[_P] * 5, *[_I] * 7, *[_F] * 4)
_SUBSPL_BAND = _build.entry("bilateral_dither", "vz_bd_subspl_band", *[_P] * 2, *[_I] * 7, _P)


def _code(x: torch.Tensor) -> int:
    return _DTYPES.index(x.dtype)


def _check(name: str, x: torch.Tensor, ref: torch.Tensor | None, r: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no BilateralDither kernel for device {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"vszip_tpu_torch: {name} takes a contiguous (N, H, W) uint8, uint16 "
                         f"or float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if ref is not None and (ref.device != x.device or ref.dtype != x.dtype
                            or ref.shape != x.shape or not ref.is_contiguous()):
        raise ValueError(f"vszip_tpu_torch: {name}'s ref must be a contiguous tensor like x")
    if not 1 <= r <= min(x.shape[1:]):
        raise ValueError(f"vszip_tpu_torch: {name} does not take radius {r} on a "
                         f"{x.shape[2]}x{x.shape[1]} plane")


# tables whose offsets were read on the host: tensor -> (its version, r)
_TABLES_CHECKED = WeakIdKeyDictionary()


def _check_table(dyx: torch.Tensor, r: int) -> None:
    """Every offset within +-(r-1), or the kernel would read outside its
    tile.  Reading the table waits for the card, so each table tensor is
    read once (again only after it changes)."""
    key = (dyx._version, r)
    if _TABLES_CHECKED.get(dyx) != key:
        if int(dyx.abs().max()) >= r:
            raise ValueError(f"vszip_tpu_torch: subspl_blur's offsets must lie within +-{r - 1}")
        _TABLES_CHECKED[dyx] = key


def _ptrs(x, ref, out):
    return x.data_ptr(), (ref if ref is not None else x).data_ptr(), out.data_ptr()


def _subspl_band(x: torch.Tensor, ref: torch.Tensor | None, r: int,
                k: int) -> tuple[int, int, int] | None:
    """The block shape ``subspl_blur`` launches on CUDA tensors like these:
    (frames, columns, rows), or None where it takes the 32x16 tile kernel
    (tables and radii too large for a band's tile).  Not part of the
    package's surface: the card tests and tools read the layout with it."""
    n, h, w = x.shape
    out = (ctypes.c_int * 3)()
    band = _SUBSPL_BAND(x.data_ptr(), (ref if ref is not None else x).data_ptr(), _code(x),
                        int(ref is not None), n, h, w, r, k, out)
    return tuple(out) if band else None


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@trace.spanned("vszip.kernel.dense_blur", profiled=False)
def dense_blur(x: torch.Tensor, ref: torch.Tensor | None, r: int, m: float, wmax: float,
               swmin: float, peak: float) -> torch.Tensor:
    """The dense (2r-1)^2 window (B17); (N, H, W) uint8, uint16 or float32,
    with an optional joint `ref` like it."""
    if x.device.type == "cpu":
        return dense_blur_ref(x, ref, r, m, wmax, swmin, peak)
    _check("dense_blur", x, ref, r)
    n, h, w = x.shape
    out = torch.empty_like(x)
    _DENSE(x.device, *_ptrs(x, ref, out), _code(x), int(ref is not None), n, h, w, r, m, wmax,
           swmin, peak)
    LAUNCHES["dense_blur"] += 1
    return out


@trace.spanned("vszip.kernel.subspl_blur", profiled=False)
def subspl_blur(x: torch.Tensor, ref: torch.Tensor | None, r: int, start: torch.Tensor,
                dyx: torch.Tensor, m: float, wmax: float, swmin: float,
                peak: float) -> torch.Tensor:
    """The sub-sampled point lists (B18); `start` the (H,) int32 start list
    of each row, each in [0, 23) (the kernel does not read it back to
    check), `dyx` the (23, k, 2) int16 (dy, dx) table."""
    if x.device.type == "cpu":
        return subspl_blur_ref(x, ref, r, start, dyx, m, wmax, swmin, peak)
    _check("subspl_blur", x, ref, r)
    n, h, w = x.shape
    if (start.device != x.device or start.dtype != torch.int32 or start.shape != (h,)
            or dyx.device != x.device or dyx.dtype != torch.int16 or dyx.dim() != 3
            or dyx.shape[0] != NBR_POINT_LISTS or dyx.shape[2] != 2 or dyx.shape[1] < 1
            or not dyx.is_contiguous() or not start.is_contiguous()):
        raise ValueError("vszip_tpu_torch: subspl_blur takes an (H,) int32 start and a "
                         "(23, k, 2) int16 table on x's device")
    _check_table(dyx, r)
    out = torch.empty_like(x)
    _SUBSPL(x.device, *_ptrs(x, ref, out), start.data_ptr(), dyx.data_ptr(), _code(x),
            int(ref is not None), n, h, w, r, dyx.shape[1], m, wmax, swmin, peak)
    LAUNCHES["subspl_blur"] += 1
    return out
