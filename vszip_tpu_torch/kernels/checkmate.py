"""Checkmate's dot-crawl reducer (B15): CUDA wrapper, its plain PyTorch
version, and the launch counter.

``checkmate`` replaces ``checkmate_pallas``
(vszip_tpu/kernels/checkmate_pallas.py:112): on an (N, H, W) uint8 plane,
every pixel of rows 2..H-3 blends the 1-2-1 vertical column sums (rows
y-2, y, y+2) of frames n-1 and n+1 against frame n's, plus a spatial term
``trunc(curr_value / 10)`` from columns x-2 and x+2 (clamped); with
``tthr2 > 0`` a pixel whose three temporal differences (frames n-2..n+2)
are all below tthr2 takes the temporal smooth ``(p1 + 2c + n1) >> 2``
instead.  Frame indices clamp at the clip's ends, and the first and last
two rows pass through (reference src/filters/checkmate.zig).

It dispatches on the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches ``checkmate_kernel`` in ``csrc/checkmate.cu`` or
raises.  Nothing falls back.

The division truncates toward zero (Zig's ``@divTrunc``): CUDA's integer
``/`` does; torch's ``//`` floors, so the plain version divides with
``rounding_mode="trunc"``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, trace

# Launches made on the CUDA path.  The wrapper adds one where it launches its
# kernel and nowhere else; the plain version never counts.
LAUNCHES = trace.register_launches({"checkmate": 0})


# ---------------------------------------------------------------------------
# plain PyTorch version (ops/checkmate.py:31-107 of vszip_tpu)
# ---------------------------------------------------------------------------

def frame_shift(p: torch.Tensor, off: int) -> torch.Tensor:
    """Frame n+off of every frame n, the index clamped to the clip."""
    idx = (torch.arange(p.shape[0], device=p.device) + off).clamp(0, p.shape[0] - 1)
    return p.index_select(0, idx)


def _col121(x: torch.Tensor) -> torch.Tensor:
    """x[y-2] + 2*x[y] + x[y+2] for the interior rows y in [2, h-3]."""
    return x[:, :-4] + 2 * x[:, 2:-2] + x[:, 4:]


def _cols(x: torch.Tensor, off: int) -> torch.Tensor:
    """Columns x+off, clamped to the row."""
    w = x.shape[2]
    idx = (torch.arange(w, device=x.device) + off).clamp(0, w - 1)
    return x.index_select(2, idx)


def checkmate_ref(x: torch.Tensor, thr: int, tmax: int, tthr2: int) -> torch.Tensor:
    """Plain version of ``checkmate``; (N, H, W) uint8, H >= 5."""
    xi = x.to(torch.int32)
    p1 = frame_shift(xi, -1)
    n1 = frame_shift(xi, 1)
    c, cp1, cn1 = xi[:, 2:-2], p1[:, 2:-2], n1[:, 2:-2]
    cur_col = _col121(xi)
    up, down = xi[:, :-4], xi[:, 4:]
    curr_value = (-_cols(up, -2) - _cols(up, 2) + 2 * _cols(c, -2) + 2 * _cols(c, 2)
                  - _cols(down, -2) - _cols(down, 2) + 2 * cur_col + 12 * c)
    nc = thr + tmax - (_col121(n1) - cur_col).abs()
    pc = thr + tmax - (_col121(p1) - cur_col).abs()
    tmax_mult = (1 << 13) // tmax
    nw = (nc.clamp(0, tmax + 1) * tmax_mult).clamp(max=8192)
    pw = (pc.clamp(0, tmax + 1) * tmax_mult).clamp(max=8192)
    cw = (1 << 14) - (nw + pw)
    div10 = torch.div(curr_value, 10, rounding_mode="trunc")
    out = ((cw * div10 + pw * (c + cp1) + nw * (c + cn1)) >> 15).clamp(0, 255)
    if tthr2 > 0:
        p2 = frame_shift(xi, -2)[:, 2:-2]
        n2 = frame_shift(xi, 2)[:, 2:-2]
        cond = (((cp1 - cn1).abs() < tthr2) & ((p2 - c).abs() < tthr2)
                & ((c - n2).abs() < tthr2))
        out = torch.where(cond, (cp1 + 2 * c + cn1) >> 2, out)
    return torch.cat([x[:, :2], out.to(torch.uint8), x[:, -2:]], dim=1)


# ---------------------------------------------------------------------------
# entry point (the library is built by ``_build`` at the first launch)
# ---------------------------------------------------------------------------

_CHECKMATE = _build.kernel("checkmate", "vz_checkmate", ctypes.c_void_p, ctypes.c_void_p,
                           *[ctypes.c_int] * 6)


def _check(x: torch.Tensor, thr: int, tmax: int, tthr2: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no Checkmate kernel for device {x.device}")
    if x.dtype != torch.uint8 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("vszip_tpu_torch: checkmate takes a contiguous (N, H, W) uint8 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] < 5 or not 1 <= tmax <= 255 or not 0 <= thr <= 255 or tthr2 < 0:
        raise ValueError(f"vszip_tpu_torch: checkmate does not take height {x.shape[1]}, "
                         f"thr {thr}, tmax {tmax}, tthr2 {tthr2}")


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

@trace.spanned("vszip.kernel.checkmate", profiled=False)
def checkmate(x: torch.Tensor, thr: int, tmax: int, tthr2: int) -> torch.Tensor:
    """Checkmate's temporal + spatial reducer over the whole clip (B15);
    (N, H, W) uint8."""
    if x.device.type == "cpu":
        return checkmate_ref(x, thr, tmax, tthr2)
    _check(x, thr, tmax, tthr2)
    n, h, w = x.shape
    out = torch.empty_like(x)
    _CHECKMATE(x.device, x.data_ptr(), out.data_ptr(), n, h, w, thr, tmax, tthr2)
    LAUNCHES["checkmate"] += 1
    return out
