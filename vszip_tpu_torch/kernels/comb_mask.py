"""CombMask's comb detector (B16): CUDA wrapper, its plain PyTorch version,
and the launch counter.

``comb_mask`` replaces ``comb_mask_pallas``
(vszip_tpu/kernels/comb_mask_pallas.py:102) and, for planes under 2
columns, the JAX package's jnp path: on an (N, H, W) uint8 plane (H >= 3),
the comb metric 0 (``d1 = c - up``, ``d2 = c - down`` beyond +-cthresh and
``|up2 + 4c + down2 - 3(up + down)| > 6 cthresh``) or 1
(``(up - c)(down - c) > cthresh``) with reflect-101 rows, the motion AND
(``|c - prev| > mthresh`` dilated by one row: a zero row above the top,
clamped at the bottom; frame 0 compares with itself) when mthresh > 0, and
the horizontal expand after it, with the reference's quirks: column 0 is
``m[0] | m[1]``, the last column keeps its value, a plane under 2 columns
is not expanded (reference src/filters/comb_mask.zig).

It dispatches on the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches ``comb_mask_kernel`` in ``csrc/comb_mask.cu`` or
raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, trace

# Launches made on the CUDA path.  The wrapper adds one where it launches its
# kernel and nowhere else; the plain version never counts.
LAUNCHES = trace.register_launches({"comb_mask": 0})


# ---------------------------------------------------------------------------
# plain PyTorch version (ops/comb_mask.py:33-97 of vszip_tpu)
# ---------------------------------------------------------------------------

def _rows_101(x: torch.Tensor, off: int) -> torch.Tensor:
    """Rows y+off with the reflect-101 (no duplicate) edge mirror."""
    h = x.shape[1]
    k = torch.arange(h, device=x.device) + off
    k = torch.where(k < 0, -k, torch.where(k > h - 1, 2 * (h - 1) - k, k))
    return x.index_select(1, k)


def _metric0(xi: torch.Tensor, cthresh: int) -> torch.Tensor:
    up2, up, dn, dn2 = (_rows_101(xi, o) for o in (-2, -1, 1, 2))
    d1, d2 = xi - up, xi - dn
    pred = ((d1 > cthresh) & (d2 > cthresh)) | ((d1 < -cthresh) & (d2 < -cthresh))
    val = ((up2 + 4 * xi + dn2) - 3 * (up + dn)).abs() > 6 * cthresh
    return pred & val


def _metric1(xi: torch.Tensor, cthresh: int) -> torch.Tensor:
    return (_rows_101(xi, -1) - xi) * (_rows_101(xi, 1) - xi) > cthresh


def _expand(m: torch.Tensor) -> torch.Tensor:
    """3-tap horizontal dilation; column 0 is m[0] | m[1], the last column
    keeps its value (the reference's expandMask never writes it)."""
    if m.shape[2] < 2:
        return m
    out = m.clone()
    out[:, :, 1:-1] = m[:, :, :-2] | m[:, :, 1:-1] | m[:, :, 2:]
    out[:, :, 0] = m[:, :, 0] | m[:, :, 1]
    return out


def _motion(xi: torch.Tensor, mthresh: int) -> torch.Tensor:
    prev = xi.index_select(0, (torch.arange(xi.shape[0], device=xi.device) - 1).clamp(min=0))
    diff = (xi - prev).abs() > mthresh
    up = torch.cat([torch.zeros_like(diff[:, :1]), diff[:, :-1]], dim=1)
    dn = torch.cat([diff[:, 1:], diff[:, -1:]], dim=1)
    return up | diff | dn


def comb_mask_ref(x: torch.Tensor, cthresh: int, mthresh: int, metric_1: bool,
                  expand: bool) -> torch.Tensor:
    """Plain version of ``comb_mask``; (N, H, W) uint8 of 0/255."""
    xi = x.to(torch.int32)
    mask = _metric1(xi, cthresh) if metric_1 else _metric0(xi, cthresh)
    if mthresh > 0:
        mask = mask & _motion(xi, mthresh)
    if expand:
        mask = _expand(mask)
    return mask.to(torch.uint8) * 255


# ---------------------------------------------------------------------------
# entry point (the library is built by ``_build`` at the first launch)
# ---------------------------------------------------------------------------

_COMB_MASK = _build.kernel("comb_mask", "vz_comb_mask", ctypes.c_void_p, ctypes.c_void_p,
                           *[ctypes.c_int] * 7)


def _check(x: torch.Tensor, cthresh: int, mthresh: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no CombMask kernel for device {x.device}")
    if x.dtype != torch.uint8 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("vszip_tpu_torch: comb_mask takes a contiguous (N, H, W) uint8 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] < 3 or not 0 <= cthresh <= 65025 or not 0 <= mthresh <= 255:
        raise ValueError(f"vszip_tpu_torch: comb_mask does not take height {x.shape[1]}, "
                         f"cthresh {cthresh}, mthresh {mthresh}")


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

@trace.spanned("vszip.kernel.comb_mask", profiled=False)
def comb_mask(x: torch.Tensor, cthresh: int, mthresh: int, metric_1: bool,
              expand: bool) -> torch.Tensor:
    """CombMask's mask of one plane over the whole clip (B16); (N, H, W)
    uint8 of 0/255."""
    if x.device.type == "cpu":
        return comb_mask_ref(x, cthresh, mthresh, metric_1, expand)
    _check(x, cthresh, mthresh)
    n, h, w = x.shape
    out = torch.empty_like(x)
    _COMB_MASK(x.device, x.data_ptr(), out.data_ptr(), n, h, w, cthresh, mthresh,
               int(metric_1), int(expand))
    LAUNCHES["comb_mask"] += 1
    return out
