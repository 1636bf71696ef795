"""XPSNR's per-block statistics (B11, B12): CUDA wrappers, their plain
PyTorch versions, and the launch counters.

``luma_stats`` replaces ``luma_stats_pallas``
(vszip_tpu/kernels/xpsnr_pallas.py:141): per 64x64 block of the luma plane,
the exact sums of the squared error, of the |3x3 Laplacian| over the picture
interior (one pixel in from every edge) and of the |first-order| (``order``
1) or |second-order| (``order`` 2) temporal difference, with zero for the
missing frames before frame 0 and 1.  ``chroma_sse`` replaces
``chroma_sse_pallas`` (:203): per (by x bx) block of one chroma plane, the
exact squared-error sum.  Both return (N, nbh, nbw) float64 planes holding
exact integers, as the JAX package does; the temporal sum is returned
without XPSNR's gamma factor, and as zeros with ``temporal=False``.

They dispatch on the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches ``luma_warp_kernel`` (luma: a warp per 64x64 block,
a lane on two adjacent columns, one load of both where ``pair_loads``
allows) or ``block_stats_kernel`` (chroma) in ``csrc/xpsnr.cu``, or raises.
Nothing falls back.

The maps are int32 (the squares int64) and every block sum is int64, so any
summation order is exact: the kernels and the plain versions agree bit for
bit.  The TPU
kernel's 12-bit limb split and block-indicator matmuls exist only because
the TPU has no 64-bit lanes; they have no counterpart here.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import _build

# Launches made on the CUDA path.  The wrapper adds one where it launches its
# kernel and nowhere else; the plain version never counts.
LAUNCHES = {"luma_stats": 0, "chroma_sse": 0}
B = 64  # luma block size of B11

_I32, _I64 = torch.int32, torch.int64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def block_sum(m: torch.Tensor, bx: int, by: int) -> torch.Tensor:
    """Exact per-(by x bx)-block sums of a non-negative int32 or int64 map,
    zero padded at the ragged edges, as int64: (N, nbh, nbw)."""
    n, h, w = m.shape
    hb, wb = -h % by, -w % bx
    mp = torch.nn.functional.pad(m, (0, wb, 0, hb))
    nb_h, nb_w = (h + hb) // by, (w + wb) // bx
    return mp.reshape(n, nb_h, by, nb_w, bx).sum(dim=(2, 4), dtype=_I64)


def lap_map(x: torch.Tensor) -> torch.Tensor:
    """|12c - 2(l+r+u+d) - (ul+ur+dl+dr)| over the interior, 0 on borders
    (int32)."""
    xi = x.to(_I32)
    c = xi[:, 1:-1, 1:-1]
    l, r = xi[:, 1:-1, :-2], xi[:, 1:-1, 2:]
    u, d = xi[:, :-2, 1:-1], xi[:, 2:, 1:-1]
    ul, ur = xi[:, :-2, :-2], xi[:, :-2, 2:]
    dl, dr = xi[:, 2:, :-2], xi[:, 2:, 2:]
    f = (12 * c - 2 * (l + r + u + d) - (ul + ur + dl + dr)).abs()
    return torch.nn.functional.pad(f, (1, 1, 1, 1))


def prev_frames(x: torch.Tensor, k: int) -> torch.Tensor:
    """x shifted k frames later along the batch, the first k frames zero
    (the missing previous frames)."""
    k = min(k, x.shape[0])
    return torch.cat([torch.zeros_like(x[:k]), x[: x.shape[0] - k]], dim=0)


def temporal_diff(x: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                  order: int) -> torch.Tensor:
    """cur - p1 (order 1) or cur - 2*p1 + p2 (order 2), int32."""
    t = x.to(_I32) - (p1.to(_I32) if order == 1 else 2 * p1.to(_I32))
    return t if order == 1 else t + p2.to(_I32)


def luma_stats_ref(org: torch.Tensor, rec: torch.Tensor, order: int,
                   temporal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``luma_stats``: (sse, sa, ta), each (N, nbh, nbw)
    float64 holding exact integers; ta without gamma (zeros with
    ``temporal=False``)."""
    n, h, w = org.shape
    # squares in int64: a 16-bit difference's square passes 2^31
    diff = org.to(_I64) - rec.to(_I64)
    sse = block_sum(diff * diff, B, B)
    ys = torch.arange(h, device=org.device).view(h, 1)
    xs = torch.arange(w, device=org.device).view(1, w)
    active = (xs >= 1) & (xs < w - 1) & (ys >= 1) & (ys < h - 1)
    sa = block_sum(torch.where(active, lap_map(org), 0), B, B)
    if temporal:
        t = temporal_diff(org, prev_frames(org, 1), prev_frames(org, 2), order)
        ta = block_sum(t.abs(), B, B)
    else:
        ta = torch.zeros_like(sse)
    return sse.to(torch.float64), sa.to(torch.float64), ta.to(torch.float64)


def chroma_sse_ref(org: torch.Tensor, rec: torch.Tensor, by: int, bx: int) -> torch.Tensor:
    """Plain version of ``chroma_sse``: (N, nbh, nbw) float64 exact sums."""
    d = org.to(_I64) - rec.to(_I64)
    return block_sum(d * d, bx, by).to(torch.float64)


# ---------------------------------------------------------------------------
# bind (the library is built by ``_build`` at the first launch)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("xpsnr")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vz_xpsnr_luma_stats.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.vz_xpsnr_chroma_sse.argtypes = [p, p, p, i, i, i, i, i, i, p]
    for fn in (lib.vz_xpsnr_luma_stats, lib.vz_xpsnr_chroma_sse):
        fn.restype = ctypes.c_int
    return lib


def pair_loads(w: int, elem_bytes: int, *ptrs: int) -> bool:
    """Whether ``luma_warp_kernel`` reads a lane's two columns as one word:
    an even row width and every plane on 2 * elem_bytes bytes; else one
    load a column."""
    return w % 2 == 0 and all(p % (2 * elem_bytes) == 0 for p in ptrs)


def _check(name: str, org: torch.Tensor, rec: torch.Tensor) -> None:
    """Raise unless the kernel takes these planes."""
    if org.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no XPSNR kernel for device {org.device}")
    for t in (org, rec):
        if (t.dtype not in (torch.uint8, torch.uint16) or t.dim() != 3
                or not t.is_contiguous() or t.device != org.device):
            raise ValueError(f"vszip_tpu_torch: {name} takes contiguous (N, H, W) "
                             f"uint8/uint16 planes on one device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if rec.shape != org.shape or rec.dtype != org.dtype:
        raise ValueError(f"vszip_tpu_torch: {name}: planes differ "
                         f"({tuple(org.shape)} {org.dtype}, {tuple(rec.shape)} {rec.dtype})")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def luma_stats(org: torch.Tensor, rec: torch.Tensor, order: int,
               temporal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-64x64-block [sse, sa, ta] exact sums (B11); each (N, nbh, nbw)
    float64."""
    if org.device.type == "cpu":
        return luma_stats_ref(org, rec, order, temporal)
    _check("luma_stats", org, rec)
    if order not in (1, 2):
        raise ValueError(f"vszip_tpu_torch: luma_stats takes order 1 or 2, got {order}")
    n, h, w = org.shape
    nbh, nbw = -(-h // B), -(-w // B)
    out = torch.empty((3, n, nbh, nbw), dtype=_I64, device=org.device)
    with torch.cuda.device(org.device):
        _build.check(_lib().vz_xpsnr_luma_stats, org.data_ptr(), rec.data_ptr(),
                     out.data_ptr(), n, h, w, org.element_size(),
                     int(pair_loads(w, org.element_size(), org.data_ptr(), rec.data_ptr())),
                     order, int(bool(temporal)), _build.stream(org))
    LAUNCHES["luma_stats"] += 1
    f = out.to(torch.float64)
    return f[0], f[1], f[2]


def chroma_sse(org: torch.Tensor, rec: torch.Tensor, by: int, bx: int) -> torch.Tensor:
    """Per-(by x bx)-block exact chroma SSE (B12); (N, nbh, nbw) float64."""
    if org.device.type == "cpu":
        return chroma_sse_ref(org, rec, by, bx)
    _check("chroma_sse", org, rec)
    if by < 1 or bx < 1:
        raise ValueError(f"vszip_tpu_torch: chroma_sse takes blocks >= 1, got {by}x{bx}")
    n, h, w = org.shape
    out = torch.empty((n, -(-h // by), -(-w // bx)), dtype=_I64, device=org.device)
    with torch.cuda.device(org.device):
        _build.check(_lib().vz_xpsnr_chroma_sse, org.data_ptr(), rec.data_ptr(),
                     out.data_ptr(), n, h, w, org.element_size(), by, bx,
                     _build.stream(org))
    LAUNCHES["chroma_sse"] += 1
    return out.to(torch.float64)
