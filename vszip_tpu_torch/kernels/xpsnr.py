"""XPSNR's per-block statistics (B11, B12): CUDA wrappers, their plain
PyTorch versions, and the launch counters.

``luma_stats`` replaces ``luma_stats_pallas``
(vszip_tpu/kernels/xpsnr_pallas.py:141): per 64x64 block of the luma plane,
the exact sums of the squared error, of the |3x3 Laplacian| over the picture
interior (one pixel in from every edge) and of the |first-order| (``order``
1) or |second-order| (``order`` 2) temporal difference, with zero for the
missing frames before frame 0 and 1.  ``chroma_sse`` replaces
``chroma_sse_pallas`` (:203): per (by x bx) block of one chroma plane, the
exact squared-error sum; ``chroma_sse_uv`` computes it for both chroma
planes in one launch, as XPSNR calls it.  They return (N, nbh, nbw)
float64 planes holding exact integers (``chroma_sse_uv`` two of them
stacked), as the JAX package does; the temporal sum is returned without
XPSNR's gamma factor, and as zeros with ``temporal=False``.

They dispatch on the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches a kernel of ``csrc/xpsnr.cu`` or raises.  Nothing
falls back.  Luma runs ``luma_warp_kernel``: a warp per 64x64 block, a lane
on two adjacent columns, one load of both where ``pair_loads`` allows.
Chroma runs ``chroma_strip_kernel``: a warp per strip of 32 lanes x
``lane_columns`` columns (128 uint16 or 256 uint8) down a block row, a
lane's columns in one 8-byte load where ``wide_loads`` allows, its squares
summed in registers, and each block's ``strip_group`` lanes reduced by
shuffles; blocks that fit no lane group take ``chroma_block_kernel`` (a
warp per block).  Both read each plane once: the chroma launch moves the
two planes' bytes and writes one int64 per block, so device-memory bytes
bound it (0.040 ms for the 1080p 4:2:0 row's 132.7 MB at 3.35 TB/s).

The maps are int32 (the squares int64) and every block sum is int64, so any
summation order is exact: the kernels and the plain versions agree bit for
bit.  The TPU
kernel's 12-bit limb split and block-indicator matmuls exist only because
the TPU has no 64-bit lanes; they have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, trace

# Launches made on the CUDA path.  The wrapper adds one where it launches its
# kernel and nowhere else; the plain version never counts.
LAUNCHES = trace.register_launches({"luma_stats": 0, "chroma_sse": 0})
B = 64  # luma block size of B11
LANE_BYTES = 8  # B12: a lane's columns of one row, one 8-byte load

_I32, _I64 = torch.int32, torch.int64


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


def chroma_sse_uv_ref(org_u: torch.Tensor, rec_u: torch.Tensor, org_v: torch.Tensor,
                      rec_v: torch.Tensor, by: int, bx: int) -> torch.Tensor:
    """Plain version of ``chroma_sse_uv``: the two planes' ``chroma_sse_ref``
    stacked, (2, N, nbh, nbw) float64."""
    return torch.stack([chroma_sse_ref(org_u, rec_u, by, bx),
                        chroma_sse_ref(org_v, rec_v, by, bx)])


# ---------------------------------------------------------------------------
# entry points (the library is built by ``_build`` at the first launch)
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_LUMA_STATS = _build.kernel("xpsnr", "vz_xpsnr_luma_stats", _P, _P, _P, *[_I] * 7)
_CHROMA_SSE = _build.kernel("xpsnr", "vz_xpsnr_chroma_sse", _P, _P, _P, _P, _I, _P,
                            *[_I] * 8)


def pair_loads(w: int, elem_bytes: int, *ptrs: int) -> bool:
    """Whether ``luma_warp_kernel`` reads a lane's two columns as one word:
    an even row width and every plane on 2 * elem_bytes bytes; else one
    load a column."""
    return w % 2 == 0 and all(p % (2 * elem_bytes) == 0 for p in ptrs)


def lane_columns(elem_bytes: int) -> int:
    """Columns a lane of ``chroma_strip_kernel`` owns: one 8-byte load."""
    return LANE_BYTES // elem_bytes


def strip_group(bx: int, elem_bytes: int) -> int:
    """Lanes of one bx-wide block on ``chroma_strip_kernel``: bx over a
    lane's columns where that is a whole power of two up to 32 (a warp row
    then holds 32 / group blocks); 0 where the block fits no lane group and
    takes ``chroma_block_kernel``."""
    cols = lane_columns(elem_bytes)
    group = bx // cols
    return group if bx % cols == 0 and 0 < group <= 32 and group & (group - 1) == 0 else 0


def wide_loads(w: int, elem_bytes: int, *ptrs: int) -> bool:
    """Whether ``chroma_strip_kernel`` reads a lane's columns as one 8-byte
    load: rows a whole number of lanes wide and every plane on 8 bytes; else
    one load a column."""
    return w % lane_columns(elem_bytes) == 0 and all(p % LANE_BYTES == 0 for p in ptrs)


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

@trace.spanned("vszip.kernel.luma_stats", profiled=False)
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
    _LUMA_STATS(org.device, org.data_ptr(), rec.data_ptr(), out.data_ptr(), n, h, w,
                org.element_size(),
                int(pair_loads(w, org.element_size(), org.data_ptr(), rec.data_ptr())), order,
                int(bool(temporal)))
    LAUNCHES["luma_stats"] += 1
    f = out.to(torch.float64)
    return f[0], f[1], f[2]


def _chroma(name: str, org: tuple, rec: tuple, by: int, bx: int) -> torch.Tensor:
    """One launch of B12 on the planes org[k], rec[k] (one or two pairs of one
    shape): (planes, N, nbh, nbw) float64."""
    for o, r in zip(org, rec):
        _check(name, o, r)
        if o.shape != org[0].shape or o.dtype != org[0].dtype or o.device != org[0].device:
            raise ValueError(f"vszip_tpu_torch: {name}: planes differ "
                             f"({tuple(org[0].shape)} {org[0].dtype}, {tuple(o.shape)} {o.dtype})")
    if by < 1 or bx < 1:
        raise ValueError(f"vszip_tpu_torch: {name} takes blocks >= 1, got {by}x{bx}")
    n, h, w = org[0].shape
    elem = org[0].element_size()
    ptrs = [t.data_ptr() for pair in zip(org, rec) for t in pair]
    out = torch.empty((len(org), n, -(-h // by), -(-w // bx)), dtype=_I64, device=org[0].device)
    _CHROMA_SSE(org[0].device, *ptrs, *[0] * (4 - len(ptrs)), len(org), out.data_ptr(), n, h,
                w, elem, by, bx, strip_group(bx, elem), int(wide_loads(w, elem, *ptrs)))
    LAUNCHES["chroma_sse"] += 1
    return out.to(torch.float64)


@trace.spanned("vszip.kernel.chroma_sse", profiled=False)
def chroma_sse(org: torch.Tensor, rec: torch.Tensor, by: int, bx: int) -> torch.Tensor:
    """Per-(by x bx)-block exact chroma SSE of one plane (B12); (N, nbh, nbw)
    float64."""
    if org.device.type == "cpu":
        return chroma_sse_ref(org, rec, by, bx)
    return _chroma("chroma_sse", (org,), (rec,), by, bx)[0]


@trace.spanned("vszip.kernel.chroma_sse", profiled=False)
def chroma_sse_uv(org_u: torch.Tensor, rec_u: torch.Tensor, org_v: torch.Tensor,
                  rec_v: torch.Tensor, by: int, bx: int) -> torch.Tensor:
    """``chroma_sse`` of both chroma planes in one launch (B12); (2, N, nbh,
    nbw) float64, U first."""
    if org_u.device.type == "cpu":
        return chroma_sse_uv_ref(org_u, rec_u, org_v, rec_v, by, bx)
    return _chroma("chroma_sse_uv", (org_u, org_v), (rec_u, rec_v), by, bx)
