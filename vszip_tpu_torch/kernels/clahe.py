"""CLAHE 8-bit lookup and blend (B7): CUDA wrapper, its plain PyTorch version,
and the launch counter.

``clahe8_lookup`` replaces ``clahe8_lookup_pallas``
(vszip_tpu/kernels/clahe_pallas.py:81) and takes the same inputs: the 8-bit
plane, the packed table ``tab32`` of the four neighbour LUTs (n, ry_n,
rx_n*256) int32, one byte per LUT (tile (ty1,tx1) in bits 0-7, (ty1,tx2)
8-15, (ty2,tx1) 16-23, (ty2,tx2) 24-31), the row fractions ``ya`` (ry_n,
tile_h) and the column fractions ``xa`` (1, rx_n*tile_w) f32, all on the
half-tile-shifted cell grid of ``ops/clahe.py``.  The plane is NOT padded:
pixel (y, x) lies in cell (ry, rx) = ((y + tile_h//2) // tile_h,
(x + tile_w//2) // tile_w) and takes the fractions at the shifted
coordinates, which is what the TPU kernel computes on its padded plane.

It dispatches on the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches ``clahe8_chunk_kernel`` in ``csrc/clahe.cu`` or
raises.  Nothing falls back.  The kernel gives a thread 16 consecutive bytes
of a row, keeps that chunk's per-column cell table in its registers for all
its rows, and stages each frame's table in shared memory when it fits
(``table_on_chip``); ``chunk_vector`` picks its loads' width and
``block_shape`` its block's shape.

The blend rounds each f32 product and sum separately in the reference's
order (``oxa``, ``oya``, ``t1``, ``t2``, ``res``, then ``trunc(res+0.5)``);
the JAX package gets the same by computing in f64 and rounding each step to
f32, the kernel by building without FMA contraction.  The TPU kernel's
256-step select chain and nibble mux stand in for a lookup the TPU lacks;
on Hopper the table sits in shared memory and the pixel's word is one load.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, trace

# Launches made on the CUDA path.  The wrapper adds one where it launches its
# kernel and nowhere else; the plain version never counts.
LAUNCHES = trace.register_launches({"clahe8_lookup": 0})
HIST = 256
CHUNK = 16  # bytes of a row a thread owns (csrc/clahe.cu kChunk)
MAX_THREADS = 512  # a block's threads at most (kMaxThreads checks it)
SMEM_TABLE_BYTES = 96 * 1024  # tables up to this size go to shared memory (kSmemTableBytes)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def blend_bilinear(l0, l1, l2, l3, xa, ya) -> torch.Tensor:
    """The reference's bilinear blend (clahe.zig:265-268) in strict f32, each
    operation a separate torch op (so rounded once), then ``trunc(res+0.5)``;
    returns f32."""
    oxa = 1.0 - xa
    oya = 1.0 - ya
    t1 = l0 * oxa + l1 * xa
    t2 = l2 * oxa + l3 * xa
    res = t1 * oya + t2 * ya
    return torch.trunc(res + 0.5)


def clahe8_lookup_ref(x: torch.Tensor, tab32: torch.Tensor, ya: torch.Tensor,
                      xa: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """Plain version of ``clahe8_lookup``: gather each pixel's packed word,
    unpack the four LUT values and blend; (n, h, w) uint8."""
    n, h, w = x.shape
    rx_n = xa.shape[-1] // tile_w
    # the pixel's coordinates on the half-tile-shifted grid, and its cell
    py = torch.arange(h, device=x.device, dtype=torch.int64) + tile_h // 2
    px = torch.arange(w, device=x.device, dtype=torch.int64) + tile_w // 2
    cell = ((py // tile_h).view(h, 1) * rx_n + (px // tile_w).view(1, w)) * HIST
    idx = (cell.view(1, h, w) + x.to(torch.int64)).reshape(n, h * w)
    word = tab32.reshape(n, -1).gather(1, idx).view(n, h, w)
    l0, l1, l2, l3 = (((word >> s) & 255).to(torch.float32) for s in (0, 8, 16, 24))
    res = blend_bilinear(l0, l1, l2, l3, xa.reshape(-1)[px].view(1, 1, w),
                         ya.reshape(-1)[py].view(1, h, 1))
    return res.to(torch.uint8)


# ---------------------------------------------------------------------------
# the kernel's size rules
# ---------------------------------------------------------------------------

def table_on_chip(ry_n: int, rx_n: int) -> bool:
    """Whether a frame's table of ry_n x rx_n cells is staged in shared
    memory; past ``SMEM_TABLE_BYTES`` the kernel reads it through the
    read-only cache."""
    return ry_n * rx_n * HIST * 4 <= SMEM_TABLE_BYTES


def chunk_vector(w: int, *ptrs: int) -> int:
    """Bytes a load or store of the kernel moves: the widest of 16, 8 and 4
    that divides the row and every plane's address, else 1."""
    return next((v for v in (16, 8, 4) if w % v == 0 and all(p % v == 0 for p in ptrs)), 1)


def block_shape(w: int) -> tuple[int, int]:
    """The kernel's block for rows of `w` bytes: bx threads across a row,
    one chunk each, up to ``MAX_THREADS``, and by rows, the by in [1,
    MAX_THREADS // bx] whose block leaves the smallest share of its last
    warp's lanes idle, the smallest such by (120 x 4 at 1920)."""
    bx = min(-(-w // CHUNK), MAX_THREADS)
    idle = [(-(-bx * by // 32) * 32 - bx * by) / (-(-bx * by // 32) * 32)
            for by in range(1, MAX_THREADS // bx + 1)]
    return bx, idle.index(min(idle)) + 1


# ---------------------------------------------------------------------------
# entry point (the library is built by ``_build`` at the first launch)
# ---------------------------------------------------------------------------

_LOOKUP = _build.kernel("clahe", "vz_clahe8_lookup", *[ctypes.c_void_p] * 5,
                        *[ctypes.c_int] * 11)


def _check(x, tab32, ya, xa, tile_h, tile_w) -> tuple[int, int]:
    """Raise unless the kernel takes these inputs; returns (ry_n, rx_n)."""
    if x.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no CLAHE kernel for device {x.device}")
    if x.dtype != torch.uint8 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("vszip_tpu_torch: clahe8_lookup takes a contiguous (N, H, W) "
                         f"uint8 tensor, got {x.dtype} {tuple(x.shape)}")
    n, h, w = x.shape
    ry_n, rx_n = ya.shape[0], xa.shape[-1] // max(tile_w, 1)
    if (tile_h < 1 or tile_w < 1 or ya.shape != (ry_n, tile_h)
            or xa.shape != (1, rx_n * tile_w)
            or ry_n * tile_h < h + tile_h // 2 or rx_n * tile_w < w + tile_w // 2):
        raise ValueError("vszip_tpu_torch: clahe8_lookup: fractions do not cover the "
                         f"plane ({tuple(ya.shape)}, {tuple(xa.shape)}, tile "
                         f"{tile_h}x{tile_w}, plane {h}x{w})")
    for name, t, dt, shape in (("tab32", tab32, torch.int32, (n, ry_n, rx_n * HIST)),
                               ("ya", ya, torch.float32, tuple(ya.shape)),
                               ("xa", xa, torch.float32, tuple(xa.shape))):
        if (t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"vszip_tpu_torch: clahe8_lookup takes a contiguous {dt} "
                             f"{name} {shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return ry_n, rx_n


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

@trace.spanned("vszip.kernel.clahe8_lookup", profiled=False)
def clahe8_lookup(x: torch.Tensor, tab32: torch.Tensor, ya: torch.Tensor,
                  xa: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """CLAHE's 8-bit 4-LUT bilinear blend (B7); (n, h, w) uint8."""
    if x.device.type == "cpu":
        return clahe8_lookup_ref(x, tab32, ya, xa, tile_h, tile_w)
    ry_n, rx_n = _check(x, tab32, ya, xa, tile_h, tile_w)
    n, h, w = x.shape
    out = torch.empty_like(x)
    vec = chunk_vector(w, x.data_ptr(), out.data_ptr())
    _LOOKUP(x.device, x.data_ptr(), tab32.data_ptr(), ya.data_ptr(), xa.data_ptr(),
            out.data_ptr(), n, h, w, tile_h, tile_w, ry_n, rx_n,
            int(table_on_chip(ry_n, rx_n)), vec, *block_shape(w))
    LAUNCHES["clahe8_lookup"] += 1
    return out
