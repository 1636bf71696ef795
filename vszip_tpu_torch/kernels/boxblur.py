"""BoxBlur integer kernels: CUDA wrappers, their plain PyTorch versions, and
launch counters.

Each wrapper takes an ``(N, H, W)`` uint8/uint16 tensor and dispatches on the
tensor's device, the per-tensor analogue of the JAX package's ``_on_tpu()``:

* a CPU tensor takes the plain PyTorch version beside the wrapper;
* a CUDA tensor launches the hand-written kernel in ``csrc/boxblur.cu`` or
  raises.  Nothing falls back to the plain version, and a failed build
  raises.

=====================  ==============================================  ============================
wrapper                replaces (vszip_tpu/kernels/boxblur_pallas.py)   CUDA kernel
=====================  ==============================================  ============================
``ct_blur_int``        ``ct_blur_int_pallas`` (:279)                   ct_blur (ct_v_chip, h_fixed)
``rt_blur_h``          ``rt_blur_h_pallas`` (:670)                     h_fixed
``rt_blur_v_multi``    ``rt_blur_v_multi_pallas`` (:580)               v_chip (v_fixed)
``rt_blur_v``          ``rt_blur_v_pallas`` (:432)                     v_chip (v_fixed)
=====================  ==============================================  ============================

What bounds them on an H100 is device-memory bytes: a pass reads and writes
each plane once, about 12.4 MB per 1080p YUV420P16 frame against 3.35 TB/s,
and does a few integer operations per byte.  The Pallas kernels are shaped by
what the TPU lacks (bf16 band matmuls on the MXU, hi/lo byte splits, u32
limbs, 64-row strips with clamped neighbour views); the CUDA kernels keep
only the arithmetic: native int32/int64 running and prefix sums, with a
warp's loads on neighbouring addresses.  ``v_chip`` runs all vertical
passes of a 128-byte strip of columns in one warp as a wavefront down the
strip (pass p trails pass p-1 by r+1 rows, each keeps its last 2r+1 input
rows in a shared-memory ring, the input comes in by 16-byte ``cp.async``
copies 16 rows ahead), so the plane is read and written once per call;
where its rings would not fit a block's shared memory, or for more than
``V_CHIP_PASSES`` passes (``v_fixed_on_chip``), ``v_fixed`` walks one column
per thread and ping-pongs the passes through device memory.  ``h_fixed``
runs one warp a row with the row in registers for all passes where
``h_fixed_warp_shape`` gives a shape (rows up to about 2,000 samples, r <= 23):
each lane holds runs of exactly 2r + 1 samples, so a window's two ends sit
in the same register of neighbouring runs, and a pass is a 3-input add, a
multiply-add and a shift a sample, with no shared memory and no barrier.
Other rows take its block design: one mirror-padded row per block in shared
memory, cut into segments of 8 samples, one per thread (segment sums, one
block scan, sliding sums along each segment), all passes there (a row too
long for shared memory uses a global scratch buffer that the wrapper
allocates, with the same arithmetic).  ``ct_v_chip`` is ``v_chip``'s one-pass case
with the comptime (hybrid) mirror, under which every row's window slides
from the one before, and the quantiser ``(2*col + k) // (2k)`` as a
multiply-high by the per-call (m, s) of ``quantizer``.  Its ring holds
2r + 1 + ``V_CHIP_AHEAD_ROWS`` rows, ``v_chip``'s one-pass ring
(``v_fixed_on_chip(r, 1)``: r <= 897); ``ct_blur_int`` raises past that,
which the op's comptime path (r <= 22) never reaches.  Where
``ct_blur_fused_shape`` takes the plane (r <= 22, the register design's
row, the ring and the row buffers in a block's shared memory: 1080p at r
<= 13 in uint16), B1 is one launch, ``ct_blur``: a block takes a band of
a frame's rows, half its warps slide ``ct_v_chip``'s quantised column sums
down the band into row buffers in shared memory, the other half takes those
rows two by two through ``h_fixed``'s register pass, so the intermediate
plane never reaches device memory; elsewhere its two stages run, ``ct_v_chip``
and then ``h_fixed``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import _build, trace

# Launches made on the CUDA path, per wrapper.  Each wrapper adds one where
# it launches its kernel(s) and nowhere else; the plain versions never count.
LAUNCHES = trace.register_launches({"ct_blur_int": 0, "rt_blur_h": 0, "rt_blur_v_multi": 0,
                                    "rt_blur_v": 0})
# The variant each CUDA launch took: ``ct_blur_int`` in one launch
# (``ct_fused``, where ``ct_blur_fused_shape`` gives a shape) or as its two
# stages (``ct_two_stage``: ``ct_v_chip``, then ``h_fixed``, which counts
# its own variant); ``v_fixed`` on chip (``v_chip``) or as the column walk
# (``v_fixed``); ``h_fixed`` one warp a row in registers
# (``h_fixed_warp_shape``), or a block a row with the row in shared memory
# or in a global scratch buffer.
VARIANTS = trace.register_launches({"ct_fused": 0, "ct_two_stage": 0, "v_chip": 0,
                                    "v_fixed": 0, "h_fixed_warp": 0, "h_fixed_shared": 0,
                                    "h_fixed_scratch": 0})

# ``v_chip`` (csrc/boxblur.cu) unrolls up to V_CHIP_PASSES passes, and one
# warp keeps passes * (2r + 1) + V_CHIP_AHEAD_ROWS rows of a 128-byte strip
# in shared memory, at most _build.MAX_SMEM_BYTES a block (the kernel's
# kChipPasses, kChipAheadRows, kStripBytes and kMaxSmemBytes).
V_CHIP_PASSES = 6
V_CHIP_AHEAD_ROWS = 20
V_CHIP_ROW_BYTES = 128


def v_fixed_on_chip(radius: int, passes: int) -> bool:
    """Whether ``v_chip`` takes `passes` vertical passes of `radius`; else
    the wrapper takes the column walk ``v_fixed``."""
    rows = passes * (2 * radius + 1) + V_CHIP_AHEAD_ROWS
    return passes <= V_CHIP_PASSES and rows * V_CHIP_ROW_BYTES <= _build.MAX_SMEM_BYTES


# ``h_fixed`` in registers (csrc/boxblur.cu kWarpRuns, whose instantiations
# ``vz_h_fixed_warp`` launches): (slots, chunks) runs; a lane holds up to
# `chunks` runs of n = 2r + 1 <= slots samples, one a chunk of `slots`
# registers, and the first run whose slots take n is used.
H_WARP_RUNS = ((4, 22), (8, 13), (16, 8), (24, 4), (28, 3), (32, 3), (48, 2))


@lru_cache(maxsize=256)
def h_fixed_warp_shape(w: int, radius: int, passes: int = 1):
    """(slots, chunks of the run, chunks a lane, l0, a) of ``h_fixed``'s
    register design for rows of `w` samples, or None where the block design
    takes them: the fewest chunks whose 32 lanes of runs of n = 2r + 1 hold
    the row with `a` >= passes * r samples of its mirror-periodic extension
    before it (lane `l0`'s first run starting at sample -r) and passes * r
    after it.  None past the runs (r > 23), where no chunk count of the
    first run taking n holds the row, and where r > w (the comptime quirk).
    The wrapper launches the design this chooses; the library checks that
    a shape it is given holds the row."""
    if not 1 <= radius <= w or passes < 1:
        return None
    n = 2 * radius + 1
    for slots, chunks_max in H_WARP_RUNS:
        if n > slots:
            continue
        for chunks in range(1, chunks_max + 1):
            l0 = -(-(passes - 1) * radius // (chunks * n))
            a = l0 * chunks * n + radius
            if a + w + passes * radius <= 32 * chunks * n:
                return slots, chunks_max, chunks, l0, a
        return None
    return None


def h_fixed_in_registers(w: int, radius: int, passes: int = 1) -> bool:
    """Whether ``h_fixed`` runs rows of `w` samples at `radius` and `passes`
    one warp a row in registers; else its block design."""
    return h_fixed_warp_shape(w, radius, passes) is not None


# B1 in one launch (``ct_blur_kernel``, csrc/boxblur.cu kFusedWarps,
# kFusedAhead and kCopyBars): a block of CT_FUSED_WARPS warps takes a band
# of a frame's rows, CT_FUSED_WARPS rows a group; half its threads own two
# 16-byte chunks of each row, and its ring holds 2r + 1 input rows and
# CT_FUSED_AHEAD + 1 groups.  The op's comptime path takes r <=
# CT_MAX_RADIUS; the bands' halo rows stay within CT_HALO_SHARE of a
# frame's rows.
CT_FUSED_WARPS = 8
CT_FUSED_AHEAD = 1
CT_COPY_BARS = 4
CT_MAX_RADIUS = 22
CT_HALO_SHARE = 0.1


@lru_cache(maxsize=256)
def ct_blur_fused_shape(w: int, radius: int, elem_bytes: int):
    """(slots, chunks a lane, ring rows, row buffer cells, shared bytes) of
    ``ct_blur_int`` in one launch for planes of rows of `w` samples of
    `elem_bytes`, or None where its two stages take them: r <=
    CT_MAX_RADIUS, the register pass takes the row for one pass
    (``h_fixed_warp_shape``: r <= w, the row within its runs), the row is at
    most 32 * CT_FUSED_WARPS 16-byte chunks (two a vertical thread), and
    the ring and the row buffers fit a block's shared memory.  Two sets of
    CT_FUSED_WARPS / 2 row buffers, a pair of rows each, start a row at
    `padl`, r rounded up to 16 cells, and hold its margins and what the runs
    that start before the right margin's end load and store (1080p uint16 at
    r 13: 229,152 bytes).  The library checks that a shape it is given holds
    the planes."""
    if radius > CT_MAX_RADIUS:
        return None
    shape = h_fixed_warp_shape(w, radius, 1)
    if shape is None:
        return None
    slots, _, chunks, _, _ = shape
    cols = -(-w * elem_bytes // 16)
    if cols > 32 * CT_FUSED_WARPS:
        return None
    n = 2 * radius + 1
    padl = -(-radius // 16) * 16
    rowbuf = -(-max(padl + w + 2 * radius + n, padl + cols * (16 // elem_bytes)) // 16) * 16
    ring = n + CT_FUSED_WARPS * (CT_FUSED_AHEAD + 1)
    smem = ring * cols * 16 + 2 * CT_FUSED_WARPS * rowbuf * elem_bytes + 8 * CT_COPY_BARS
    if smem > _build.MAX_SMEM_BYTES:
        return None
    return slots, chunks, ring, rowbuf, smem


def ct_blur_band_rows(h: int, radius: int, bands: int) -> list[tuple[int, int, int, int]]:
    """(y0, y1, s0, s1) of each band of a frame of `h` rows: output rows
    y0 .. y1-1 (b * h // bands onwards) from input rows s0 .. s1, the r
    rows above the band and the r below it where the frame has them (the
    top band sums W(0) from rows 0 .. r under the mirror)."""
    out = []
    for b in range(bands):
        y0, y1 = b * h // bands, (b + 1) * h // bands
        out.append((y0, y1, 0 if y0 == 0 else y0 - radius, min(y1 - 1 + radius, h - 1)))
    return out


@lru_cache(maxsize=256)
def ct_blur_bands(n: int, h: int, radius: int, blocks: int) -> int:
    """Bands a frame for `n` frames of `h` rows on a card that holds
    `blocks` blocks at once: of the counts that keep every band at r + 1
    rows or more and the halo rows within CT_HALO_SHARE of `h`, the one
    with the fewest waves of blocks times input rows of the largest band
    (the fewest bands of those that tie).  64 frames on 132 blocks: 2 bands
    of 1080 or 540 rows, one wave of 128 blocks."""
    most = min(h // (radius + 1), 1 + int(CT_HALO_SHARE * h) // (2 * radius))
    best, bands = None, 1
    for b in range(1, max(most, 1) + 1):
        rows = max(s1 + 1 - s0 for _, _, s0, s1 in ct_blur_band_rows(h, radius, b))
        cost = -(-n * b // blocks) * rows
        if best is None or cost < best:
            best, bands = cost, b
    return bands


def quantizer(radius: int) -> tuple[int, int]:
    """(m, s) with ``(n * m) >> s == n // (2k)``, k = 2r + 1, for every
    numerator n = 2*col + k of a uint16 (or uint8) plane's column sum, n <=
    N_max = k * 131071: s is the least with 2^s > N_max * (2k - 1) and m =
    ceil(2^s / 2k).  Exact because n * (m * 2k - 2^s) <= N_max * (2k - 1) <
    2^s; m < 2 N_max + 1 < 2^29 and n < 2^28 for r <= 897, so the product is
    one 32x32->64 multiply (``ct_v_chip``)."""
    k = 2 * radius + 1
    d = 2 * k
    s = (k * 131071 * (d - 1)).bit_length()
    return -(-(1 << s) // d), s


def ct_blur_multiplier(radius: int) -> int:
    """m with ``(n * m) >> 32 == n // (2k)``, k = 2r + 1, for every
    numerator n = 2*col + k of a uint16 (or uint8) plane's column sum, n <=
    N_max = k * 131071, at r <= CT_MAX_RADIUS: m = ceil(2^32 / 2k).  With
    e = m * 2k - 2^32 < 2k, n * m / 2^32 = n / 2k + n * e / (2k * 2^32),
    and n * e <= N_max * (2k - 1) < 2^32 while k <= 90, so the second term
    never reaches the next multiple of 1 / 2k.  ``ct_blur_kernel`` takes the
    high word of one 32x32 multiply."""
    return -(-(1 << 32) // (2 * (2 * radius + 1)))


# ---------------------------------------------------------------------------
# plain PyTorch versions (ops/boxblur.py:101-158 and :268-304 of vszip_tpu)
# ---------------------------------------------------------------------------

def dup_index(n: int, radius: int, device) -> torch.Tensor:
    """Source index of each position -r .. n-1+r under the duplicate-edge
    mirror m(-j) = j-1, m(n-1+j) = n-j, repeated with period 2n as NumPy's
    'symmetric' pad does when r > n (reachable only through the comptime
    quirk, where hpasses=0 skips the hradius check)."""
    k = torch.remainder(torch.arange(-radius, n + radius, device=device), 2 * n)
    return torch.where(k >= n, 2 * n - 1 - k, k)


def _window_sums(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """Sliding window sums of width 2r+1 with the duplicate-edge mirror, via
    an exclusive prefix sum over the padded axis.  int32 while the prefix sum
    cannot overflow (the JAX package's i32 hot path), else int64 (its giant
    plane fallback); both give the same exact sums."""
    n = x.shape[axis]
    acc = (torch.int32 if (n + 2 * radius) * torch.iinfo(x.dtype).max < 2**31
           else torch.int64)
    xp = x.to(acc).index_select(axis, dup_index(n, radius, x.device))
    cs = torch.cumsum(xp, dim=axis, dtype=acc)
    ksize = 2 * radius + 1
    return cs.narrow(axis, ksize - 1, n) - cs.narrow(axis, 0, n) + xp.narrow(axis, 0, n)


def _fixed_point_output(w: torch.Tensor, w0: torch.Tensor, radius: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """The reference running-sum output ``(C0 + inv2*(W - W0)) >> 16`` with
    ``C0 = (W0*inv + 2^31) >> 16``, in int64 (the JAX package's i32 limb
    split evaluates the same closed form)."""
    inv = ((1 << 32) + radius) // (2 * radius + 1)
    inv2 = inv >> 16
    c0 = (w0.to(torch.int64) * inv + (1 << 31)) >> 16
    return ((c0 + inv2 * (w - w0).to(torch.int64)) >> 16).to(dtype)


def _blur_int_rt_1d_ref(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    w = _window_sums(x, radius, axis)
    return _fixed_point_output(w, w.narrow(axis, 0, 1), radius, x.dtype)


def h_fixed_ref(x: torch.Tensor, radius: int, passes: int = 1) -> torch.Tensor:
    """`passes` runtime horizontal fixed-point passes (plain version of
    ``h_fixed``)."""
    for _ in range(passes):
        x = _blur_int_rt_1d_ref(x, radius, 2)
    return x


def v_fixed_ref(x: torch.Tensor, radius: int, passes: int = 1) -> torch.Tensor:
    """`passes` runtime vertical fixed-point passes (plain version of
    ``v_fixed``)."""
    for _ in range(passes):
        x = _blur_int_rt_1d_ref(x, radius, 1)
    return x


def hybrid_index(n: int, off: int, device) -> torch.Tensor:
    """The comptime mirror for tap offset `off`: j < 0 -> min(-j, n-1),
    j > n-1 -> max(n-1-off, 0)."""
    k = torch.arange(n, device=device) + off
    k = torch.where(k < 0, torch.clamp(-k, max=n - 1), k)
    return torch.where(k > n - 1, torch.full_like(k, max(n - 1 - off, 0)), k)


def _hybrid_window_sums(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Vertical window sums under the comptime mirror: the interior through
    one prefix sum, the r edge rows at each end from explicit taps."""
    n = x.shape[1]
    ksize = 2 * radius + 1
    xi = x.to(torch.int32)
    cs = torch.cumsum(xi, dim=1, dtype=torch.int32)
    interior = (cs.narrow(1, ksize - 1, n - 2 * radius)
                - cs.narrow(1, 0, n - 2 * radius)
                + xi.narrow(1, 0, n - 2 * radius))
    top = bot = None
    for off in range(-radius, radius + 1):
        idx = hybrid_index(n, off, x.device)
        t = xi.index_select(1, idx[:radius])
        b = xi.index_select(1, idx[n - radius:])
        top = t if top is None else top + t
        bot = b if bot is None else bot + b
    return torch.cat([top, interior, bot], dim=1)


def ct_v_ref(x: torch.Tensor, radius: int) -> torch.Tensor:
    """B1's vertical stage (plain version of ``ct_v_chip``): raw vertical
    sums under the comptime mirror quantised as ``(2*col + k) // (2k)``."""
    ksize = 2 * radius + 1
    col = _hybrid_window_sums(x, radius)
    return ((2 * col + ksize) // (2 * ksize)).to(x.dtype)


def ct_blur_int_ref(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Comptime integer BoxBlur (plain version of ``ct_blur_int``): the
    vertical stage ``ct_v_ref``, then one runtime horizontal pass."""
    return h_fixed_ref(ct_v_ref(x, radius), radius)


# ---------------------------------------------------------------------------
# entry points (the library is built by ``_build`` at the first call)
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_V_FIXED = _build.kernel("boxblur", "vz_v_fixed", _P, _P, _P, _I, _I, _I, _I, _I, _I)
_V_CHIP = _build.kernel("boxblur", "vz_v_chip", _P, _P, _I, _I, _I, _I, _I, _I)
_H_FIXED = _build.kernel("boxblur", "vz_h_fixed", _P, _P, _P, _I, _LL, _I, _I, _I)
_H_FIXED_WARP = _build.kernel("boxblur", "vz_h_fixed_warp", _P, _P, _I, _LL, _I, _I, _I,
                              _I, _I, _I, _I)
_H_FIXED_SCRATCH_WORDS = _build.entry("boxblur", "vz_h_fixed_scratch_words", _LL, _I, _I,
                                      restype=_LL)
_CT_V_CHIP = _build.kernel("boxblur", "vz_ct_v_chip", _P, _P, _I, _I, _I, _I, _I,
                         ctypes.c_uint, _I)
_CT_BLUR = _build.kernel("boxblur", "vz_ct_blur", _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, ctypes.c_uint)
_CT_BLUR_BLOCKS = _build.entry("boxblur", "vz_ct_blur_blocks", _I, _I, _LL, restype=_LL)


def _check(x: torch.Tensor, radius: int, axes: tuple[int, ...], passes: int = 1) -> None:
    """Raise unless the kernels take `x` with `radius` and `passes` >= 1: a
    vertical window must fit its axis (2r < extent, in each axis listed in
    `axes`), as the op validates; horizontally any r < 2^15 (which keeps
    ``h_fixed``'s uint32 window sums exact) works, as the comptime quirk
    needs."""
    if x.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no BoxBlur kernel for device {x.device}")
    if x.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"vszip_tpu_torch: BoxBlur kernels take uint8/uint16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("vszip_tpu_torch: BoxBlur kernels take a contiguous (N, H, W) tensor")
    if passes < 1:
        raise ValueError(f"vszip_tpu_torch: BoxBlur kernels take passes >= 1, got {passes}")
    if not 1 <= radius < 32768 or any(2 * radius >= x.shape[a] for a in axes):
        raise ValueError(
            f"vszip_tpu_torch: BoxBlur kernels do not take radius {radius} on {tuple(x.shape)}")


def _v_fixed(x: torch.Tensor, radius: int, passes: int) -> torch.Tensor:
    n, h, w = x.shape
    out = torch.empty_like(x)
    if v_fixed_on_chip(radius, passes):
        _V_CHIP(x.device, x.data_ptr(), out.data_ptr(), x.element_size(), n, h, w, radius,
                passes)
        VARIANTS["v_chip"] += 1
    else:
        scratch = torch.empty_like(x) if passes > 1 else None
        _V_FIXED(x.device, x.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), x.element_size(), n, h, w,
                 radius, passes)
        VARIANTS["v_fixed"] += 1
    return out


def _ct_v(x: torch.Tensor, radius: int) -> torch.Tensor:
    """B1's vertical stage: the quantised column sums (``ct_v_chip``)."""
    n, h, w = x.shape
    out = torch.empty_like(x)
    _CT_V_CHIP(x.device, x.data_ptr(), out.data_ptr(), x.element_size(), n, h, w, radius,
               *quantizer(radius))
    return out


@lru_cache(maxsize=64)
def _ct_blur_blocks(elem_bytes: int, slots: int, smem: int) -> int:
    """The blocks of ``ct_blur_kernel`` (run `slots`, `smem` bytes) the card
    holds at once."""
    blocks = _CT_BLUR_BLOCKS(elem_bytes, slots, smem)
    if blocks < 1:
        raise RuntimeError(f"vszip_tpu_torch: no resident block of ct_blur at {smem} bytes")
    return blocks


def _ct_blur(x: torch.Tensor, radius: int, shape: tuple) -> torch.Tensor:
    """B1 in one launch on `shape` (``ct_blur_fused_shape``)."""
    n, h, w = x.shape
    slots, chunks, ring, rowbuf, smem = shape
    bands = ct_blur_bands(n, h, radius, _ct_blur_blocks(x.element_size(), slots, smem))
    out = torch.empty_like(x)
    _CT_BLUR(x.device, x.data_ptr(), out.data_ptr(), x.element_size(), n, h, w, radius, bands,
             slots, chunks, ring, rowbuf, ct_blur_multiplier(radius))
    return out


def _h_fixed(x: torch.Tensor, radius: int, passes: int) -> torch.Tensor:
    n, h, w = x.shape
    out = torch.empty_like(x)
    shape = h_fixed_warp_shape(w, radius, passes)
    if shape is not None:
        slots, _, chunks, l0, a = shape
        _H_FIXED_WARP(x.device, x.data_ptr(), out.data_ptr(), x.element_size(), n * h, w,
                      radius, passes, slots, chunks, l0, a)
        VARIANTS["h_fixed_warp"] += 1
        return out
    words = _H_FIXED_SCRATCH_WORDS(n * h, w, radius)
    scratch = torch.empty(words, dtype=torch.int32, device=x.device) if words else None
    _H_FIXED(x.device, x.data_ptr(), out.data_ptr(),
             None if scratch is None else scratch.data_ptr(), x.element_size(), n * h, w,
             radius, passes)
    VARIANTS["h_fixed_scratch" if words else "h_fixed_shared"] += 1
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@trace.spanned("vszip.kernel.ct_blur_int", profiled=False)
def ct_blur_int(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Comptime integer BoxBlur, one pass each axis (B1), r <= 897 (the
    ring of ``ct_v_chip``, on either device): one launch where
    ``ct_blur_fused_shape`` gives a shape, else its two stages."""
    if not v_fixed_on_chip(radius, 1):
        raise ValueError(f"vszip_tpu_torch: ct_blur_int takes radius <= 897, got {radius}")
    if x.device.type == "cpu":
        return ct_blur_int_ref(x, radius)
    _check(x, radius, (1,))
    shape = ct_blur_fused_shape(x.shape[2], radius, x.element_size())
    if shape is not None:
        out = _ct_blur(x, radius, shape)
        VARIANTS["ct_fused"] += 1
    else:
        out = _h_fixed(_ct_v(x, radius), radius, 1)
        VARIANTS["ct_two_stage"] += 1
    LAUNCHES["ct_blur_int"] += 1
    return out


@trace.spanned("vszip.kernel.rt_blur_h", profiled=False)
def rt_blur_h(x: torch.Tensor, radius: int, passes: int = 1) -> torch.Tensor:
    """`passes` runtime horizontal passes in one launch (B2)."""
    if x.device.type == "cpu":
        return h_fixed_ref(x, radius, passes)
    _check(x, radius, (), passes)
    out = _h_fixed(x, radius, passes)
    LAUNCHES["rt_blur_h"] += 1
    return out


@trace.spanned("vszip.kernel.rt_blur_v_multi", profiled=False)
def rt_blur_v_multi(x: torch.Tensor, radius: int, passes: int) -> torch.Tensor:
    """`passes` runtime vertical passes in one launch (B3)."""
    if x.device.type == "cpu":
        return v_fixed_ref(x, radius, passes)
    _check(x, radius, (1,), passes)
    out = _v_fixed(x, radius, passes)
    LAUNCHES["rt_blur_v_multi"] += 1
    return out


@trace.spanned("vszip.kernel.rt_blur_v", profiled=False)
def rt_blur_v(x: torch.Tensor, radius: int) -> torch.Tensor:
    """One runtime vertical pass (B4)."""
    if x.device.type == "cpu":
        return v_fixed_ref(x, radius, 1)
    _check(x, radius, (1,))
    out = _v_fixed(x, radius, 1)
    LAUNCHES["rt_blur_v"] += 1
    return out
