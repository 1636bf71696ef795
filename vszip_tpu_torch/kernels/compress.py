"""Compress's fused 8x8 pipeline (B14): CUDA wrapper, its plain PyTorch
version, and the launch counter.

``compress_plane`` replaces ``compress_plane_pallas``
(vszip_tpu/kernels/compress_pallas.py:191) and the XLA chain the JAX package
takes in the wide regimes (``_compress_plane``, ops/compress.py:297): per
8x8 block of an (N, H, W) uint8 plane, edge-padded to multiples of 8, the
islow forward DCT, the MPEG-2 or JPEG quantize/dequantize with the (64,)
tables ``qa``/``qb``, and the simple IDCT, back to uint8.  `wide` says that
a quantizer product may leave i32 (``ops.compress._quant_setup``): it is
then taken in i64, as the JAX package does; otherwise it wraps in i32.

It dispatches on the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches ``compress_kernel`` in ``csrc/compress.cu`` (both
regimes) or raises.  Nothing falls back.

The plain version applies each transform as its 8x8 integer matrix
(``_fdct_mat``/``_idct_mat``, equal to the butterflies mod 2^32) by
broadcast multiplies and sums in int64, and wraps to i32 and i16 with
explicit masks: torch promises no wrap for int32 overflow, and CUDA has no
integer matmul.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, trace

# Launches made on the CUDA path.  The wrapper adds one where it launches its
# kernel and nowhere else; the plain version never counts.
LAUNCHES = trace.register_launches({"compress_plane": 0})
TABLE = 64


# ---------------------------------------------------------------------------
# the transforms' and quantizers' constants (a copy of the JAX package's)
# ---------------------------------------------------------------------------

# islow FDCT constants
_F = dict(
    F0_298631336=2446, F0_390180644=3196, F0_541196100=4433,
    F0_765366865=6270, F0_899976223=7373, F1_175875602=9633,
    F1_501321110=12299, F1_847759065=15137, F1_961570560=16069,
    F2_053119869=16819, F2_562915447=20995, F3_072711026=25172,
)
CONST_BITS, PASS1_BITS = 13, 4
QMAT_SHIFT = 21
INTRA_QUANT_BIAS = 3 << (8 - 3)
MPEG_BIAS = INTRA_QUANT_BIAS * (1 << (QMAT_SHIFT - 8))
MPEG_THRESH1 = (1 << QMAT_SHIFT) - MPEG_BIAS - 1
MPEG_THRESH2 = MPEG_THRESH1 << 1
JPEG_BIAS = 1 << (QMAT_SHIFT - 1)
W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
ROW_SHIFT, COL_SHIFT = 11, 20
COL_DC_BIAS = (1 << (COL_SHIFT - 1)) // W4


def _unit_rows():
    return [np.eye(8, dtype=np.int64)[i] for i in range(8)]


def _fdct_mat() -> np.ndarray:
    """(8, 8) integer matrix M with raw_fdct[j] = sum_c M[j,c] * in[c]: each
    islow FDCT output is one exact integer linear combination followed by a
    single rounding shift, so tracing the butterfly over unit vectors
    recovers its row."""
    t = _unit_rows()
    tmp0, tmp7 = t[0] + t[7], t[0] - t[7]
    tmp1, tmp6 = t[1] + t[6], t[1] - t[6]
    tmp2, tmp5 = t[2] + t[5], t[2] - t[5]
    tmp3, tmp4 = t[3] + t[4], t[3] - t[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    o = [None] * 8
    o[0] = tmp10 + tmp11
    o[4] = tmp10 - tmp11
    z1 = (tmp12 + tmp13) * _F["F0_541196100"]
    o[2] = z1 + tmp13 * _F["F0_765366865"]
    o[6] = z1 + tmp12 * (-_F["F1_847759065"])
    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * _F["F1_175875602"]
    o4 = tmp4 * _F["F0_298631336"]
    o5 = tmp5 * _F["F2_053119869"]
    o6 = tmp6 * _F["F3_072711026"]
    o7 = tmp7 * _F["F1_501321110"]
    z1 = z1 * (-_F["F0_899976223"])
    z2 = z2 * (-_F["F2_562915447"])
    z3 = z3 * (-_F["F1_961570560"]) + z5
    z4 = z4 * (-_F["F0_390180644"]) + z5
    o[7] = o4 + z1 + z3
    o[5] = o5 + z2 + z4
    o[3] = o6 + z2 + z3
    o[1] = o7 + z1 + z4
    return np.stack(o)


def _idct_mat() -> np.ndarray:
    """(8, 8) matrix of the FFmpeg simple-IDCT butterfly (both passes use the
    same linear form; the row and column biases are added before the
    shift)."""
    c = _unit_rows()
    a0 = W4 * c[0]
    a1, a2, a3 = a0.copy(), a0.copy(), a0.copy()
    a0 = a0 + W2 * c[2]
    a1 = a1 + W6 * c[2]
    a2 = a2 - W6 * c[2]
    a3 = a3 - W2 * c[2]
    b0 = W1 * c[1] + W3 * c[3]
    b1 = W3 * c[1] - W7 * c[3]
    b2 = W5 * c[1] - W1 * c[3]
    b3 = W7 * c[1] - W5 * c[3]
    a0 = a0 + W4 * c[4] + W6 * c[6]
    a1 = a1 - W4 * c[4] - W2 * c[6]
    a2 = a2 - W4 * c[4] + W2 * c[6]
    a3 = a3 + W4 * c[4] - W6 * c[6]
    b0 = b0 + W5 * c[5] + W7 * c[7]
    b1 = b1 - W1 * c[5] - W5 * c[7]
    b2 = b2 + W7 * c[5] + W3 * c[7]
    b3 = b3 + W3 * c[5] - W1 * c[7]
    return np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                     a3 - b3, a2 - b2, a1 - b1, a0 - b0])


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to the i32 range."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _i16(v: torch.Tensor) -> torch.Tensor:
    """int64 values truncated to the i16 range (i16 wraps of i32 lanes)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _sign(v: torch.Tensor) -> torch.Tensor:
    return (v > 0).to(torch.int64) - (v < 0).to(torch.int64)


def _apply(mat: np.ndarray, x: torch.Tensor, axis: int) -> torch.Tensor:
    """out[.., j, ..] = sum_k mat[j, k] * x[.., k, ..] along `axis` (of size
    8) in int64, wrapped to i32 as the reference's accumulation wraps."""
    outs = []
    for j in range(8):
        acc = None
        for k in range(8):
            c = int(mat[j, k])
            if c:
                t = x.select(axis, k) * c
                acc = t if acc is None else acc + t
        outs.append(acc)
    return _i32(torch.stack(outs, dim=axis))


def _lane(axis_len: int, pred, axis: int, ndim: int, device) -> torch.Tensor:
    """Boolean mask over an axis of 8 lanes, broadcastable along `axis`."""
    m = torch.tensor([pred(i) for i in range(axis_len)], device=device)
    shape = [1] * ndim
    shape[axis] = axis_len
    return m.view(shape)


def dequantized(x: torch.Tensor, qa, qb, jpeg: bool, dc_prec: int,
                wide: bool) -> torch.Tensor:
    """The first half of ``compress_plane_ref``: the plane edge-padded to
    multiples of 8, forward DCT, quantized and dequantized; int64 of shape
    (N, H/8, 8 rows, W/8, 8 columns)."""
    n, h, w = x.shape
    dev = x.device
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    ys = torch.arange(hp, device=dev).clamp(max=h - 1)
    xs = torch.arange(wp, device=dev).clamp(max=w - 1)
    level = 128 if jpeg else 0
    v = x.index_select(1, ys).index_select(2, xs).to(torch.int64) - level
    v = v.view(n, hp // 8, 8, wp // 8, 8)
    col04 = _lane(8, lambda i: i % 4 == 0, 4, 5, dev)
    row04 = _lane(8, lambda i: i % 4 == 0, 2, 5, dev)

    # forward DCT: rows (along the columns axis), then columns
    raw = _apply(_fdct_mat(), v, 4)
    p1 = _i16(torch.where(col04, _i32(raw * (1 << PASS1_BITS)),
                          _i32(raw + (1 << (CONST_BITS - PASS1_BITS - 1)))
                          >> (CONST_BITS - PASS1_BITS)))
    raw2 = _apply(_fdct_mat(), p1, 2)
    coeff = _i16(torch.where(row04, _i32(raw2 + (1 << (PASS1_BITS - 1))) >> PASS1_BITS,
                             _i32(raw2 + (1 << (CONST_BITS + PASS1_BITS - 1)))
                             >> (CONST_BITS + PASS1_BITS)))

    # quantize / dequantize, tables indexed by (row in block)*8 + column
    qa_t = torch.as_tensor(np.asarray(qa, np.int64).reshape(8, 8), device=dev).view(1, 1, 8, 1, 8)
    qb_t = torch.as_tensor(np.asarray(qb, np.int64).reshape(8, 8), device=dev).view(1, 1, 8, 1, 8)
    wrap = (lambda t: t) if wide else _i32
    lv = wrap(coeff * qa_t)
    if jpeg:
        q = torch.where(lv > 0, wrap(JPEG_BIAS + lv) >> QMAT_SHIFT,
                        torch.where(lv < 0, wrap(-(wrap(JPEG_BIAS - lv) >> QMAT_SHIFT)), 0))
        return _i16(_i32(_i32(q) * qb_t))
    dc_scale = 8 >> dc_prec
    dc_q = dc_scale << 3
    dc_lv = coeff + (dc_q >> 1)
    dc_out = _sign(dc_lv) * (dc_lv.abs() // dc_q)  # trunc division
    if wide:
        inrange = (lv + MPEG_THRESH1 < 0) | (lv + MPEG_THRESH1 > MPEG_THRESH2)
    else:  # the u32 window test on the wrapped sum
        inrange = ((lv + MPEG_THRESH1) & 0xFFFFFFFF) > MPEG_THRESH2
    q = torch.where(lv > 0, wrap(MPEG_BIAS + lv) >> QMAT_SHIFT,
                    wrap(-(wrap(MPEG_BIAS - lv) >> QMAT_SHIFT)))
    ac = _i32(torch.where(inrange, q, 0))
    deq_ac = _i16(_sign(ac) * (_i32(_i32(ac.abs()) * qb_t) >> 4))
    dcm = (_lane(8, lambda i: i == 0, 2, 5, dev) & _lane(8, lambda i: i == 0, 4, 5, dev))
    return torch.where(dcm, _i16(dc_out * dc_scale), deq_ac)


def compress_plane_ref(x: torch.Tensor, qa, qb, jpeg: bool, dc_prec: int,
                       wide: bool) -> torch.Tensor:
    """Plain version of ``compress_plane``: ``_compress_plane``'s arithmetic
    on the plane edge-padded to multiples of 8, cropped back; (N, H, W)
    uint8."""
    n, h, w = x.shape
    outq = dequantized(x, qa, qb, jpeg, dc_prec, wide)

    # inverse DCT: rows with the DC-only fast path, then columns
    raw = _apply(_idct_mat(), outq, 4)
    rows = _i16(_i32(raw + (1 << (ROW_SHIFT - 1))) >> ROW_SHIFT)
    dc_only = ~(outq.narrow(4, 1, 7) != 0).any(4, keepdim=True)
    rows = torch.where(dc_only, _i16(outq.narrow(4, 0, 1) * 8), rows)
    raw2 = _apply(_idct_mat(), rows, 2)
    pix = (_i32(raw2 + W4 * COL_DC_BIAS) >> COL_SHIFT) + (128 if jpeg else 0)
    out = pix.clamp(0, 255).to(torch.uint8).view(n, outq.shape[1] * 8, outq.shape[3] * 8)
    return out[:, :h, :w].contiguous()


# ---------------------------------------------------------------------------
# entry point (the library is built by ``_build`` at the first launch)
# ---------------------------------------------------------------------------

_COMPRESS = _build.kernel("compress", "vz_compress", *[ctypes.c_void_p] * 4,
                          *[ctypes.c_int] * 6)


def _table(t, name: str) -> ctypes.Array:
    """A (64,) table as a host int32 array for the kernel's arguments."""
    a = np.asarray(t, np.int64).reshape(-1)
    if a.shape != (TABLE,) or a.min() < 0 or a.max() >= 2**31:
        raise ValueError(f"vszip_tpu_torch: compress_plane takes a (64,) non-negative "
                         f"int32 {name}, got {a.shape}")
    return (ctypes.c_int32 * TABLE)(*a.tolist())


def _check(x: torch.Tensor, dc_prec: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no Compress kernel for device {x.device}")
    if x.dtype != torch.uint8 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("vszip_tpu_torch: compress_plane takes a contiguous (N, H, W) "
                         f"uint8 tensor, got {x.dtype} {tuple(x.shape)}")
    if not 0 <= dc_prec <= 3:
        raise ValueError(f"vszip_tpu_torch: compress_plane takes dc_prec 0..3, got {dc_prec}")


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

@trace.spanned("vszip.kernel.compress_plane", profiled=False)
def compress_plane(x: torch.Tensor, qa, qb, jpeg: bool, dc_prec: int,
                   wide: bool) -> torch.Tensor:
    """fdct -> quantize -> dequantize -> idct per 8x8 block (B14); (N, H, W)
    uint8."""
    if x.device.type == "cpu":
        return compress_plane_ref(x, qa, qb, jpeg, dc_prec, wide)
    _check(x, dc_prec)
    ta, tb = _table(qa, "qa"), _table(qb, "qb")
    n, h, w = x.shape
    out = torch.empty_like(x)
    _COMPRESS(x.device, x.data_ptr(), ta, tb, out.data_ptr(), n, h, w, int(jpeg), dc_prec,
              int(wide))
    LAUNCHES["compress_plane"] += 1
    return out
