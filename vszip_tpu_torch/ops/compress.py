"""Compress: MPEG-2 / JPEG intra-block compression-artifact simulator.

The PyTorch counterpart of ``vszip_tpu.ops.compress`` (reference
src/filters/compress.zig + src/vapoursynth/compress.zig): per 8x8 block the
JPEG "islow" forward DCT (CONST_BITS=13, PASS1_BITS=4), the MPEG-2 deadzone
or JPEG symmetric quantize/dequantize, and the FFmpeg simple IDCT
(ROW_SHIFT=11, COL_SHIFT=20, DC-only row fast path).  All arithmetic wraps
in i32 (i64 for the quantizer products in the wide regimes) with i16
truncation between stages, so results are bit-exact to the reference.

The host part (the tables and ``_quant_setup`` with its wide decision) is a
copy of the JAX package's, in NumPy; the transforms' and quantizers'
constants live with B14 in ``kernels.compress``.  Every processed
plane goes through ``kernels.compress.compress_plane`` (B14): a CUDA tensor
launches the kernel in both the i32 and the i64 regimes, a CPU tensor takes
its plain version.  The plane is edge-padded to multiples of 8 inside the
kernel (clamped reads) and in the plain version (clamped indices).
"""

from __future__ import annotations

import numpy as np

from ..core.clip import Clip
from ..core.format import ColorFamily, SampleType
from ..core.params import VSZipError, require
from ..kernels import compress as kernels
from ..kernels.compress import JPEG_BIAS, MPEG_BIAS, MPEG_THRESH1, MPEG_THRESH2, QMAT_SHIFT
from ..trace import spanned

FILTER_NAME = "Compress"

# standard tables (MPEG-1/2 default intra matrix; JPEG Annex K quant tables)
MPEG_INTRA = np.array([
    8, 16, 19, 22, 26, 27, 29, 34,
    16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38,
    22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48,
    26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69,
    27, 29, 35, 38, 46, 56, 69, 83,
], np.int64)

JPEG_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)

JPEG_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], np.int64)


def _quant_setup(codec: str, qscale: int, dc_prec: int, quality: int,
                 is_chroma: bool):
    """Host-side quantizer tables and the i64-wide decision.  Returns (qa,
    qb, wide, consts): qa/qb the per-coefficient (64,) quant/dequant tables,
    `wide` whether a quantizer product can leave i32 (then it is taken in
    i64), `consts` the scalar constants of the regime.

    Wide regimes, from this formula: MPEG qscale 1 and 2; JPEG luma at
    quality >= 78, chroma at >= 87."""
    if codec == "mpeg2":
        qscale2 = qscale << 1
        qmat = (2 << QMAT_SHIFT) // (qscale2 * MPEG_INTRA)
        # DCT coefs fit i16, so the AC quant product is bounded by
        # 32767*max(qmat[1:]); the DC entry takes its own path
        wide = (32767 * int(qmat[1:].max())
                + max(MPEG_BIAS, MPEG_THRESH1) >= 2**31)
        deq = qscale2 * MPEG_INTRA
        dc_scale = 8 >> dc_prec
        dc_q = dc_scale << 3
        consts = (MPEG_THRESH1, MPEG_THRESH2, MPEG_BIAS, QMAT_SHIFT,
                  int(np.log2(dc_q)), dc_scale)
        return qmat, deq, wide, consts
    base = JPEG_CHROMA if is_chroma else JPEG_LUMA
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    qtab = np.clip((base * scale + 50) // 100, 1, 255)
    jqmat = (1 << QMAT_SHIFT) // (8 * qtab)
    wide = 32767 * int(jqmat.max()) + JPEG_BIAS >= 2**31
    return jqmat, qtab, wide, (JPEG_BIAS, QMAT_SHIFT)


@spanned("vszip.op.compress")
def compress(clip: Clip, codec: int = 0, quality: int = 50, qscale: int = 8,
             dc_prec: int = 0, chroma: bool = True) -> Clip:
    """vszip.Compress (reference src/vapoursynth/compress.zig): codec 0 =
    MPEG-2 intra (qscale 1..31, dc_prec 0..3), codec 1 = JPEG (quality
    1..100); chroma=False passes chroma planes through.  8-bit Gray/YUV."""
    fmt = clip.format
    require(
        fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 8
        and fmt.color_family is not ColorFamily.RGB,
        FILTER_NAME, "only 8-bit integer Gray or YUV formats are supported.",
    )
    if codec not in (0, 1):
        raise VSZipError(f"{FILTER_NAME}: codec must be 0 (mpeg2) or 1 (jpeg).")
    if codec == 0:
        if not (1 <= int(qscale) <= 31):
            raise VSZipError(f"{FILTER_NAME}: qscale must be between 1 and 31.")
        if not (0 <= int(dc_prec) <= 3):
            raise VSZipError(f"{FILTER_NAME}: dc_prec must be between 0 and 3.")
    else:
        if not (1 <= int(quality) <= 100):
            raise VSZipError(f"{FILTER_NAME}: quality must be between 1 and 100.")
    codec_name = "jpeg" if codec == 1 else "mpeg2"
    process = [True, bool(chroma), bool(chroma)]

    out = []
    for p, x in enumerate(clip.planes):
        if not process[p]:
            out.append(x)
            continue
        qa, qb, wide, _ = _quant_setup(codec_name, int(qscale), int(dc_prec),
                                       int(quality), p > 0)
        out.append(kernels.compress_plane(x.contiguous(), qa, qb, codec == 1,
                                          int(dc_prec), wide))
    return clip.with_planes(out)
