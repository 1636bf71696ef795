"""Minimal NumPy PNG and BMP decoders for ImageRead (a copy of the JAX
package's ``io/png.py``; decoding stays on the host).

The reference uses the zigimg library (reference
src/vapoursynth/image_read.zig); this is an independent stdlib-only decoder
covering the formats the test suite and typical pipelines feed: PNG color
types 0/2/3/4/6 (grayscale at 1/2/4/8/16 bit, palette at 1/2/4/8 bit,
RGB/alpha at 8/16 bit), Adam7 interlacing, and uncompressed 24/32-bit BMP.
PNG color chunks (gAMA/sRGB/cHRM/cICP) are captured for the color-prop
mapping.  Inflate is zlib's; the scanline unfilter runs in the native
library (``runtime/png_native.py``) or raises, with no fallback;
``_unfilter_py`` is its plain version, which only the tests call.  The
IDAT chunks are joined once, where the JAX package appends them one by one
(quadratic in their count); the bytes inflated are the same.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..runtime import png_native


@dataclass
class DecodedImage:
    pixels: np.ndarray          # (H, W, C) uint8, uint16 or float32
    gray: bool
    has_alpha: bool
    chunks: dict = field(default_factory=dict)  # gama/srgb/chrm/cicp
    # zigimg PixelFormat tag of the SOURCE file (reference
    # src/vapoursynth/image_read.zig:349 sets it as the zigimg_format
    # frame prop) and its bits-per-channel (zigimg_bits prop; may be < 8
    # for sub-byte gray/indexed sources even though pixels are widened)
    zformat: str = ""
    zbits: int = 0

    def __post_init__(self):
        if not self.zformat:
            c = self.pixels.shape[-1]
            if self.pixels.dtype == np.float32:
                self.zformat = "float32"
            elif self.gray:
                b = 8 if self.pixels.dtype == np.uint8 else 16
                self.zformat = f"grayscale{b}" + ("Alpha" if self.has_alpha
                                                 else "")
            else:
                b = 8 if self.pixels.dtype == np.uint8 else 16
                self.zformat = (("rgba32" if b == 8 else "rgba64")
                                if c == 4 else
                                ("rgb24" if b == 8 else "rgb48"))
        if not self.zbits:
            self.zbits = (32 if self.pixels.dtype == np.float32
                          else 8 if self.pixels.dtype == np.uint8 else 16)


def _paeth(a, b, c):
    p = int(a) + int(b) - int(c)
    pa, pb, pc = abs(p - int(a)), abs(p - int(b)), abs(p - int(c))
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    return png_native.unfilter(raw, h, stride, bpp)


def _unfilter_py(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = raw[pos]
        row = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        if ft == 0:
            cur = row
        elif ft == 2:  # Up
            cur = (row + prev) & 0xFF
        elif ft == 3:  # Average
            cur = row.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 1:  # Sub
            cur = row.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ft == 4:  # Paeth
            cur = row.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                ul = prev[i - bpp] if i >= bpp else 0
                cur[i] = (row[i] + _paeth(left, prev[i], ul)) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ft}")
        out[y] = cur
        prev = cur
    return out


# Adam7 pass grids: (x0, y0, dx, dy)
_ADAM7 = (
    (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
    (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2),
)


def _unpack_samples(rows: np.ndarray, w: int, nchan: int,
                    depth: int) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, w, nchan) uint8/uint16 raw
    samples (sub-byte depths unpacked MSB-first, not yet scaled)."""
    h = rows.shape[0]
    if depth == 16:
        return (rows.reshape(h, -1).view(">u2").astype(np.uint16)
                [:, : w * nchan].reshape(h, w, nchan))
    if depth == 8:
        return rows[:, : w * nchan].reshape(h, w, nchan)
    per = 8 // depth
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, per, depth)
    weights = 1 << np.arange(depth - 1, -1, -1)
    vals = (bits * weights).sum(axis=3, dtype=np.int32).reshape(h, -1)
    return vals[:, : w * nchan].astype(np.uint8).reshape(h, w, nchan)


def decode_png(data: bytes) -> DecodedImage:
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    chunks: dict = {}
    w = h = depth = ctype = None
    interlace = 0
    palette = None
    trns = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        cid = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if cid == b"IHDR":
            w, h, depth, ctype, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", body
            )
        elif cid == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif cid == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif cid == b"IDAT":
            idat.append(body)
        elif cid == b"gAMA" and length == 4:
            chunks["gama"] = struct.unpack(">I", body)[0]
        elif cid == b"sRGB" and length == 1:
            chunks["srgb"] = True
        elif cid == b"cHRM" and length == 32:
            chunks["chrm"] = struct.unpack(">8I", body)
        elif cid == b"cICP" and length == 4:
            chunks["cicp"] = tuple(body)
        elif cid == b"IEND":
            break
    if w is None:
        raise ValueError("missing IHDR")
    nchan = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    if ctype in (2, 4, 6) and depth not in (8, 16):
        raise ValueError(f"unsupported PNG bit depth {depth}")
    if ctype == 3 and depth not in (1, 2, 4, 8):
        raise ValueError(f"unsupported PNG palette depth {depth}")
    if ctype == 0 and depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported PNG bit depth {depth}")
    bpp = max(1, nchan * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        # Adam7: seven independently filtered sub-image passes
        if interlace != 1:
            raise ValueError(f"bad PNG interlace method {interlace}")
        px = np.zeros(
            (h, w, nchan), np.uint16 if depth == 16 else np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            wp = -((w - x0) // -dx)
            hp = -((h - y0) // -dy)
            if wp <= 0 or hp <= 0:
                continue
            sp = (wp * nchan * depth + 7) // 8
            rows = _unfilter(raw[off : off + hp * (1 + sp)], hp, sp, bpp)
            off += hp * (1 + sp)
            px[y0::dy, x0::dx] = _unpack_samples(rows, wp, nchan, depth)
    else:
        stride = (w * nchan * depth + 7) // 8
        rows = _unfilter(raw, h, stride, bpp)
        px = _unpack_samples(rows, w, nchan, depth)
    if ctype == 0 and depth < 8:
        # scale sub-byte gray to 8-bit by bit replication (0..2^d-1 -> 0..255)
        px = (px.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(
            np.uint8)
    if ctype == 3:
        idx = px[:, :, 0]
        rgb = palette[idx]
        ztag, zb = f"indexed{depth}", depth
        if trns is not None:
            a = np.full((h, w), 255, np.uint8)
            lim = min(len(trns), palette.shape[0])
            a = np.where(idx < lim, np.take(
                np.concatenate([trns, np.full(256 - len(trns), 255, np.uint8)]),
                idx), a)
            px = np.concatenate([rgb, a[..., None]], axis=-1)
            return DecodedImage(px, False, True, chunks, ztag, zb)
        # indexed => alpha clip
        return DecodedImage(rgb, False, True, chunks, ztag, zb)
    gray = ctype in (0, 4)
    has_alpha = ctype in (4, 6)
    if ctype == 0 and depth < 8:
        ztag, zb = f"grayscale{depth}", depth
    else:
        ztag, zb = "", 0  # derived from pixels by __post_init__
    return DecodedImage(px, gray, has_alpha, chunks, ztag, zb)


def decode_bmp(data: bytes) -> DecodedImage:
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    (off,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    w, h = struct.unpack("<ii", data[18:26])
    planes, bpp = struct.unpack("<HH", data[26:30])
    (comp,) = struct.unpack("<I", data[30:34])
    if comp not in (0, 3) or bpp not in (24, 32):
        raise ValueError(f"unsupported BMP (bpp={bpp}, compression={comp})")
    flip = h > 0
    h = abs(h)
    bypp = bpp // 8
    stride = (w * bypp + 3) & ~3
    arr = np.frombuffer(data, np.uint8, stride * h, off).reshape(h, stride)
    arr = arr[:, : w * bypp].reshape(h, w, bypp)
    if flip:
        arr = arr[::-1]
    rgb = arr[:, :, 2::-1]  # BGR(A) -> RGB
    if bpp == 32:
        px = np.concatenate([rgb, arr[:, :, 3:4]], axis=-1)
        return DecodedImage(np.ascontiguousarray(px), False, True, {},
                            "bgra32", 8)
    return DecodedImage(np.ascontiguousarray(rgb), False, False, {},
                        "bgr24", 8)


def decode(data: bytes) -> DecodedImage:
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data[:4] == b"qoif":
        from .codecs import decode_qoi

        return decode_qoi(data)
    if data[:1] == b"P" and data[1:2] in b"1234567Ff":
        from .codecs import decode_pnm

        return decode_pnm(data)
    if data[:1] == b"\x0a" and data[1:2] in b"\x00\x02\x03\x05" \
            and data[2:3] == b"\x01":
        from .codecs import decode_pcx

        return decode_pcx(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        from .codecs2 import decode_gif

        return decode_gif(data)
    if data[:8] == b"farbfeld":
        from .codecs2 import decode_farbfeld

        return decode_farbfeld(data)
    if data[:4] == b"FORM":
        from .codecs2 import decode_iff

        return decode_iff(data)
    if data[:2] == b"\x01\xda":
        from .codecs2 import decode_sgi

        return decode_sgi(data)
    if len(data) >= 18 and data[1] in (0, 1) and data[2] in (1, 2, 3, 9, 10, 11):
        from .codecs import decode_tga

        return decode_tga(data)
    raise ValueError(
        "unsupported image format (PNG, BMP, QOI, TGA, netpbm "
        "PBM/PGM/PPM/PAM/PFM, PCX, GIF, farbfeld, IFF/ILBM and SGI "
        "are supported)")
