"""QOI, TGA, netpbm and PCX decoders for ImageRead (a copy of the JAX
package's ``io/codecs.py``).

The reference decodes any zigimg-supported container via ``Image.fromMemory``
(reference src/vapoursynth/image_read.zig:222-224); this repo implements the
formats with real-world use — PNG/BMP (io/png.py) plus QOI and TGA here —
as pure host-side decoders (image decode happens once at clip-build time, on
the host; only the decoded planes go to the card).

QOI: the complete spec (qoiformat.org) — RGB/RGBA ops, index table,
diff/luma deltas, runs.  TGA: types 1/2/3 and their RLE variants 9/10/11,
8-bit grayscale, 16-bit (A1R5G5B5), 24/32-bit truecolor, color-mapped with
16/24/32-bit palettes, bottom-up and top-down orientation.
"""

from __future__ import annotations

import struct

import numpy as np

from .png import DecodedImage


def decode_qoi(data: bytes) -> DecodedImage:
    if data[:4] != b"qoif":
        raise ValueError("not a QOI file")
    w, h = struct.unpack(">II", data[4:12])
    channels, _colorspace = data[12], data[13]
    if channels not in (3, 4):
        raise ValueError(f"unsupported QOI channel count {channels}")
    if w == 0 or h == 0:
        raise ValueError("empty QOI image")

    npx = w * h
    out = np.empty((npx, 4), np.uint8)
    index = np.zeros((64, 4), np.uint8)
    r, g, b, a = 0, 0, 0, 255
    pos, i = 14, 0
    buf = data
    while i < npx:
        op = buf[pos]
        pos += 1
        if op == 0xFE:  # QOI_OP_RGB
            r, g, b = buf[pos], buf[pos + 1], buf[pos + 2]
            pos += 3
        elif op == 0xFF:  # QOI_OP_RGBA
            r, g, b, a = buf[pos], buf[pos + 1], buf[pos + 2], buf[pos + 3]
            pos += 4
        else:
            tag = op >> 6
            if tag == 0:  # QOI_OP_INDEX
                e = index[op & 0x3F]
                r, g, b, a = int(e[0]), int(e[1]), int(e[2]), int(e[3])
                out[i] = (r, g, b, a)
                i += 1
                continue
            if tag == 1:  # QOI_OP_DIFF
                r = (r + ((op >> 4) & 3) - 2) & 0xFF
                g = (g + ((op >> 2) & 3) - 2) & 0xFF
                b = (b + (op & 3) - 2) & 0xFF
            elif tag == 2:  # QOI_OP_LUMA
                dg = (op & 0x3F) - 32
                drdb = buf[pos]
                pos += 1
                r = (r + dg - 8 + ((drdb >> 4) & 0xF)) & 0xFF
                g = (g + dg) & 0xFF
                b = (b + dg - 8 + (drdb & 0xF)) & 0xFF
            else:  # QOI_OP_RUN
                run = (op & 0x3F) + 1
                out[i : i + run] = (r, g, b, a)
                i += run
                index[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)
                continue
        out[i] = (r, g, b, a)
        i += 1
        index[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)

    px = out.reshape(h, w, 4)
    if channels == 3:
        px = px[:, :, :3]
    return DecodedImage(np.ascontiguousarray(px), False, channels == 4, {})


def _tga_unrle(data: bytes, pos: int, npx: int, bpp: int) -> np.ndarray:
    """TGA RLE: packets of (header byte, pixel(s)); high bit = run."""
    out = np.empty(npx * bpp, np.uint8)
    i = 0
    while i < npx * bpp:
        hdr = data[pos]
        pos += 1
        count = (hdr & 0x7F) + 1
        if hdr & 0x80:  # run packet: one pixel repeated
            px = np.frombuffer(data, np.uint8, bpp, pos)
            pos += bpp
            out[i : i + count * bpp] = np.tile(px, count)
        else:  # raw packet
            n = count * bpp
            out[i : i + n] = np.frombuffer(data, np.uint8, n, pos)
            pos += n
        i += count * bpp
    return out


def _tga_to_rgba(arr: np.ndarray, bpp_bits: int) -> tuple[np.ndarray, bool]:
    """(H*W, bytes) raw TGA pixels -> ((H*W, C) RGB(A) u8, has_alpha)."""
    if bpp_bits == 8:
        return arr.reshape(-1, 1), False
    if bpp_bits == 16:  # A1R5G5B5 little-endian
        v = arr.reshape(-1, 2).astype(np.uint16)
        v = v[:, 0] | (v[:, 1] << 8)
        r = ((v >> 10) & 31).astype(np.uint8)
        g = ((v >> 5) & 31).astype(np.uint8)
        b = (v & 31).astype(np.uint8)
        scale = lambda c: ((c.astype(np.uint16) * 255 + 15) // 31).astype(np.uint8)  # noqa: E731
        return np.stack([scale(r), scale(g), scale(b)], -1), False
    if bpp_bits == 24:  # BGR
        px = arr.reshape(-1, 3)[:, ::-1]
        return px, False
    if bpp_bits == 32:  # BGRA
        px = arr.reshape(-1, 4)
        return np.concatenate([px[:, 2::-1], px[:, 3:4]], -1), True
    raise ValueError(f"unsupported TGA depth {bpp_bits}")


def decode_tga(data: bytes) -> DecodedImage:
    if len(data) < 18:
        raise ValueError("not a TGA file")
    (idlen, cmap_type, img_type, cmap_origin, cmap_len, cmap_depth,
     _xo, _yo, w, h, bpp, desc) = struct.unpack("<BBBHHBHHHHBB", data[:18])
    if img_type not in (1, 2, 3, 9, 10, 11):
        raise ValueError(f"unsupported TGA image type {img_type}")
    if w == 0 or h == 0:
        raise ValueError("empty TGA image")
    pos = 18 + idlen
    cmap = None
    if cmap_type == 1:
        cbytes = (cmap_depth + 7) // 8
        raw = np.frombuffer(data, np.uint8, cmap_len * cbytes, pos)
        cmap, cmap_alpha = _tga_to_rgba(raw, cmap_depth)
        pos += cmap_len * cbytes

    npx = w * h
    pbytes = (bpp + 7) // 8
    if img_type >= 9:  # RLE
        raw = _tga_unrle(data, pos, npx, pbytes)
    else:
        raw = np.frombuffer(data, np.uint8, npx * pbytes, pos).copy()

    if img_type in (1, 9):  # color-mapped (8- or 16-bit indices)
        if cmap is None:
            raise ValueError("color-mapped TGA without a color map")
        if bpp == 16:
            idx = raw.view("<u2").astype(np.int64) - cmap_origin
        else:
            idx = raw.astype(np.int64) - cmap_origin
        px = cmap[idx]
        has_alpha = cmap_alpha
        gray = False
    else:
        px, has_alpha = _tga_to_rgba(raw, bpp)
        gray = img_type in (3, 11)

    px = px.reshape(h, w, -1)
    if not desc & 0x20:  # bit 5 clear: bottom-up origin
        px = px[::-1]
    if gray:
        px = px[:, :, :1]
    # zigimg tags: TGA truecolor decodes as bgr24/bgra32; indexed via
    # indexed8; 16-bit sources are A1R5G5B5 (zigimg's bgr555, which the
    # reference REJECTS at create — we widen and accept as a superset but
    # keep the honest source tag/bits)
    if img_type in (1, 9):
        ztag, zb = ("indexed16", 16) if bpp == 16 else ("indexed8", 8)
    elif gray:
        ztag, zb = "grayscale8", 8
    elif bpp in (15, 16):
        ztag, zb = "bgr555", 5
    else:
        ztag, zb = ("bgra32", 8) if has_alpha else ("bgr24", 8)
    return DecodedImage(np.ascontiguousarray(px), gray, has_alpha, {},
                        ztag, zb)


# ---------------------------------------------------------------------------
# netpbm family: PBM (P1/P4), PGM (P2/P5), PPM (P3/P6), PAM (P7), and the
# float PFM (PF color / Pf gray).  The reference accepts these through
# zigimg's pbm/pgm/ppm/pam decoders (src/vapoursynth/image_read.zig:440
# lists the resulting grayscale*/rgb*/float32 pixel formats); PFM is the
# float32 source path (f32 planes -> GRAYS/RGBS output).
# ---------------------------------------------------------------------------


def _pnm_tokens(data: bytes, pos: int, count: int):
    """Read `count` whitespace-separated tokens skipping '#' comments."""
    toks = []
    n = len(data)
    while len(toks) < count:
        while pos < n and data[pos : pos + 1].isspace():
            pos += 1
        if pos < n and data[pos : pos + 1] == b"#":
            while pos < n and data[pos] not in (10, 13):
                pos += 1
            continue
        start = pos
        while pos < n and not data[pos : pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("truncated netpbm header")
        toks.append(data[start:pos])
    return toks, pos


def _rescale_maxval(px: np.ndarray, maxval: int, wide: bool) -> np.ndarray:
    """Widen samples stored against a non-full-scale MAXVAL (e.g. P5 maxval
    100, PAM MAXVAL 1) to the full 8/16-bit range: v * peak / maxval with
    round-half-up integer arithmetic (ffmpeg pnm semantics)."""
    peak = 65535 if wide else 255
    if maxval == peak:
        return px
    return (px * peak + maxval // 2) // maxval


def decode_pnm(data: bytes) -> DecodedImage:
    magic = data[:2]
    if magic in (b"PF", b"Pf"):
        # PFM: header "PF|Pf <w> <h> <scale>", one whitespace, then
        # little-endian (scale < 0) or big-endian f32 rows, BOTTOM-UP
        toks, pos = _pnm_tokens(data, 2, 3)
        w, h = int(toks[0]), int(toks[1])
        scale = float(toks[2])
        pos += 1  # single whitespace after the scale token
        nchan = 3 if magic == b"PF" else 1
        dt = "<f4" if scale < 0 else ">f4"
        px = np.frombuffer(data, dt, w * h * nchan, pos).astype(np.float32)
        px = px.reshape(h, w, nchan)[::-1]
        return DecodedImage(np.ascontiguousarray(px), nchan == 1, False, {},
                            "float32", 32)
    if magic == b"P7":
        # PAM: free-form header lines up to ENDHDR
        hdr_end = data.find(b"ENDHDR\n")
        if hdr_end < 0:
            raise ValueError("PAM without ENDHDR")
        fields = {}
        for line in data[2:hdr_end].decode("ascii", "replace").splitlines():
            line = line.split("#")[0].strip()
            if line:
                k, _, v = line.partition(" ")
                fields[k.upper()] = v.strip()
        w, h = int(fields["WIDTH"]), int(fields["HEIGHT"])
        depth = int(fields["DEPTH"])
        maxval = int(fields["MAXVAL"])
        tupl = fields.get("TUPLTYPE", "")
        pos = hdr_end + 7
        wide = maxval > 255
        dt = ">u2" if wide else np.uint8
        px = np.frombuffer(data, dt, w * h * depth, pos)
        px = _rescale_maxval(px.astype(np.int64), maxval, wide)
        px = px.astype(np.uint16 if wide else np.uint8).reshape(h, w, depth)
        gray = depth <= 2 and "RGB" not in tupl
        has_alpha = depth in (2, 4) or tupl.endswith("_ALPHA")
        b = 16 if wide else 8
        ztag = (f"grayscale{b}" + ("Alpha" if has_alpha else "")) if gray \
            else (("rgba64" if b == 16 else "rgba32") if has_alpha
                  else ("rgb48" if b == 16 else "rgb24"))
        return DecodedImage(np.ascontiguousarray(px), gray, has_alpha, {},
                            ztag, b)
    if magic not in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
        raise ValueError("not a netpbm file")
    kind = magic[1] - 48
    nchan = 3 if kind in (3, 6) else 1
    is_bitmap = kind in (1, 4)
    nhdr = 2 if is_bitmap else 3
    toks, pos = _pnm_tokens(data, 2, nhdr)
    w, h = int(toks[0]), int(toks[1])
    maxval = 1 if is_bitmap else int(toks[2])
    if kind <= 3 and not is_bitmap:
        vals, pos = _pnm_tokens(data, pos, w * h * nchan)
        px = np.asarray([int(v) for v in vals], np.int64)
    elif kind == 1:  # ascii bitmap: digits may be unseparated
        digits = [c - 48 for c in data[pos:] if c in (48, 49)]
        px = np.asarray(digits[: w * h], np.int64)
    elif kind == 4:  # packed bitmap, rows padded to bytes
        pos += 1
        stride = (w + 7) // 8
        rows = np.frombuffer(data, np.uint8, stride * h, pos)
        bits = np.unpackbits(rows.reshape(h, stride), axis=1)[:, :w]
        px = bits.astype(np.int64).reshape(-1)
    else:  # P5/P6 binary
        pos += 1
        wide = maxval > 255
        dt = ">u2" if wide else np.uint8
        px = np.frombuffer(data, dt, w * h * nchan, pos).astype(np.int64)
    if is_bitmap:
        # PBM: 1 = black -> 0, 0 = white -> 255 (zigimg grayscale1 widened)
        px = np.where(px > 0, 0, 255).astype(np.uint8)
        out = px.reshape(h, w, 1)
        return DecodedImage(np.ascontiguousarray(out), True, False, {},
                            "grayscale1", 1)
    wide = maxval > 255
    dtype = np.uint16 if wide else np.uint8
    out = _rescale_maxval(px, maxval, wide).astype(dtype).reshape(h, w, nchan)
    b = 16 if wide else 8
    ztag = f"grayscale{b}" if nchan == 1 else ("rgb48" if wide else "rgb24")
    return DecodedImage(np.ascontiguousarray(out), nchan == 1, False, {},
                        ztag, b)


# ---------------------------------------------------------------------------
# PCX (ZSoft Paintbrush): RLE-compressed planar rows; 1-bit, 8-bit paletted
# (VGA palette trailer), and 24-bit (3-plane) images — the layouts zigimg's
# pcx decoder produces as indexed1/indexed8/rgb24.
# ---------------------------------------------------------------------------


def decode_pcx(data: bytes) -> DecodedImage:
    if len(data) < 128 or data[0] != 0x0A:
        raise ValueError("not a PCX file")
    version, enc, bpp = data[1], data[2], data[3]
    x0, y0, x1, y1 = struct.unpack("<4H", data[4:12])
    nplanes = data[65]
    stride = struct.unpack("<H", data[66:68])[0]
    w, h = x1 - x0 + 1, y1 - y0 + 1
    if enc != 1:
        raise ValueError("uncompressed PCX not supported")
    total = stride * nplanes * h
    out = np.empty(total, np.uint8)
    pos, o = 128, 0
    while o < total and pos < len(data):
        b = data[pos]; pos += 1
        if (b & 0xC0) == 0xC0:
            run = b & 0x3F
            v = data[pos]; pos += 1
            out[o : o + run] = v
            o += run
        else:
            out[o] = b
            o += 1
    rows = out.reshape(h, nplanes, stride)
    if bpp == 8 and nplanes == 3:
        px = np.ascontiguousarray(rows[:, :, :w].transpose(0, 2, 1))
        return DecodedImage(px, False, False, {}, "rgb24", 8)
    if bpp == 8 and nplanes == 1:
        idx = rows[:, 0, :w]
        # VGA palette trailer: 0x0C marker + 768 bytes
        if len(data) >= 769 and data[-769] == 0x0C:
            pal = np.frombuffer(data, np.uint8, 768, len(data) - 768)
            pal = pal.reshape(256, 3)
        else:
            pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        px = pal[idx]
        # indexed source => alpha clip semantics like PNG palette images
        return DecodedImage(np.ascontiguousarray(px), False, True, {},
                            "indexed8", 8)
    if bpp == 1 and nplanes == 1:
        bits = np.unpackbits(rows[:, 0, :], axis=1)[:, :w]
        # zigimg decodes 1-bit PCX as indexed1 through the 16-color EGA
        # header palette (bytes 16..64, 16 x RGB triples); the reference
        # then emits an RGB clip + alpha clip like every indexed source
        # (image_read.zig copyPixelsIndexed path), so map bits through
        # palette entries 0/1 rather than widening to gray.
        pal = np.frombuffer(data, np.uint8, 48, 16).reshape(16, 3)
        px = pal[bits.astype(np.int64)]
        return DecodedImage(np.ascontiguousarray(px), False, True, {},
                            "indexed1", 1)
    raise ValueError(f"unsupported PCX layout (bpp={bpp}, planes={nplanes})")
