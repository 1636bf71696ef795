"""GIF, farbfeld, IFF/ILBM, and SGI decoders for ImageRead (a copy of the
JAX package's ``io/codecs2.py``).

Completes the zigimg container matrix (the reference accepts anything
``zigimg.Image.fromMemory`` decodes, src/vapoursynth/image_read.zig:222-224):
with these, every zigimg container family with a finished upstream decoder
— PNG, BMP, QOI, TGA, netpbm (PBM/PGM/PPM/PAM/PFM), PCX, GIF, farbfeld,
IFF/ILBM, SGI — has a pure host-side decoder here (decode happens once at
clip-build time, on the host).  zigimg's JPEG support is
upstream-experimental and not part of the reference's accepted matrix.

Two faults of the JAX package's decoders are carried as they are, so that
both packages give the same answer:

* a 24-plane ILBM with a mask (mskHasMask) is tagged ``"rgb24"`` though its
  pixels are RGBA (``decode_iff``);
* a corrupt GIF whose first code after a CLEAR is past the table raises
  ``IndexError``, not ``ValueError`` (``_gif_lzw``; ImageRead wraps either
  in its "Failed to read" error).

GIF: 87a/89a, global+local palettes, interlacing, LZW, transparency via
the graphic-control extension; like zigimg's first animation frame, the
first image is composited onto the logical-screen canvas (background
index fill) and returned as an indexed source (RGB(A) through the
palette + alpha-clip semantics, same as PNG palette images).

farbfeld: 8-byte magic + BE u32 dims + BE u16 RGBA — maps to rgba64.

IFF/ILBM: FORM ILBM/PBM with BMHD/CMAP/CAMG/BODY, ByteRun1 decompression,
planar->chunky conversion, EHB (extra-half-brite) and 24-bit deep ILBMs,
masked (mskHasMask) alpha.

SGI: .sgi/.rgb 512-byte header, 1- or 2-byte channels, RLE or verbatim,
1-3 dimensions; bottom-up storage.
"""

from __future__ import annotations

import struct

import numpy as np

from .png import DecodedImage


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def _gif_lzw(data: bytes, min_code: int, npx: int) -> np.ndarray:
    """Decode GIF LZW-compressed index stream (variable 3..12-bit codes)."""
    clear = 1 << min_code
    end = clear + 1
    # dictionary: list of byte strings
    base = [bytes((i,)) for i in range(clear)] + [b"", b""]
    table = list(base)
    code_size = min_code + 1
    out = bytearray()
    acc = 0
    nbits = 0
    prev: bytes | None = None
    for byte in data:
        acc |= byte << nbits
        nbits += 8
        while nbits >= code_size:
            code = acc & ((1 << code_size) - 1)
            acc >>= code_size
            nbits -= code_size
            if code == clear:
                table = list(base)
                code_size = min_code + 1
                prev = None
                continue
            if code == end:
                return np.frombuffer(bytes(out[:npx]), np.uint8).copy()
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError("corrupt GIF LZW stream")
            out += entry
            prev = entry
            if len(table) == (1 << code_size) and code_size < 12:
                code_size += 1
            if len(out) >= npx:
                return np.frombuffer(bytes(out[:npx]), np.uint8).copy()
    return np.frombuffer(bytes(out[:npx].ljust(npx, b"\0")), np.uint8).copy()


def decode_gif(data: bytes) -> DecodedImage:
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    sw, sh, flags, bgindex, _aspect = struct.unpack("<HHBBB", data[6:13])
    pos = 13
    gct = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gct = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
        pos += n * 3
    transparent = -1
    while pos < len(data):
        b = data[pos]
        pos += 1
        if b == 0x21:  # extension
            label = data[pos]
            pos += 1
            if label == 0xF9:  # graphic control
                size = data[pos]
                gce = data[pos + 1 : pos + 1 + size]
                if gce[0] & 1:
                    transparent = gce[3]
                pos += 1 + size
            # skip remaining sub-blocks
            while pos < len(data) and data[pos] != 0:
                pos += 1 + data[pos]
            pos += 1
        elif b == 0x2C:  # image descriptor — first frame; decode and return
            left, top, w, h, iflags = struct.unpack("<HHHHB", data[pos : pos + 9])
            pos += 9
            pal = gct
            if iflags & 0x80:  # local color table
                n = 2 << (iflags & 7)
                pal = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
                pos += n * 3
            if pal is None:
                raise ValueError("GIF image without a color table")
            min_code = data[pos]
            pos += 1
            chunks = []
            while pos < len(data) and data[pos] != 0:
                n = data[pos]
                chunks.append(data[pos + 1 : pos + 1 + n])
                pos += 1 + n
            idx = _gif_lzw(b"".join(chunks), min_code, w * h).reshape(h, w)
            if iflags & 0x40:  # interlaced
                rows = np.empty(h, np.int64)
                order = [y for y0, dy in ((0, 8), (4, 8), (2, 4), (1, 2))
                         for y in range(y0, h, dy)]
                rows[np.asarray(order, np.int64)] = np.arange(h)
                idx = idx[rows]
            # composite onto the logical-screen canvas (background fill)
            if (left, top, w, h) != (0, 0, sw, sh):
                canvas = np.full((sh, sw), bgindex, np.uint8)
                canvas[top : top + h, left : left + w] = idx
                idx = canvas
            rgb = pal[np.minimum(idx, len(pal) - 1)]
            if transparent >= 0:
                a = np.where(idx == transparent, 0, 255).astype(np.uint8)
                px = np.concatenate([rgb, a[..., None]], axis=-1)
            else:
                px = rgb
            return DecodedImage(np.ascontiguousarray(px), False, True, {},
                                "indexed8", 8)
        elif b == 0x3B:
            break
        elif b == 0:
            continue
        else:
            raise ValueError(f"unknown GIF block 0x{b:02x}")
    raise ValueError("GIF without an image block")


# ---------------------------------------------------------------------------
# farbfeld
# ---------------------------------------------------------------------------


def decode_farbfeld(data: bytes) -> DecodedImage:
    if data[:8] != b"farbfeld":
        raise ValueError("not a farbfeld file")
    w, h = struct.unpack(">II", data[8:16])
    px = np.frombuffer(data, ">u2", w * h * 4, 16).astype(np.uint16)
    px = px.reshape(h, w, 4)
    return DecodedImage(np.ascontiguousarray(px), False, True, {},
                        "rgba64", 16)


# ---------------------------------------------------------------------------
# IFF / ILBM
# ---------------------------------------------------------------------------


def _byterun1(data: bytes, expect: int) -> bytes:
    """ByteRun1 (PackBits) decompression."""
    out = bytearray()
    pos = 0
    n = len(data)
    while len(out) < expect and pos < n:
        c = data[pos]
        pos += 1
        if c < 128:
            out += data[pos : pos + c + 1]
            pos += c + 1
        elif c > 128:
            out += bytes((data[pos],)) * (257 - c)
            pos += 1
        # 128: no-op
    return bytes(out[:expect])


def decode_iff(data: bytes) -> DecodedImage:
    if data[:4] != b"FORM":
        raise ValueError("not an IFF file")
    form_type = data[8:12]
    if form_type not in (b"ILBM", b"PBM "):
        raise ValueError(f"unsupported IFF form {form_type!r}")
    chunky = form_type == b"PBM "
    pos = 12
    w = h = nplanes = masking = compression = 0
    cmap = None
    camg = 0
    body = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        clen = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        payload = data[pos + 8 : pos + 8 + clen]
        pos += 8 + clen + (clen & 1)  # chunks are word-aligned
        if cid == b"BMHD":
            (w, h, _x, _y, nplanes, masking, compression, _pad, _transp,
             _xa, _ya, _pw, _ph) = struct.unpack(">HHhhBBBBHBBhh", payload[:20])
        elif cid == b"CMAP":
            cmap = np.frombuffer(payload, np.uint8,
                                 len(payload) // 3 * 3).reshape(-1, 3).copy()
        elif cid == b"CAMG":
            camg = struct.unpack(">I", payload[:4])[0]
        elif cid == b"BODY":
            body = payload
            break
    if body is None or w == 0 or h == 0:
        raise ValueError("IFF without BMHD/BODY")

    has_mask = masking == 1  # mskHasMask: an extra interleaved bitplane
    rowbytes = ((w + 15) // 16) * 2
    total_planes = nplanes + (1 if has_mask else 0)
    if chunky:
        expect = ((w + 1) & ~1) * h if nplanes == 8 else rowbytes * h
        raw = _byterun1(body, expect) if compression == 1 else body[:expect]
        stride = (w + 1) & ~1 if nplanes == 8 else rowbytes
        rows = np.frombuffer(raw, np.uint8, stride * h).reshape(h, stride)
        idx = rows[:, :w].astype(np.int64)
        mask = None
    else:
        expect = rowbytes * total_planes * h
        raw = _byterun1(body, expect) if compression == 1 else body[:expect]
        rows = np.frombuffer(raw, np.uint8,
                             rowbytes * total_planes * h).reshape(
                                 h, total_planes, rowbytes)
        bits = np.unpackbits(rows, axis=2)[:, :, :w]  # (h, planes, w)
        weights = (1 << np.arange(nplanes, dtype=np.int64))
        idx = (bits[:, :nplanes].astype(np.int64)
               * weights[None, :, None]).sum(axis=1)
        mask = bits[:, nplanes] if has_mask else None

    if nplanes == 24:
        r = (idx & 0xFF).astype(np.uint8)
        g = ((idx >> 8) & 0xFF).astype(np.uint8)
        b = ((idx >> 16) & 0xFF).astype(np.uint8)
        px = np.stack([r, g, b], axis=-1)
        if mask is not None:
            a = (mask * 255).astype(np.uint8)
            px = np.concatenate([px, a[..., None]], axis=-1)
        return DecodedImage(np.ascontiguousarray(px), False, mask is not None,
                            {}, "rgb24", 8)
    if cmap is None:
        # grayscale ramp fallback
        peak = (1 << nplanes) - 1
        gr = ((idx * 255 + peak // 2) // max(peak, 1)).astype(np.uint8)
        return DecodedImage(np.ascontiguousarray(gr[..., None]), True, False,
                            {}, f"grayscale{nplanes}", nplanes)
    pal = cmap
    if camg & 0x80 and nplanes == 6:  # EHB: 32 + half-brite copies
        pal = np.concatenate([cmap[:32], cmap[:32] // 2])
    px = pal[np.minimum(idx, len(pal) - 1)]
    if mask is not None:
        a = (mask * 255).astype(np.uint8)
        px = np.concatenate([px, a[..., None]], axis=-1)
    tag = "indexed8" if nplanes > 4 else f"indexed{nplanes}"
    return DecodedImage(np.ascontiguousarray(px), False, True, {},
                        tag, nplanes)


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------


def decode_sgi(data: bytes) -> DecodedImage:
    if data[:2] != b"\x01\xda":
        raise ValueError("not an SGI file")
    storage, bpc = data[2], data[3]
    _dim, w, h, nchan = struct.unpack(">HHHH", data[4:12])
    if bpc not in (1, 2):
        raise ValueError(f"unsupported SGI bytes-per-channel {bpc}")
    npx = w * h
    if storage == 0:  # verbatim, bottom-up, channel-planar
        count = npx * nchan
        dt = ">u2" if bpc == 2 else np.uint8
        px = np.frombuffer(data, dt, count, 512).astype(
            np.uint16 if bpc == 2 else np.uint8)
        px = px.reshape(nchan, h, w).transpose(1, 2, 0)[::-1]
    elif storage == 1:  # RLE: per-row-per-channel offset/length tables
        tablen = h * nchan
        starts = np.frombuffer(data, ">u4", tablen, 512)
        out = np.empty((nchan, h, w), np.uint16 if bpc == 2 else np.uint8)
        for c in range(nchan):
            for y in range(h):
                o = int(starts[c * h + y])
                row = out[c, y]
                x = 0
                while x < w:
                    if bpc == 1:
                        cnt = data[o] & 0x7F
                        rle = not (data[o] & 0x80)
                        o += 1
                        if cnt == 0:
                            break
                        if rle:
                            row[x : x + cnt] = data[o]
                            o += 1
                        else:
                            row[x : x + cnt] = np.frombuffer(
                                data, np.uint8, cnt, o)
                            o += cnt
                    else:
                        v = struct.unpack(">H", data[o : o + 2])[0]
                        o += 2
                        cnt = v & 0x7F
                        rle = not (v & 0x80)
                        if cnt == 0:
                            break
                        if rle:
                            row[x : x + cnt] = struct.unpack(
                                ">H", data[o : o + 2])[0]
                            o += 2
                        else:
                            row[x : x + cnt] = np.frombuffer(
                                data, ">u2", cnt, o)
                            o += cnt * 2
                    x += cnt
        px = out.transpose(1, 2, 0)[::-1]
    else:
        raise ValueError(f"unsupported SGI storage {storage}")
    gray = nchan <= 2
    has_alpha = nchan in (2, 4)
    if gray and px.shape[-1] > 1 and not has_alpha:
        px = px[:, :, :1]
    b = 16 if bpc == 2 else 8
    if gray:
        tag = f"grayscale{b}" + ("Alpha" if has_alpha else "")
    else:
        tag = (("rgba64" if b == 16 else "rgba32") if has_alpha
               else ("rgb48" if b == 16 else "rgb24"))
    return DecodedImage(np.ascontiguousarray(px), gray, has_alpha, {}, tag, b)
