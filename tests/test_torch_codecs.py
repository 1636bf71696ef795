"""The port's decoders (``vszip_tpu_torch.io.codecs``, ``io.codecs2`` and the
dispatch in ``io.png``) held against the JAX package's on the same bytes:
each case of tests/test_codecs.py (its encoders and container builders are
reused), the two decoder faults the port carries on purpose (a 24-plane ILBM
with a mask tagged ``"rgb24"`` and a corrupt GIF raising ``IndexError``),
and the decoders' errors.

Tolerance: none.  Pixels are compared bit for bit (float32 by its bits),
with the dtype, shape, gray/alpha flags, colour chunks and zigimg tags;
errors by type and message.
"""

import struct

import numpy as np
import pytest

import vszip_tpu_torch as vt
from test_codecs import (_gif_bytes, _ilbm_bytes, _pcx_header, _pcx_rle, _sgi_bytes, qoi_encode,
                         tga_header)
from test_torch_core import same_error
from test_torch_imageread import assert_same_clip
from vszip_tpu.io import codecs as jc
from vszip_tpu.io import codecs2 as jc2
from vszip_tpu.io import png as jpng
from vszip_tpu.io.image_read import image_read as j_image_read
from vszip_tpu_torch.io import codecs as tc
from vszip_tpu_torch.io import codecs2 as tc2
from vszip_tpu_torch.io import png as tpng

DECODERS = {
    "qoi": (jc.decode_qoi, tc.decode_qoi), "tga": (jc.decode_tga, tc.decode_tga),
    "pnm": (jc.decode_pnm, tc.decode_pnm), "pcx": (jc.decode_pcx, tc.decode_pcx),
    "gif": (jc2.decode_gif, tc2.decode_gif), "farbfeld": (jc2.decode_farbfeld, tc2.decode_farbfeld),
    "iff": (jc2.decode_iff, tc2.decode_iff), "sgi": (jc2.decode_sgi, tc2.decode_sgi),
    "png": (jpng.decode_png, tpng.decode_png), "bmp": (jpng.decode_bmp, tpng.decode_bmp),
    "any": (jpng.decode, tpng.decode),
}


def same_image(t, j):
    assert type(t).__module__.startswith("vszip_tpu_torch.")
    assert t.pixels.dtype == j.pixels.dtype and t.pixels.shape == j.pixels.shape
    if j.pixels.dtype == np.float32:
        np.testing.assert_array_equal(t.pixels.view(np.uint32), j.pixels.view(np.uint32))
    else:
        np.testing.assert_array_equal(t.pixels, j.pixels)
    assert (t.gray, t.has_alpha, t.chunks, t.zformat, t.zbits) == (
        j.gray, j.has_alpha, j.chunks, j.zformat, j.zbits)


def decode_both(kind, data):
    """Both packages' decoder `kind` (and the dispatch) on `data`, equal;
    returns the port's image."""
    jd, td = DECODERS[kind]
    t = td(data)
    same_image(t, jd(data))
    same_image(tpng.decode(data), jpng.decode(data))
    return t


# ---------------------------------------------------------------------------
# QOI and TGA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 4])
def test_qoi_roundtrip_random(channels):
    rng = np.random.default_rng(7)
    px = rng.integers(0, 256, (23, 31, channels), dtype=np.uint8)
    px[5:12] = px[4:5]
    px[:, 3] = px[:, 2]
    px[15:18] = (px[14:17].astype(np.int16) + 1).astype(np.uint8)
    img = decode_both("qoi", qoi_encode(px, channels))
    np.testing.assert_array_equal(img.pixels, px)


def test_qoi_rejects_garbage():
    data = b"nope" + b"\x00" * 20
    assert "not a QOI" in same_error(lambda: jc.decode_qoi(data), lambda: tc.decode_qoi(data),
                                     ValueError)


def test_tga_truecolor_bottomup():
    rng = np.random.default_rng(1)
    px = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    img = decode_both("tga", tga_header(2, 13, 9, 24) + px[:, :, ::-1][::-1].tobytes())
    np.testing.assert_array_equal(img.pixels, px)


def test_tga_truecolor_32bit_topdown():
    rng = np.random.default_rng(2)
    px = rng.integers(0, 256, (6, 5, 4), dtype=np.uint8)
    img = decode_both("tga", tga_header(2, 5, 6, 32, desc=0x20) + px[:, :, [2, 1, 0, 3]].tobytes())
    np.testing.assert_array_equal(img.pixels, px)


def test_tga_gray_rle():
    rng = np.random.default_rng(3)
    g = rng.integers(0, 256, (4, 7), dtype=np.uint8)
    g[1] = 200
    body = bytearray()
    for y in range(3, -1, -1):
        body += bytes([0x80 | 6, 200]) if y == 1 else bytes([6]) + g[y].tobytes()
    img = decode_both("tga", tga_header(11, 7, 4, 8) + bytes(body))
    np.testing.assert_array_equal(img.pixels[:, :, 0], g)


def test_tga_colormapped():
    pal = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [7, 8, 9]], np.uint8)
    idx = np.array([[0, 1, 2, 3], [3, 2, 1, 0]], np.uint8)
    data = (tga_header(1, 4, 2, 8, desc=0x20, cmap=(1, 0, 4, 24)) + pal[:, ::-1].tobytes()
            + idx.tobytes())
    np.testing.assert_array_equal(decode_both("tga", data).pixels, pal[idx])


def test_tga_16bit():
    vals = [(31 << 10), (31 << 5), 31, (31 << 10) | (31 << 5) | 31]
    img = decode_both("tga", tga_header(2, 4, 1, 16, desc=0x20) + struct.pack("<4H", *vals))
    assert img.zformat == "bgr555"


def test_tga_colormapped_16bit_indices():
    rng = np.random.default_rng(6)
    cmap = rng.integers(0, 256, (300, 3), np.uint8)
    idx = rng.integers(0, 300, (4, 5)).astype("<u2")
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 1, 1, 0, 300, 24, 0, 0, 5, 4, 16, 0x20)
    img = decode_both("tga", hdr + cmap[:, ::-1].astype(np.uint8).tobytes() + idx.tobytes())
    np.testing.assert_array_equal(img.pixels, cmap[idx])


def test_dispatch_and_image_read(tmp_path):
    rng = np.random.default_rng(4)
    px = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    q = tmp_path / "img.qoi"
    q.write_bytes(qoi_encode(px, 3))
    t = tmp_path / "img.tga"
    t.write_bytes(tga_header(2, 8, 8, 24, desc=0x20) + px[:, :, ::-1].tobytes())
    for path in (q, t):
        clip = vt.image_read(str(path), device="cpu")
        assert_same_clip(clip, j_image_read(str(path)))
        for c in range(3):
            np.testing.assert_array_equal(clip.planes[c][0].numpy(), px[:, :, c])


# ---------------------------------------------------------------------------
# netpbm and PCX
# ---------------------------------------------------------------------------

def _pnm_cases():
    rng = np.random.default_rng(0)
    g = rng.integers(0, 256, (5, 7), np.uint8)
    g16 = rng.integers(0, 65536, (3, 4), np.uint16)
    c = rng.integers(0, 256, (4, 3, 3), np.uint8)
    c16 = rng.integers(0, 65536, (2, 3, 3), np.uint16)
    bits = np.array([[1, 0, 1, 0, 1], [0, 1, 0, 1, 0], [1, 1, 0, 0, 1]], np.uint8)
    ga = rng.integers(0, 256, (4, 5, 2), np.uint8)
    rgba = rng.integers(0, 65536, (2, 3, 4), np.uint16)
    f = rng.random((3, 4, 3), np.float32)
    gf = rng.random((2, 5, 1), np.float32)
    low = np.array([[0, 50, 100], [25, 75, 99]], np.uint8)
    low16 = np.array([[0, 500, 1000]], np.uint16)
    return {
        "P2": f"P2\n# cmt\n7 5\n255\n{' '.join(str(v) for v in g.ravel())}\n".encode(),
        "P5": b"P5 7 5 255\n" + g.tobytes(),
        "P5-16": b"P5 4 3 65535\n" + g16.astype(">u2").tobytes(),
        "P3": ("P3 3 4 255 " + " ".join(str(v) for v in c.ravel())).encode(),
        "P6": b"P6 3 4 255\n" + c.tobytes(),
        "P6-16": b"P6 3 2 65535\n" + c16.astype(">u2").tobytes(),
        "P1": ("P1\n5 3\n" + " ".join(str(v) for v in bits.ravel())).encode(),
        "P4": b"P4\n5 3\n" + np.packbits(bits, axis=1).tobytes(),
        "PAM-GA": (b"P7\nWIDTH 5\nHEIGHT 4\nDEPTH 2\nMAXVAL 255\nTUPLTYPE GRAYSCALE_ALPHA\n"
                   b"ENDHDR\n" + ga.tobytes()),
        "PAM-RGBA64": (b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 4\nMAXVAL 65535\nTUPLTYPE RGB_ALPHA\n"
                       b"ENDHDR\n" + rgba.astype(">u2").tobytes()),
        "PAM-BW": (b"P7\nWIDTH 4\nHEIGHT 1\nDEPTH 1\nMAXVAL 1\nTUPLTYPE BLACKANDWHITE\n"
                   b"ENDHDR\n" + bytes([0, 1, 1, 0])),
        "PF": b"PF\n4 3\n-1.0\n" + f[::-1].astype("<f4").tobytes(),
        "Pf-BE": b"Pf\n5 2\n1.0\n" + gf[::-1].astype(">f4").tobytes(),
        "P5-maxval100": b"P5 3 2 100\n" + low.tobytes(),
        "P5-maxval1000": b"P5 3 1 1000\n" + low16.astype(">u2").tobytes(),
    }


@pytest.mark.parametrize("case", list(_pnm_cases()))
def test_netpbm(case):
    decode_both("pnm", _pnm_cases()[case])


def test_pcx_rgb24():
    rng = np.random.default_rng(3)
    px = rng.integers(0, 256, (4, 6, 3), np.uint8)
    body = b"".join(_pcx_rle(px[y, :, p].tobytes()) for y in range(4) for p in range(3))
    np.testing.assert_array_equal(decode_both("pcx", _pcx_header(6, 4, 8, 3, 6) + body).pixels,
                                  px)


def test_pcx_indexed8_palette():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 256, (3, 5), np.uint8)
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    body = b"".join(_pcx_rle(idx[y].tobytes()) for y in range(3))
    img = decode_both("pcx", _pcx_header(5, 3, 8, 1, 5) + body + b"\x0c" + pal.tobytes())
    np.testing.assert_array_equal(img.pixels, pal[idx])


def test_pcx_1bit_ega_palette():
    bits = np.array([[1, 0, 1, 0, 1, 0, 0, 1], [0, 1, 1, 0, 0, 1, 1, 0]], np.uint8)
    hdr = bytearray(_pcx_header(8, 2, 1, 1, 1))
    pal = np.zeros((16, 3), np.uint8)
    pal[0], pal[1] = (10, 20, 30), (200, 100, 50)
    hdr[16:64] = pal.tobytes()
    body = b"".join(_pcx_rle(np.packbits(bits[y]).tobytes()) for y in range(2))
    img = decode_both("pcx", bytes(hdr) + body)
    assert img.zformat == "indexed1"


# ---------------------------------------------------------------------------
# GIF, farbfeld, IFF/ILBM, SGI
# ---------------------------------------------------------------------------

def test_gif_basic_palette():
    rng = np.random.default_rng(10)
    pal = rng.integers(0, 256, (8, 3), np.uint8)
    idx = rng.integers(0, 8, (6, 9), np.uint8)
    np.testing.assert_array_equal(decode_both("gif", _gif_bytes(idx, pal)).pixels, pal[idx])


def test_gif_transparency_and_interlace():
    rng = np.random.default_rng(11)
    pal = rng.integers(0, 256, (16, 3), np.uint8)
    idx = rng.integers(0, 16, (17, 5), np.uint8)
    img = decode_both("gif", _gif_bytes(idx, pal, transparent=3, interlace=True))
    np.testing.assert_array_equal(img.pixels[..., 3], np.where(idx == 3, 0, 255))


def test_gif_subrect_composites_on_canvas():
    pal = np.asarray([[10, 20, 30], [200, 100, 50]], np.uint8)
    idx = np.ones((2, 3), np.uint8)
    img = decode_both("gif", _gif_bytes(idx, pal, screen=(6, 5), offset=(2, 1)))
    assert img.pixels.shape == (5, 6, 3)


def test_farbfeld_roundtrip():
    rng = np.random.default_rng(12)
    px = rng.integers(0, 65536, (4, 7, 4), np.uint16)
    data = b"farbfeld" + struct.pack(">II", 7, 4) + px.astype(">u2").tobytes()
    np.testing.assert_array_equal(decode_both("farbfeld", data).pixels, px)


def test_ilbm_planar_palette():
    rng = np.random.default_rng(13)
    pal = rng.integers(0, 256, (32, 3), np.uint8)
    idx = rng.integers(0, 32, (4, 21), np.uint8)
    np.testing.assert_array_equal(decode_both("iff", _ilbm_bytes(idx, pal, 5)).pixels, pal[idx])


def test_ilbm_byterun1_and_ehb():
    rng = np.random.default_rng(14)
    pal = rng.integers(0, 256, (32, 3), np.uint8)
    idx = rng.integers(0, 64, (3, 16), np.uint8)
    img = decode_both("iff", _ilbm_bytes(idx, pal, 6, compress=True, camg=0x80))
    np.testing.assert_array_equal(img.pixels, np.concatenate([pal, pal // 2])[idx])


def test_ilbm_gray_ramp_without_cmap():
    rng = np.random.default_rng(18)
    idx = rng.integers(0, 16, (3, 10), np.uint8)
    img = decode_both("iff", _ilbm_bytes(idx, None, 4))
    assert img.gray and img.zformat == "grayscale4"


def test_sgi_verbatim_rgb():
    rng = np.random.default_rng(15)
    px = rng.integers(0, 256, (5, 9, 3), np.uint8)
    np.testing.assert_array_equal(decode_both("sgi", _sgi_bytes(px)).pixels, px)


def test_sgi_rle_16bit_rgba():
    rng = np.random.default_rng(16)
    px = rng.integers(0, 65536, (3, 140, 4), np.uint16)
    np.testing.assert_array_equal(decode_both("sgi", _sgi_bytes(px, bpc=2, rle=True)).pixels, px)


@pytest.mark.parametrize("nchan,bpc", [(1, 1), (2, 2)])
def test_sgi_gray(nchan, bpc):
    rng = np.random.default_rng(19)
    px = rng.integers(0, 256 if bpc == 1 else 65536, (4, 6, nchan)).astype(
        np.uint8 if bpc == 1 else np.uint16)
    img = decode_both("sgi", _sgi_bytes(px, bpc=bpc, rle=bpc == 1))
    assert img.gray


def test_new_codecs_image_read(tmp_path):
    rng = np.random.default_rng(17)
    pal = rng.integers(0, 256, (4, 3), np.uint8)
    idx = rng.integers(0, 4, (8, 8), np.uint8)
    g = tmp_path / "img.gif"
    g.write_bytes(_gif_bytes(idx, pal))
    t = vt.image_read(str(g), alpha=True, device="cpu")
    for tcl, jcl in zip(t, j_image_read(str(g), alpha=True)):
        assert_same_clip(tcl, jcl)
    assert t[1].planes[0].numpy().min() == 255
    px16 = rng.integers(0, 65536, (8, 8, 4), np.uint16)
    f = tmp_path / "img.ff"
    f.write_bytes(b"farbfeld" + struct.pack(">II", 8, 8) + px16.astype(">u2").tobytes())
    t = vt.image_read(str(f), alpha=True, device="cpu")
    for tcl, jcl in zip(t, j_image_read(str(f), alpha=True)):
        assert_same_clip(tcl, jcl)
    assert t[0].format.name == "RGB48"


# ---------------------------------------------------------------------------
# the two carried faults, and the decoders' errors
# ---------------------------------------------------------------------------

def _ilbm24_masked(px, mask):
    """A 24-plane ILBM with a mask plane (mskHasMask)."""
    h, w, _ = px.shape
    rowbytes = ((w + 15) // 16) * 2
    v = px[..., 0].astype(np.int64) | (px[..., 1].astype(np.int64) << 8) | (
        px[..., 2].astype(np.int64) << 16)
    bmhd = struct.pack(">HHhhBBBBHBBhh", w, h, 0, 0, 24, 1, 0, 0, 0, 1, 1, w, h)
    body = bytearray()
    for y in range(h):
        for plane in [(v[y] >> p) & 1 for p in range(24)] + [mask[y]]:
            body += np.packbits(np.pad(plane.astype(np.uint8), (0, rowbytes * 8 - w))).tobytes()
    chunks = b"BMHD" + struct.pack(">I", len(bmhd)) + bmhd
    chunks += b"BODY" + struct.pack(">I", len(body)) + bytes(body)
    return b"FORM" + struct.pack(">I", len(chunks) + 4) + b"ILBM" + chunks


def test_carried_fault_ilbm24_masked_is_tagged_rgb24(tmp_path):
    rng = np.random.default_rng(20)
    px = rng.integers(0, 256, (3, 11, 3), np.uint8)
    mask = rng.integers(0, 2, (3, 11))
    img = decode_both("iff", _ilbm24_masked(px, mask))
    assert img.zformat == "rgb24" and img.pixels.shape == (3, 11, 4) and img.has_alpha
    np.testing.assert_array_equal(img.pixels[..., 3], mask * 255)
    p = tmp_path / "deep.iff"
    p.write_bytes(_ilbm24_masked(px, mask))
    t = vt.image_read(str(p), alpha=True, device="cpu")
    for tcl, jcl in zip(t, j_image_read(str(p), alpha=True)):
        assert_same_clip(tcl, jcl)


def _corrupt_gif():
    """A GIF whose first code after CLEAR (4, with 2-bit indices) is 7,
    past the 6-entry table."""
    out = bytearray(b"GIF89a") + struct.pack("<HHBBB", 2, 1, 0x81, 0, 0)
    out += bytes(12) + struct.pack("<BHHHHB", 0x2C, 0, 0, 2, 1, 0) + bytes([2])
    acc = nbits = 0
    lzw = bytearray()
    for code in (4, 7, 5):
        acc |= code << nbits
        nbits += 3
    while nbits > 0:
        lzw.append(acc & 0xFF)
        acc >>= 8
        nbits -= 8
    return bytes(out + bytes([len(lzw)]) + lzw + bytes([0, 0x3B]))


def test_carried_fault_corrupt_gif_raises_index_error(tmp_path):
    data = _corrupt_gif()
    same_error(lambda: jc2.decode_gif(data), lambda: tc2.decode_gif(data), IndexError)
    p = tmp_path / "bad.gif"
    p.write_bytes(data)
    msg = same_error(lambda: j_image_read(str(p)), lambda: vt.image_read(str(p), device="cpu"),
                     ValueError)
    assert "Failed to read" in msg


@pytest.mark.parametrize("kind,data", [
    ("qoi", b"qoif" + struct.pack(">II", 2, 2) + bytes([5, 0])),
    ("qoi", b"qoif" + struct.pack(">II", 0, 2) + bytes([3, 0])),
    ("tga", b"\x00" * 10),
    ("tga", tga_header(4, 2, 2, 24)),
    ("tga", tga_header(2, 0, 2, 24)),
    ("tga", tga_header(1, 2, 1, 8, desc=0x20) + bytes(2)),
    ("tga", tga_header(2, 1, 1, 12, desc=0x20) + bytes(2)),
    ("pnm", b"P9 1 1 255\n\x00"),
    ("pnm", b"P5 7"),
    ("pnm", b"P7\nWIDTH 1\n"),
    ("pcx", b"\x0a" * 10),
    ("pcx", _pcx_header(2, 2, 8, 1, 2)[:2] + b"\x00" + _pcx_header(2, 2, 8, 1, 2)[3:]),
    ("pcx", _pcx_header(2, 2, 4, 1, 2) + bytes(8)),
    ("gif", b"GIF90a" + bytes(20)),
    ("gif", b"GIF89a" + struct.pack("<HHBBB", 1, 1, 0, 0, 0) + b"\x3b"),
    ("gif", b"GIF89a" + struct.pack("<HHBBB", 1, 1, 0, 0, 0) + b"\x99"),
    ("gif", b"GIF89a" + struct.pack("<HHBBB", 1, 1, 0, 0, 0)
     + struct.pack("<BHHHHB", 0x2C, 0, 0, 1, 1, 0) + b"\x02\x00\x3b"),
    ("farbfeld", b"farbfelt" + bytes(8)),
    ("iff", b"FORX" + bytes(8)),
    ("iff", b"FORM" + bytes(4) + b"ACBM"),
    ("iff", b"FORM" + bytes(4) + b"ILBM"),
    ("sgi", b"\x01\xdb" + bytes(10)),
    ("sgi", b"\x01\xda\x00\x03" + bytes(8)),
    ("sgi", b"\x01\xda\x02\x01" + struct.pack(">HHHH", 2, 1, 1, 1) + bytes(500)),
    ("png", b"\x89PNG\r\n\x1a\x00"),
    ("png", b"\x89PNG\r\n\x1a\n"),
    ("bmp", b"BM" + bytes(28) + struct.pack("<I", 1)),
    ("any", b"XXXXXXXXXXXXXXXXXXXXXXXX"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_decoder_errors_match(kind, data):
    jd, td = DECODERS[kind]
    same_error(lambda: jd(data), lambda: td(data))
