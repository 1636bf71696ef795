"""The port's ImageRead (``vszip_tpu_torch.image_read``, ``io/png.py`` and the
native unfilter) held against the JAX package's on the same bytes: each case
of tests/test_imageread.py but the photo one, read with ``device="cpu"``,
plus the native ``png_unfilter`` against the plain ``_unfilter_py``.

Tolerance: none.  Planes are compared bit for bit (PFM's float32 too),
formats by name, props for equality, and error types and messages exactly.
"""

import io as _io
import os

import numpy as np
import pytest
import torch

import vszip_tpu_torch as vt
from helpers import encode_bmp, encode_png
from test_torch_core import same_error
from vszip_tpu.io import png as jpng
from vszip_tpu.io.image_read import image_read as j_image_read
from vszip_tpu_torch import _build
from vszip_tpu_torch.io import png as tpng
from vszip_tpu_torch.runtime import png_native


def _rand_img(shape, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    hi = 65536 if dtype == np.uint16 else 256
    return rng.integers(0, hi, shape).astype(dtype)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_same_clip(t, j):
    """A port clip (CPU tensors) equal to a JAX clip: format, planes bit for
    bit, props."""
    assert t.format.name == j.format.name
    assert len(t.planes) == len(j.planes)
    for a, b in zip(t.planes, j.planes):
        assert a.device == torch.device("cpu")
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert t.props == j.props


def read_both(path, **kw):
    """image_read of `path` by both packages; each result a clip or a
    (clip, alpha) pair, compared here."""
    j = j_image_read(path, **kw)
    t = vt.image_read(path, device="cpu", **kw)
    if kw.get("alpha"):
        for tc, jc in zip(t, j):
            assert_same_clip(tc, jc)
    else:
        assert_same_clip(t, j)
    return t


def _planes_hwc(clip):
    return np.stack([p[0].numpy() for p in clip.planes], axis=-1)


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
def test_png_roundtrip_filters(tmp_path, ft):
    img = _rand_img((23, 31, 3))
    p = tmp_path / f"f{ft}.png"
    p.write_bytes(encode_png(img, filter_type=ft))
    clip = read_both(str(p))
    assert clip.format.name == "RGB24"
    np.testing.assert_array_equal(_planes_hwc(clip), img)


def test_png_16bit_and_gray(tmp_path):
    img = _rand_img((10, 14, 3), np.uint16)
    p = tmp_path / "c16.png"
    p.write_bytes(encode_png(img, filter_type=4))
    clip = read_both(str(p))
    assert clip.format.name == "RGB48"
    np.testing.assert_array_equal(_planes_hwc(clip), img)

    g = _rand_img((9, 13, 1), np.uint16, seed=1)
    p2 = tmp_path / "g16.png"
    p2.write_bytes(encode_png(g, gray=True, filter_type=1))
    clip2 = read_both(str(p2))
    assert clip2.format.name == "GRAY16"
    np.testing.assert_array_equal(clip2.planes[0][0].numpy(), g[..., 0])

    g8 = _rand_img((9, 13, 1))
    p3 = tmp_path / "g.png"
    p3.write_bytes(encode_png(g8, gray=True))
    assert read_both(str(p3)).format.name == "GRAY8"


@pytest.mark.parametrize("depth", [np.uint8, np.uint16], ids=["8", "16"])
def test_png_alpha(tmp_path, depth):
    img = _rand_img((8, 8, 4), depth)
    p = tmp_path / "a.png"
    p.write_bytes(encode_png(img, alpha=True, filter_type=3))
    clip, aclip = read_both(str(p), alpha=True)
    np.testing.assert_array_equal(aclip.planes[0][0].numpy(), img[..., 3])
    # no alpha channel: an opaque alpha clip at the format's peak
    p2 = tmp_path / "opaque.png"
    p2.write_bytes(encode_png(img[..., :3]))
    _, opaque = read_both(str(p2), alpha=True)
    a = opaque.planes[0].numpy()
    assert a.min() == a.max() == np.iinfo(depth).max


def test_multiframe_and_validate(tmp_path):
    a = _rand_img((6, 7, 3), seed=1)
    b = _rand_img((6, 7, 3), seed=2)
    pa, pb = tmp_path / "a.png", tmp_path / "b.png"
    pa.write_bytes(encode_png(a))
    pb.write_bytes(encode_png(b, filter_type=2))
    clip = read_both([str(pa), str(pb)], validate=True)
    assert clip.num_frames == 2
    np.testing.assert_array_equal(clip.planes[0][1].numpy(), b[..., 0])
    pc = tmp_path / "c.png"
    pc.write_bytes(encode_png(_rand_img((5, 7, 3))))
    msg = same_error(lambda: j_image_read([str(pa), str(pc)], validate=True),
                     lambda: vt.image_read([str(pa), str(pc)], validate=True, device="cpu"),
                     ValueError)
    assert "do not match" in msg


@pytest.mark.parametrize(
    "chunks,transfer,primaries",
    [
        ({"srgb": True}, 13, 1),
        ({"gama": 100000}, 8, 1),
        ({"gama": 45455}, 4, 1),
        ({"gama": 35714}, 5, 1),
        ({"gama": 50000}, 2, 1),
        ({"cicp": (9, 16, 0, 1)}, 16, 9),
        ({"gama": 100000,
          "chrm": (31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000)}, 8, 1),
        ({"gama": 100000,
          "chrm": (31270, 32900, 70800, 29200, 17000, 79700, 13100, 4600)}, 8, 9),
        ({"gama": 100000,
          "chrm": (11270, 32900, 70800, 29200, 17000, 79700, 13100, 4600)}, 8, 2),
        ({"cicp": (1, 13, 0, 1), "srgb": True, "gama": 100000}, 13, 1),
    ],
    ids=str,
)
def test_color_chunk_props(tmp_path, chunks, transfer, primaries):
    p = tmp_path / "c.png"
    p.write_bytes(encode_png(_rand_img((4, 4, 3)), chunks=chunks))
    clip = read_both(str(p))
    assert clip.props["_Transfer"] == transfer
    assert clip.props["_Primaries"] == primaries


def test_bmp(tmp_path):
    img = _rand_img((9, 5, 3))
    p = tmp_path / "x.bmp"
    p.write_bytes(encode_bmp(img))
    np.testing.assert_array_equal(_planes_hwc(read_both(str(p))), img)


def test_read_error(tmp_path):
    same_error(lambda: j_image_read("/nonexistent/file.png"),
               lambda: vt.image_read("/nonexistent/file.png", device="cpu"), ValueError)
    junk = tmp_path / "junk.png"
    junk.write_bytes(b"not an image at all")
    msg = same_error(lambda: j_image_read(str(junk)),
                     lambda: vt.image_read(str(junk), device="cpu"), ValueError)
    assert "unsupported image format" in msg


def test_url_needs_opt_in(monkeypatch):
    monkeypatch.delenv("VSZIP_ALLOW_URL", raising=False)
    url = "https://example.invalid/image.png"
    msg = same_error(lambda: j_image_read(url), lambda: vt.image_read(url, device="cpu"),
                     ValueError)
    assert "URL fetch disabled" in msg


def test_png_low_bit_depths_and_interlace(tmp_path):
    """1-bit gray, 2/4-bit palette and Adam7 PNGs (PIL as the independent
    encoder), 8- and 16-bit interlaced RGB."""
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(3)

    g1 = (rng.integers(0, 2, (23, 37)) * 255).astype(np.uint8)
    for interlace, name in ((False, "g1.png"), (True, "g1i.png")):
        buf = _io.BytesIO()
        PIL.fromarray(g1).convert("1").save(buf, format="PNG", interlace=interlace)
        p = tmp_path / name
        p.write_bytes(buf.getvalue())
        clip = read_both(str(p))
        assert clip.format.name == "GRAY8"
        np.testing.assert_array_equal(clip.planes[0][0].numpy(), g1)

    base = (rng.integers(0, 4, (23, 37)) * 80).astype(np.uint8)
    img = PIL.fromarray(base, "L").convert("P", palette=PIL.ADAPTIVE, colors=4)
    want = np.asarray(img.convert("RGB"))
    for bits in (2, 4):
        buf = _io.BytesIO()
        img.save(buf, format="PNG", bits=bits)
        p = tmp_path / f"pal{bits}.png"
        p.write_bytes(buf.getvalue())
        clip, _ = read_both(str(p), alpha=True)
        assert clip.format.name == "RGB24"
        np.testing.assert_array_equal(_planes_hwc(clip), want)

    rgb = rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)
    buf = _io.BytesIO()
    PIL.fromarray(rgb).save(buf, format="PNG", interlace=True)
    p = tmp_path / "rgbi.png"
    p.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(_planes_hwc(read_both(str(p))), rgb)

    g16 = rng.integers(0, 65536, (19, 29), dtype=np.uint16)
    buf = _io.BytesIO()
    PIL.fromarray(g16).save(buf, format="PNG", interlace=True)
    p = tmp_path / "g16i.png"
    p.write_bytes(buf.getvalue())
    clip = read_both(str(p))
    assert clip.format.name == "GRAY16"
    np.testing.assert_array_equal(clip.planes[0][0].numpy(), g16)


def test_float32_pfm_to_rgbs(tmp_path):
    rng = np.random.default_rng(9)
    f = rng.random((6, 8, 3), np.float32)
    p = tmp_path / "img.pfm"
    p.write_bytes(b"PF\n8 6\n-1.0\n" + f[::-1].astype("<f4").tobytes())
    clip = read_both(str(p))
    assert clip.format.name == "RGBS"
    for c in range(3):
        np.testing.assert_array_equal(clip.planes[c][0].numpy(), f[..., c])
    assert clip.props["zigimg_format"] == "float32" and clip.props["zigimg_bits"] == 32

    g = rng.random((4, 5, 1), np.float32)
    pg = tmp_path / "img_g.pfm"
    pg.write_bytes(b"Pf\n5 4\n-1.0\n" + g[::-1].astype("<f4").tobytes())
    gclip, aclip = read_both(str(pg), alpha=True)
    assert gclip.format.name == aclip.format.name == "GRAYS"
    np.testing.assert_array_equal(aclip.planes[0].numpy(), np.ones((1, 4, 5), np.float32))


def test_zigimg_props(tmp_path):
    img = _rand_img((6, 8, 3))
    p1, p2 = tmp_path / "a.png", tmp_path / "b.png"
    p1.write_bytes(encode_png(img))
    p2.write_bytes(encode_png(img))
    clip = read_both([str(p1), str(p2)])
    assert clip.props["zigimg_file_path"] == (str(p1), str(p2))
    assert clip.props["zigimg_format"] == "rgb24" and clip.props["zigimg_bits"] == 8

    PIL = pytest.importorskip("PIL.Image")
    g1 = (np.arange(64).reshape(8, 8) % 2 * 255).astype(np.uint8)
    buf = _io.BytesIO()
    PIL.fromarray(g1).convert("1").save(buf, format="PNG")
    low = tmp_path / "low.png"
    low.write_bytes(buf.getvalue())
    clip = read_both(str(low))
    assert clip.props["zigimg_format"] == "grayscale1" and clip.props["zigimg_bits"] == 1


def test_netpbm_through_image_read(tmp_path):
    g = _rand_img((5, 7, 1))
    p = tmp_path / "img.pgm"
    p.write_bytes(b"P5 7 5 255\n" + g[..., 0].tobytes())
    clip = read_both(str(p))
    assert clip.format.name == "GRAY8"
    np.testing.assert_array_equal(clip.planes[0][0].numpy(), g[..., 0])
    assert clip.props["zigimg_format"] == "grayscale8"


def test_default_device_is_the_card(tmp_path):
    """Without ``device`` the planes go to the card: with no card that is
    torch's own error, as for ``Clip.from_planes``."""
    if torch.cuda.is_available():
        pytest.skip("checks the error without a card; tests/test_torch_card.py reads on the card")
    p = tmp_path / "x.png"
    p.write_bytes(encode_png(_rand_img((4, 4, 3))))
    planes = [np.zeros((1, 4, 4), np.uint8)] * 3
    with pytest.raises(Exception) as want:
        vt.Clip.from_planes(planes, vt.get_format("RGB24"))
    with pytest.raises(type(want.value)):
        vt.image_read(str(p))


# ---------------------------------------------------------------------------
# the native unfilter against the plain version
# ---------------------------------------------------------------------------

def _filtered(rng, h, stride, filters):
    """h scanlines of random bytes, each led by its filter byte."""
    raw = rng.integers(0, 256, (h, 1 + stride), dtype=np.uint8)
    raw[:, 0] = filters
    return raw.tobytes()


@pytest.mark.parametrize("bpp", range(1, 9))
@pytest.mark.parametrize("ft", range(5))
def test_native_unfilter_matches_plain(ft, bpp):
    rng = np.random.default_rng(100 * ft + bpp)
    for h, stride in ((7, 5 * bpp), (3, bpp), (5, 3 * bpp + 1)):
        raw = _filtered(rng, h, stride, ft)
        got = png_native.unfilter(raw, h, stride, bpp)
        want = tpng._unfilter_py(raw, h, stride, bpp)
        assert got.dtype == np.uint8 and got.shape == (h, stride)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jpng._unfilter_py(raw, h, stride, bpp))


@pytest.mark.parametrize("bpp", [1, 3, 6])
def test_native_unfilter_mixed_rows(bpp):
    rng = np.random.default_rng(bpp)
    h, stride = 40, 9 * bpp
    raw = _filtered(rng, h, stride, rng.integers(0, 5, h))
    np.testing.assert_array_equal(png_native.unfilter(raw, h, stride, bpp),
                                  tpng._unfilter_py(raw, h, stride, bpp))


@pytest.mark.parametrize("bad", [5, 255])
def test_bad_filter_byte_raises_the_same_error(bad):
    rng = np.random.default_rng(bad)
    raw = _filtered(rng, 4, 6, [0, 1, bad, 2])
    msg = same_error(lambda: tpng._unfilter_py(raw, 4, 6, 3),
                     lambda: png_native.unfilter(raw, 4, 6, 3), ValueError)
    assert msg == f"bad PNG filter type {bad}"
    same_error(lambda: jpng._unfilter(raw, 4, 6, 3), lambda: tpng._unfilter(raw, 4, 6, 3),
               ValueError)


def test_decoder_uses_the_native_library(monkeypatch, tmp_path):
    calls = []
    real = png_native.unfilter

    def counted(*a):
        calls.append(a[1:])
        return real(*a)

    monkeypatch.setattr(png_native, "unfilter", counted)
    img = _rand_img((6, 5, 3))
    tpng.decode_png(encode_png(img, filter_type=4))
    assert calls == [(6, 15, 3)]


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No fallback: without a compiler the decoder raises, and ImageRead
    reports it as a read failure."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    _build.load.cache_clear()
    _build.bind("png_unfilter")
    try:
        data = encode_png(_rand_img((4, 4, 3)))
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            tpng.decode_png(data)
        p = tmp_path / "x.png"
        p.write_bytes(data)
        with pytest.raises(vt.VSZipError, match="Failed to read .*g\\+\\+ not found"):
            vt.image_read(str(p), device="cpu")
    finally:
        _build.load.cache_clear()
        _build.bind("png_unfilter")
    assert not os.path.exists(tmp_path / "build" / _build.library_path("png_unfilter").name)


@pytest.mark.parametrize("piece", [1, 7, 4096])
def test_split_idat_chunks(tmp_path, piece):
    """A PNG whose image data comes in many IDAT chunks (writers emit 8-64
    KiB each) decodes as in one: the port joins them once."""
    import struct
    import zlib

    img = _rand_img((31, 45, 3), np.uint16, seed=5)
    one = encode_png(img, filter_type=4)
    start = one.index(b"IDAT") - 4
    (length,) = struct.unpack(">I", one[start:start + 4])
    data = one[start + 8:start + 8 + length]
    chunks = b"".join(
        struct.pack(">I", len(data[i:i + piece])) + b"IDAT" + data[i:i + piece]
        + struct.pack(">I", zlib.crc32(b"IDAT" + data[i:i + piece]) & 0xFFFFFFFF)
        for i in range(0, len(data), piece))
    split = one[:start] + chunks + one[start + 12 + length:]
    p = tmp_path / "split.png"
    p.write_bytes(split)
    np.testing.assert_array_equal(_planes_hwc(read_both(str(p))), img)
