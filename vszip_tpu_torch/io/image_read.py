"""ImageRead: load image file(s) into a clip.

Reference: src/vapoursynth/image_read.zig.  Multiple paths stack into a
multi-frame clip (fps 30/1); outputs Gray8/16, RGB24/48, or (for other
pixel layouts) RGBS; alpha channels / indexed images yield a Gray alpha
clip (returned when ``alpha=True``).  PNG color chunks map to the frame
props: cICP wins, then sRGB (defaults), then gAMA (100000->LINEAR,
45455->BT470_M, 35714->BT470_BG, else UNSPECIFIED) and cHRM matched against
known primaries with tolerance 1000.  ``validate=True`` pre-checks that all
paths decode to matching dimensions/format.  HTTP(S) URLs are fetched with
urllib (the reference uses an in-process HTTP client) but only when
``VSZIP_ALLOW_URL=1`` is set — the default is zero egress.

The PyTorch counterpart of ``vszip_tpu.io.image_read``: the same formats,
props and messages.  Decoding runs on the host (NumPy, zlib and the native
unfilter); the frames are stacked there and the clip is built with
``Clip.from_planes(..., device=device)``, so the planes, and the alpha clip's,
land on the card unless the caller asks for ``device="cpu"``."""

from __future__ import annotations

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import get_format
from ..core.params import VSZipError
from .png import decode

FILTER_NAME = "ImageRead"

_CHRM_CANDIDATES = [
    ((31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000), 1),   # BT709
    ((31270, 32900, 70800, 29200, 17000, 79700, 13100, 4600), 9),   # BT2020
    ((31270, 32900, 68000, 32000, 26500, 69000, 15000, 6000), 12),  # ST432-1
    ((31400, 35100, 68000, 32000, 26500, 69000, 15000, 6000), 11),  # ST431-2
    ((31270, 32900, 63000, 34000, 31000, 59500, 15500, 7000), 6),   # ST170M
]


def _near(a, b, tol=1000):
    return abs(int(a) - int(b)) <= tol


def _color_props(chunks: dict) -> dict:
    transfer, primaries = 13, 1  # sRGB (IEC 61966-2-1), BT709
    if "cicp" in chunks:
        ci = chunks["cicp"]
        return {"_Primaries": int(ci[0]), "_Transfer": int(ci[1])}
    if chunks.get("srgb"):
        return {"_Primaries": primaries, "_Transfer": transfer}
    if "gama" in chunks:
        g = chunks["gama"]
        if _near(g, 100000):
            transfer = 8   # LINEAR
        elif _near(g, 45455):
            transfer = 4   # BT470_M
        elif _near(g, 35714):
            transfer = 5   # BT470_BG
        else:
            transfer = 2   # UNSPECIFIED
    if "chrm" in chunks:
        primaries = 2  # UNSPECIFIED
        for cand, prim in _CHRM_CANDIDATES:
            if all(_near(r, v) for r, v in zip(cand, chunks["chrm"])):
                primaries = prim
                break
    return {"_Primaries": primaries, "_Transfer": transfer}


def _load(path: str) -> bytes:
    if path.lower().startswith(("http://", "https://")):
        # Network fetches are opt-in: the reference fetches URLs with an
        # in-process HTTP client (src/vapoursynth/image_read.zig), but this
        # package defaults to zero egress — set VSZIP_ALLOW_URL=1 to enable.
        import os

        if os.environ.get("VSZIP_ALLOW_URL") != "1":
            raise VSZipError(
                f"{FILTER_NAME}: URL fetch disabled; set VSZIP_ALLOW_URL=1 "
                f"to allow network access for '{path}'")
        from urllib.request import urlopen

        with urlopen(path) as r:
            return r.read()
    with open(path, "rb") as f:
        return f.read()


def image_read(path, validate: bool = False, alpha: bool = False, *,
               device: torch.device | str = "cuda"):
    """Returns a Clip on `device` (and the Gray alpha clip, on the same
    device, when ``alpha=True``)."""
    paths = [path] if isinstance(path, (str, bytes)) else list(path)
    imgs = []
    for p in paths:
        try:
            imgs.append(decode(_load(p)))
        except Exception as e:  # noqa: BLE001
            raise VSZipError(f"{FILTER_NAME}: Failed to read '{p}': {e}") from e

    first = imgs[0]
    if validate and len(imgs) > 1:
        for p, im in zip(paths[1:], imgs[1:]):
            if im.pixels.shape != first.pixels.shape or im.gray != first.gray:
                raise VSZipError(
                    f"{FILTER_NAME}: Dimensions or pixel formats do not match: {p}"
                )

    h, w, nchan = first.pixels.shape
    is_float = first.pixels.dtype == np.float32
    depth16 = first.pixels.dtype == np.uint16
    gray = first.gray
    if is_float:
        # zigimg float32 sources -> 32-bit float output (reference
        # src/vapoursynth/image_read.zig:440 queryVideoFormat with
        # SampleType Float, bps 32; :325-327 copyPixels(f32, ...))
        fmt = get_format("GRAYS" if gray else "RGBS")
    elif gray:
        fmt = get_format("GRAY16" if depth16 else "GRAY8")
    else:
        fmt = get_format("RGB48" if depth16 else "RGB24")

    stack = np.stack([im.pixels for im in imgs])  # (N, H, W, C)
    if gray:
        planes = (np.ascontiguousarray(stack[..., 0]),)
    else:
        planes = tuple(np.ascontiguousarray(stack[..., c]) for c in range(3))
    props = _color_props(first.chunks)
    props["_ColorRange"] = 0
    if not gray:
        props["_Matrix"] = 0  # RGB
    # source-file observability props (reference image_read.zig:348-350)
    props["zigimg_file_path"] = tuple(
        p if isinstance(p, str) else str(p) for p in paths)
    props["zigimg_format"] = first.zformat
    props["zigimg_bits"] = int(first.zbits)
    clip = Clip.from_planes(planes, fmt, props, device=device)

    if not alpha:
        return clip
    if first.has_alpha and stack.shape[-1] in (2, 4):
        a = np.ascontiguousarray(stack[..., -1])
    else:
        peak = (1.0 if is_float else 65535 if depth16 else 255)
        a = np.full((len(imgs), h, w), peak, planes[0].dtype)
    afmt = get_format("GRAYS" if is_float else
                      "GRAY16" if depth16 else "GRAY8")
    return clip, Clip.from_planes((a,), afmt, {"_ColorRange": 0}, device=device)
