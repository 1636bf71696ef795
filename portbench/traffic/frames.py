"""The seeded picture generator: every frame the benchmark feeds comes from here.

A frame of each plane is a smooth gradient with a moving wave, hard-edged
blocks of their own level that drift across the picture, and per-pixel noise,
clamped to the full range of the sample type, so that the 16-bit range is
used end to end (both clamps are hit) and a range-weighted filter such as
Bilateral sees flat areas, slopes and edges as video gives them.  With
``limited=True`` the same values, clamped as before, are scaled into the
limited (studio) range instead: luma 16-235 and chroma 16-240 at 8 bits,
shifted up by ``bits - 8`` (64-940 and 64-960 at 10 bits), as encoders emit
YUV.

``distort`` makes a second clip from the first, index for index: the
distorted side of a metric's pair (a full-reference metric scores it against
the first).

Everything is drawn from one ``torch.Generator`` on the device the frames are
made on, `CHUNK` frames a call, so one seed gives the same frames every time
on one device.  The sizes never depend on the seed: every seed gives the same
shapes and the same amount of work, only other values.
"""

from __future__ import annotations

import math

import torch

BLOCK = 96        # side of the hard-edged blocks, in luma pixels
NOISE = 1200.0    # half-width of the uniform per-pixel noise, in 16-bit steps
CHUNK = 16        # frames made per call (bounds the temporaries' memory)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _plane(g, par, levels, first: int, frames: int, h: int, w: int, sub: float,
           peak: float, device, span: tuple | None = None) -> torch.Tensor:
    """Frames first .. first+frames-1 of one plane, as float samples."""
    blocks = BLOCK / sub
    n = torch.arange(first, first + frames, device=device, dtype=torch.float32).view(-1, 1, 1)
    y = torch.arange(h, device=device, dtype=torch.float32).view(1, -1, 1)
    x = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, -1)
    theta = 2 * math.pi * par[0]
    wavelength = (200.0 + 400.0 * par[1]) / sub
    phase = (x * math.cos(theta) + y * math.sin(theta)) * (2 * math.pi / wavelength)
    v = torch.sin(phase + n * (0.05 + 0.2 * par[2]) + 2 * math.pi * par[3]).mul_(36000.0)
    v += (x / w - 0.5) * (16000.0 * (par[4] - 0.5)) + (y / h - 0.5) * 8000.0 + 32768.0
    # the blocks drift by whole pixels a frame; level index = row cell * cols + col cell
    dx = torch.floor(n * (1.0 + 3.0 * par[5]) / sub)
    dy = torch.floor(n * (0.5 + 2.0 * par[6]) / sub)
    rows, cols = levels.shape
    bx = torch.floor((x + dx) / blocks).to(torch.int32).remainder_(cols)
    by = torch.floor((y + dy) / blocks).to(torch.int32).remainder_(rows)
    v += levels.reshape(-1)[(by * cols + bx).reshape(-1).long()].view(frames, h, w)
    v += torch.rand((frames, h, w), generator=g, device=device).mul_(2.0).sub_(1.0).mul_(NOISE)
    if span is not None:
        lo, hi = span
        return v.clamp_(0.0, 65535.0).mul_((hi - lo) / 65535.0).add_(lo).round_()
    return v.mul_(peak / 65535.0).round_().clamp_(0.0, peak)


def limited_span(bits: int, chroma: bool) -> tuple[float, float]:
    """The limited range's (lowest, highest) code of a plane of `bits` bits."""
    s = 1 << (bits - 8)
    return 16.0 * s, (240.0 if chroma else 235.0) * s


def make_planes(seed: int, frames: int, shapes, bits: int, device,
                limited: bool = False) -> tuple:
    """`frames` frames of planes with the (height, width) `shapes`, integer
    samples of `bits` bits (uint8 up to 8, else uint16), on `device`; in the
    limited range where `limited` (the first plane luma, the others chroma)."""
    g = _generator(seed, device)
    peak = float((1 << bits) - 1)
    dtype = torch.uint8 if bits <= 8 else torch.uint16
    luma_w = shapes[0][1]
    planes = []
    for i, (h, w) in enumerate(shapes):
        span = limited_span(bits, i > 0) if limited else None
        # the per-seed look of this plane: wave direction, length and speed,
        # the gradient's tilt, the blocks' levels and drift
        par = torch.rand(8, generator=g, device=device, dtype=torch.float64).tolist()
        sub = luma_w / w
        levels = torch.rand((int(h * sub // BLOCK) + 3, int(w * sub // BLOCK) + 3),
                            generator=g, device=device).mul_(24000.0).sub_(12000.0)
        out = torch.empty((frames, h, w), dtype=dtype, device=device)
        for first in range(0, frames, CHUNK):
            k = min(CHUNK, frames - first)
            v = _plane(g, par, levels, first, k, h, w, sub, peak, device, span)
            out[first:first + k] = v.to(torch.int32).to(dtype)
        planes.append(out)
    return tuple(planes)


def _box3(x: torch.Tensor) -> torch.Tensor:
    """The 3x3 box mean of (N, H, W) float planes, edges repeated."""
    p = torch.nn.functional.pad(x.unsqueeze(1), (1, 1, 1, 1), mode="replicate").squeeze(1)
    h, w = x.shape[1:]
    acc = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            acc += p[:, dy:dy + h, dx:dx + w]
    return acc.div_(9.0)


def distort(seed: int, planes: tuple, bits: int, params: dict, limited: bool = False) -> tuple:
    """The distorted copy of `planes`, frame for frame: each plane is mixed
    with its 3x3 box blur (``blur``: the blur's weight, 0.5 is the mean of the
    two) and rounded, requantised to multiples of ``quant`` codes (rounded
    half up), given seeded uniform integer noise of at most ``noise`` codes
    either way, and clamped to the range (the limited one where `limited`).
    The noise comes from its own generator, so one seed gives the same
    distortion of the same frames every time on one device; sizes and work
    never depend on the seed."""
    g = _generator(int(seed) ^ 0x5DEECE66D, planes[0].device)
    blur, quant, noise = float(params["blur"]), int(params["quant"]), int(params["noise"])
    peak = float((1 << bits) - 1)
    out = []
    for i, p in enumerate(planes):
        lo, hi = limited_span(bits, i > 0) if limited else (0.0, peak)
        d = torch.empty_like(p)
        for first in range(0, p.shape[0], CHUNK):
            x = p[first:first + CHUNK].to(torch.float32)
            v = (x * (1.0 - blur)).add_(_box3(x).mul_(blur)).round_()
            if quant > 1:
                v = v.div_(quant).add_(0.5).floor_().mul_(quant)
            v += torch.randint(-noise, noise + 1, v.shape, generator=g, device=v.device,
                               dtype=torch.int32).to(torch.float32)
            d[first:first + CHUNK] = v.clamp_(lo, hi).to(torch.int32).to(p.dtype)
        out.append(d)
    return tuple(out)
