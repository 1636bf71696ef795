"""The seeded picture generator: every frame the benchmark feeds comes from here.

A frame of each plane is a smooth gradient with a moving wave, hard-edged
blocks of their own level that drift across the picture, and per-pixel noise,
clamped to the full range of the sample type, so that the 16-bit range is
used end to end (both clamps are hit) and a range-weighted filter such as
Bilateral sees flat areas, slopes and edges as video gives them.

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
           peak: float, device) -> torch.Tensor:
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
    return v.mul_(peak / 65535.0).round_().clamp_(0.0, peak)


def make_planes(seed: int, frames: int, shapes, bits: int, device) -> tuple:
    """`frames` frames of planes with the (height, width) `shapes`, integer
    samples of `bits` bits (uint8 up to 8, else uint16), on `device`."""
    g = _generator(seed, device)
    peak = float((1 << bits) - 1)
    dtype = torch.uint8 if bits <= 8 else torch.uint16
    luma_w = shapes[0][1]
    planes = []
    for h, w in shapes:
        # the per-seed look of this plane: wave direction, length and speed,
        # the gradient's tilt, the blocks' levels and drift
        par = torch.rand(8, generator=g, device=device, dtype=torch.float64).tolist()
        sub = luma_w / w
        levels = torch.rand((int(h * sub // BLOCK) + 3, int(w * sub // BLOCK) + 3),
                            generator=g, device=device).mul_(24000.0).sub_(12000.0)
        out = torch.empty((frames, h, w), dtype=dtype, device=device)
        for first in range(0, frames, CHUNK):
            k = min(CHUNK, frames - first)
            v = _plane(g, par, levels, first, k, h, w, sub, peak, device)
            out[first:first + k] = v.to(torch.int32).to(dtype)
        planes.append(out)
    return tuple(planes)
