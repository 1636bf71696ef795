"""Plain reference of Bilateral's truncated-window algorithm (algorithm 2 of
vapoursynth-zip src/filters/bilateral.zig), for integer YUV or gray planes.

Create time, re-derived here from sigmaS and sigmaR as the plugin does
(src/vapoursynth/bilateral.zig): the chroma sigmaS of a subsampled YUV format
is sigmaS / sqrt(2^ssw * 2^ssh); a plane's window radius and tap step follow
from orad = max(int(2 sigmaS + 0.5), 1) (step 1 below 4, 2 below 8, else 3;
samples grow while 2 orad > 3 radius); the spatial weights are
``exp((x^2 + y^2) / (-2 sigmaS^2))`` in float64 stored as float32; the range
weights are a table over |difference| 0 .. 2^bits - 1 of
``exp(((min(d, upper) * scale)^2) * -0.5) * c`` in float32, with
``upper = trunc(min(range, 8 sigmaR range + 0.5))``, ``scale = 1 / (range
sigmaR)`` and ``c = 1 / (sqrt(2 pi) sigmaR)``, range = 2^bits - 1.

Per pixel: the taps (+-yy, +-xx) for yy, xx in 1, 1 + step, ... <= radius
over a copy with replicated edges; for each (yy, xx) in that order the four
taps (-yy, xx), (yy, xx), (-yy, -xx), (yy, -xx) give a weight sum and a
weighted sum, each scaled by the spatial weight and added to the totals, which
start from the centre's weight c; the output is
``trunc(clamp(sum / weights + 0.5, 0, peak))``.  Every product and sum is
rounded to float32 on its own, in that order.  Plain torch on whatever device
the planes are on; it imports nothing of the program.

The control (``control=True``) is the same computation in bfloat16, the
nearest precision below the float32 the plugin states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..traffic.cost import plane_bytes


def _list3(v, default):
    if v is None:
        v = [default]
    elif not isinstance(v, (list, tuple)):
        v = [v]
    return [float(v[min(i, len(v) - 1)]) for i in range(3)]


def plane_params(cfg: dict) -> list:
    """Per plane: None where the plane passes through, else (sigmaS, sigmaR,
    radius, step)."""
    args = cfg["args"]
    nplanes = len(cfg["planes"])
    ss = args.get("sigmaS", 3.0)
    ss = list(ss) if isinstance(ss, (list, tuple)) else [ss]
    yuv = cfg["family"] == "YUV"
    ssw, ssh = cfg.get("subsampling", [0, 0])
    sig_s = [0.0] * 3
    for i in range(3):
        if i < len(ss):
            sig_s[i] = float(ss[i])
        elif i == 0:
            sig_s[0] = 3.0
        elif i == 1 and yuv and ssw and ssh:
            sig_s[1] = sig_s[0] / math.sqrt(float((1 << ssh) * (1 << ssw)))
        else:
            sig_s[i] = sig_s[i - 1]
    sig_r = _list3(args.get("sigmaR"), 0.02)
    wanted = args.get("planes")
    wanted = list(range(nplanes)) if wanted is None else [int(p) for p in wanted]
    out = []
    for i in range(nplanes):
        if i not in wanted or sig_s[i] == 0 or sig_r[i] == 0:
            out.append(None)
            continue
        orad = max(int(sig_s[i] * 2 + 0.5), 1)
        step = 1 if orad < 4 else (2 if orad < 8 else 3)
        samples, radius = 1, 1
        while orad * 2 > radius * 3:
            samples += 1
            radius = 1 + (samples - 1) * step
            if radius >= orad and samples > 2:
                samples -= 1
                radius = 1 + (samples - 1) * step
                break
        # the plugin takes algorithm 2 at step 1, or at sigmaR < 0.08 with
        # fewer than 5 samples, or where 4 samples^2 <= 15 PBFICnum
        num = 4 if sig_r[i] >= 0.08 else (
            min(16, int(4 * 0.08 / sig_r[i] + 0.5)) if sig_r[i] >= 0.015
            else min(32, int(16 * 0.015 / sig_r[i] + 0.5)))
        if i > 0 and yuv and num % 2 == 0:
            num += 1
        alg2 = (step == 1 or (sig_r[i] < 0.08 and samples < 5)
                or 4 * samples * samples <= 15 * num)
        if args.get("algorithm", 0) not in (0, 2) or not alg2:
            raise ValueError("the Bilateral reference covers algorithm 2 only")
        out.append((sig_s[i], sig_r[i], radius, step))
    return out


def range_table(sigma_r: float, bits: int, device, dtype=torch.float32) -> torch.Tensor:
    rng = float((1 << bits) - 1)
    upper = float(np.float32(np.trunc(min(rng, sigma_r * 8.0 * rng + 0.5))))
    scale = float(np.float32(1.0 / (rng * sigma_r)))
    c = float(np.float32(1.0 / (math.sqrt(2.0 * math.pi) * sigma_r)))
    t = torch.arange(1 << bits, device=device, dtype=torch.float32).clamp_(max=upper).mul_(scale)
    return t.mul_(t).mul_(-0.5).exp_().mul_(c).to(dtype), c


def spatial_weights(radius: int, sigma_s: float) -> np.ndarray:
    y, x = np.mgrid[0:radius + 1, 0:radius + 1].astype(np.float64)
    return np.exp((x * x + y * y) / (sigma_s * sigma_s * -2.0)).astype(np.float32)


def filter_plane(x: torch.Tensor, params, bits: int, control: bool = False) -> torch.Tensor:
    """Algorithm 2 on (N, H, W) integer planes `x`."""
    sigma_s, sigma_r, radius, step = params
    dt = torch.bfloat16 if control else torch.float32
    lut, c = range_table(sigma_r, bits, x.device, dt)
    gs = spatial_weights(radius, sigma_s)
    n, h, w = x.shape
    iy = torch.arange(-radius, h + radius, device=x.device).clamp_(0, h - 1)
    ix = torch.arange(-radius, w + radius, device=x.device).clamp_(0, w - 1)
    pad = x.to(torch.int32)[:, iy][:, :, ix]
    padf = pad.to(dt)

    def tap(a, dy, dx):
        return a[:, radius + dy: radius + dy + h, radius + dx: radius + dx + w]

    centre = tap(pad, 0, 0)
    w0 = float(np.float32(gs[0, 0]) * np.float32(c))
    wsum = torch.full((n, h, w), w0, dtype=dt, device=x.device)
    total = tap(padf, 0, 0) * torch.tensor(w0, dtype=dt, device=x.device)
    for yy in range(1, radius + 1, step):
        for xx in range(1, radius + 1, step):
            swei = torch.tensor(float(gs[yy, xx]), dtype=dt, device=x.device)
            rsum = acc = None
            for dy, dx in ((-yy, xx), (yy, xx), (-yy, -xx), (yy, -xx)):
                wr = lut[(centre - tap(pad, dy, dx)).abs_().long()]
                prod = wr * tap(padf, dy, dx)
                rsum = wr if rsum is None else rsum + wr
                acc = prod if acc is None else acc + prod
            wsum = wsum + rsum * swei
            total = total + acc * swei
    peak = float((1 << bits) - 1)
    out = (total / wsum).to(torch.float32)
    return torch.trunc(torch.clamp(out + 0.5, 0.0, peak)).to(torch.int32).to(x.dtype)


def run(planes, cfg: dict, control: bool = False) -> tuple:
    """Every output plane of the configuration's call on input `planes`."""
    return tuple(p if par is None else filter_plane(p, par, cfg["bits"], control)
                 for p, par in zip(planes, plane_params(cfg)))


# float32 operations per output sample for T taps around the centre, as the
# published formula needs them: per tap |c - n| (a subtract, an absolute
# value), its range weight as one table read (no arithmetic), the weight added
# to its group's weight sum (1) and weight times sample added to its group's
# sum (2); per group of four taps both sums scaled by the spatial weight and
# added to the totals (4); the centre's product (1), the division (1) and the
# integer output's rounding (+ 0.5, two clamps, truncation: 4)
def f32_ops_per_sample(taps: int) -> int:
    return taps * 5 + (taps // 4) * 4 + 1 + 1 + 4


def work(cfg: dict, frames: int) -> tuple[int, int, int]:
    """(bytes, integer operations, f32 operations) one batch of `frames`
    frames needs: the planes that pass through cost nothing."""
    bps = 1 if cfg["bits"] <= 8 else 2
    shapes, f32 = [], 0
    for (h, w), par in zip(cfg["planes"], plane_params(cfg)):
        if par is None:
            continue
        _, _, radius, step = par
        taps = 4 * len(range(1, radius + 1, step)) ** 2
        shapes.append((h, w))
        f32 += f32_ops_per_sample(taps) * frames * h * w
    return plane_bytes(shapes, frames, bps), 0, f32
