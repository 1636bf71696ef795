"""Plain reference of BoxBlur's comptime integer path, the one a call with
hradius == vradius <= 22 and one pass takes (vapoursynth-zip
src/filters/boxblur_comptime.zig), written from the plugin's formulas:

* vertical: each column's window sum of 2r + 1 rows under the comptime
  mirror (a row above the top reads row -j, at most the last row; a row
  below the bottom reads the fixed row n - 1 - off for tap offset off),
  quantised as ``(col * inv + 2^31) >> 32`` with ``inv = (2^32 + r) //
  (2r + 1)``;
* horizontal: each row's window sum W(x) of 2r + 1 samples under the
  duplicate-edge mirror (m(-j) = j - 1, m(n - 1 + j) = n - j), put out by the
  plugin's running fixed-point sum, whose closed form is
  ``(C0 + inv2 * (W(x) - W(0))) >> 16`` with ``C0 = (W(0) * inv + 2^31) >> 16``
  and ``inv2 = inv >> 16``.

Window sums are explicit sums of 2r + 1 shifted copies in int32, the
quantisers int64.  Plain torch on whatever device the planes are on; it imports
nothing of the program.

The control (``control=True``) is the same blur with both quantisers replaced
by float32 means rounded half up, ``floor(sum / (2r + 1) + 0.5)``: the
lower-precision arithmetic a port might be tempted by, which breaks the
configuration's guarantee that integer output is bit-exact with the plugin.
"""

from __future__ import annotations

import torch

from ..traffic.cost import plane_bytes

# integer operations per output sample the plugin's formulas need: the
# vertical window slides by an add and a subtract and its quantiser takes a
# multiply, an add and a shift; the horizontal window slides by an add and a
# subtract, and its running output adds inv2 times the difference of the
# entering and leaving samples (a subtract, a multiply, an add) and shifts
INT_OPS_PER_SAMPLE = 2 + 3 + 2 + 4


def _radius(args: dict) -> int:
    hr, vr = int(args.get("hradius", 1)), int(args.get("vradius", 1))
    hp, vp = int(args.get("hpasses", 1)), int(args.get("vpasses", 1))
    if hr != vr or hr > 22 or hp != 1 or vp != 1 or args.get("planes") not in (None, [0, 1, 2]):
        raise ValueError("the BoxBlur reference covers the comptime path only "
                         "(hradius == vradius <= 22, one pass, every plane)")
    return hr


def _hybrid_rows(n: int, off: int, device) -> torch.Tensor:
    j = torch.arange(n, device=device) + off
    j = torch.where(j < 0, torch.clamp(-j, max=n - 1), j)
    return torch.where(j > n - 1, torch.full_like(j, max(n - 1 - off, 0)), j)


def _dup_cols(n: int, off: int, device) -> torch.Tensor:
    j = torch.arange(n, device=device) + off
    j = torch.where(j < 0, -j - 1, j)
    return torch.where(j > n - 1, 2 * n - 1 - j, j)


def blur(x: torch.Tensor, radius: int, control: bool = False) -> torch.Tensor:
    """The comptime integer blur of (N, H, W) uint8/uint16 planes `x`."""
    n, h, w = x.shape
    k = 2 * radius + 1
    inv = ((1 << 32) + radius) // k
    xi = x.to(torch.int32)
    col = torch.zeros_like(xi)
    for off in range(-radius, radius + 1):
        col += xi.index_select(1, _hybrid_rows(h, off, x.device))
    if control:
        v = torch.floor(col.to(torch.float32) / k + 0.5).to(torch.int32)
    else:
        v = ((col.to(torch.int64) * inv + (1 << 31)) >> 32).to(torch.int32)
    del col
    row = torch.zeros_like(v)
    for off in range(-radius, radius + 1):
        row += v.index_select(2, _dup_cols(w, off, x.device))
    if control:
        out = torch.floor(row.to(torch.float32) / k + 0.5)
    else:
        w0 = row[:, :, :1].to(torch.int64)
        c0 = (w0 * inv + (1 << 31)) >> 16
        out = (c0 + (inv >> 16) * (row.to(torch.int64) - w0)) >> 16
    return out.to(torch.int32).to(x.dtype)


def run(planes, cfg: dict, control: bool = False) -> tuple:
    """Every output plane of the configuration's call on input `planes`."""
    r = _radius(cfg["args"])
    return tuple(blur(p, r, control) for p in planes)


def work(cfg: dict, frames: int) -> tuple[int, int, int]:
    """(bytes, integer operations, f32 operations) one batch of `frames`
    frames needs."""
    _radius(cfg["args"])
    samples = frames * sum(h * w for h, w in cfg["planes"])
    bps = 1 if cfg["bits"] <= 8 else 2
    return plane_bytes(cfg["planes"], frames, bps), INT_OPS_PER_SAMPLE * samples, 0
