"""Plain reference of BoxBlur's runtime integer path, the one a call takes when
hradius != vradius, hradius > 22, hpasses > 1 or vpasses > 1 (vapoursynth-zip
src/filters/boxblur_runtime.zig, ``hblur`` and ``vblur``), written from the
plugin's formulas:

* ``hpasses`` horizontal passes, then ``vpasses`` vertical ones; an axis whose
  radius or pass count is 0 is left as it is;
* in each pass, each row's (horizontal) or column's (vertical) window sum
  W(x) of 2r + 1 samples under the duplicate-edge mirror, m(-j) = j - 1 and
  m(n - 1 + j) = n - j, in both axes;
* put out by the plugin's running fixed-point sum, whose closed form is
  ``(C0 + inv2 * (W(x) - W(0))) >> 16`` with ``C0 = (W(0) * inv + 2^31) >> 16``,
  ``inv = (2^32 + r) // (2r + 1)`` and ``inv2 = inv >> 16``;
* each pass's output is rounded back to the sample type, and that is the
  next pass's input.

Window sums are explicit sums of 2r + 1 shifted copies in int32, the
quantiser int64.  Plain torch on whatever device the planes are on; it imports
nothing of the program.

The control (``control=True``) is the same blur with the quantiser of every
pass, in both axes, replaced by a float32 mean rounded half up,
``floor(W / (2r + 1) + 0.5)``: the lower-precision arithmetic that the
configuration's guarantee of integer output bit-exact with the plugin rules
out.

Covered: uint8 and uint16 planes, every plane processed, the runtime path.
Float formats, a subset of planes and the comptime path (``reference/boxblur.py``)
are refused.
"""

from __future__ import annotations

import torch

from ..traffic.cost import plane_bytes
from .boxblur import _dup_cols as _dup_index

# integer operations per output sample of one pass, in either axis: the
# window slides by an add and a subtract, and the running output adds inv2
# times the difference of the entering and leaving samples (a subtract, a
# multiply, an add) and shifts.  A line's start (W(0) over 2r + 1 samples,
# then C0) is left out: 0.34% of a horizontal and 0.60% of a vertical pass
# over a 1080p YUV420 frame at r 13
INT_OPS_PER_SAMPLE_PASS = 2 + 4


def _passes(cfg: dict) -> tuple[tuple[int, int], tuple[int, int]]:
    """((hradius, hpasses), (vradius, vpasses)) of a call this file covers,
    passes 0 where the radius is 0."""
    args = cfg["args"]
    hr, vr = int(args.get("hradius", 1)), int(args.get("vradius", 1))
    hp, vp = int(args.get("hpasses", 1)), int(args.get("vpasses", 1))
    if not cfg["format"][-1].isdigit() or cfg["bits"] > 16:
        raise ValueError("the BoxBlur runtime reference covers integer formats of 8-16 bits "
                         f"only, not {cfg['format']}")
    if args.get("planes") not in (None, [0, 1, 2]):
        raise ValueError("the BoxBlur runtime reference covers calls that process every plane")
    if min(hr, vr, hp, vp) < 0 or not (hr > 0 and hp > 0 or vr > 0 and vp > 0):
        raise ValueError("the BoxBlur runtime reference needs a radius >= 0 and an axis to blur")
    if not (hr != vr or hr > 22 or hp > 1 or vp > 1):
        raise ValueError("the call takes BoxBlur's comptime path (reference/boxblur.py), "
                         "not the runtime path")
    return (hr, hp if hr > 0 else 0), (vr, vp if vr > 0 else 0)


def blur_pass(x: torch.Tensor, radius: int, axis: int, control: bool = False) -> torch.Tensor:
    """One runtime pass of (N, H, W) uint8/uint16 planes `x` along `axis` (2:
    rows, 1: columns), rounded back to the sample type."""
    n = x.shape[axis]
    if 2 * radius >= n:
        raise ValueError(f"radius {radius} does not fit an axis of {n} samples")
    k = 2 * radius + 1
    xi = x.to(torch.int32)
    win = torch.zeros_like(xi)
    for off in range(-radius, radius + 1):
        win += xi.index_select(axis, _dup_index(n, off, x.device))
    del xi
    if control:
        out = torch.floor(win.to(torch.float32) / k + 0.5)
    else:
        inv = ((1 << 32) + radius) // k
        w0 = win.narrow(axis, 0, 1).to(torch.int64)
        c0 = (w0 * inv + (1 << 31)) >> 16
        out = (c0 + (inv >> 16) * (win.to(torch.int64) - w0)) >> 16
    return out.to(torch.int32).to(x.dtype)


def run(planes, cfg: dict, control: bool = False) -> tuple:
    """Every output plane of the configuration's call on input `planes`."""
    (hr, hp), (vr, vp) = _passes(cfg)
    out = []
    for x in planes:
        if x.dtype not in (torch.uint8, torch.uint16):
            raise ValueError(f"the BoxBlur runtime reference takes uint8/uint16, got {x.dtype}")
        for _ in range(hp):
            x = blur_pass(x, hr, 2, control)
        for _ in range(vp):
            x = blur_pass(x, vr, 1, control)
        out.append(x)
    return tuple(out)


def _bytes(cfg: dict, frames: int) -> int:
    """Every plane of `frames` frames read once and written once."""
    return plane_bytes(cfg["planes"], frames, 1 if cfg["bits"] <= 8 else 2)


def work_by_axis(cfg: dict, frames: int) -> dict[str, tuple[int, int, int]]:
    """(bytes, integer operations, f32 operations) of each axis's passes, by
    axis ("h", "v"), in one batch of `frames` frames: an axis's passes read
    every plane once and write it once, and each pass costs
    ``INT_OPS_PER_SAMPLE_PASS`` operations a sample.  At 5 passes an axis on
    1080p YUV420P16, 64 frames: 796,262,400 bytes and 5,971,968,000
    operations an axis."""
    samples = frames * sum(h * w for h, w in cfg["planes"])
    nbytes = _bytes(cfg, frames)
    return {axis: ((nbytes, INT_OPS_PER_SAMPLE_PASS * passes * samples, 0) if passes else
                   (0, 0, 0))
            for axis, (_, passes) in zip("hv", _passes(cfg))}


def work(cfg: dict, frames: int) -> tuple[int, int, int]:
    """(bytes, integer operations, f32 operations) one batch of `frames`
    frames needs: every plane read once and written once, and both axes'
    operations (``work_by_axis``), 11,943,936,000 at 5 passes an axis on
    64 frames of 1080p YUV420P16."""
    axes = work_by_axis(cfg, frames).values()
    return _bytes(cfg, frames), sum(a[1] for a in axes), 0
