"""Plain reference of MosquitoNR's integer path (vapoursynth-zip
src/filters/mosquito_nr.zig; the call's arguments as
src/vapoursynth/mosquito_nr.zig reads them), written from the plugin's
formulas.  Per selected plane, in int32:

* the work plane is the sample lifted to ``x << 4``, with a 2-pixel
  reflect-101 border on both axes (row -1 reads row 1, row h reads row h - 2);
* each pixel's 8 directional SADs over the radius-1 or radius-2 stencil
  (``SAD_LINES``, ``SAD_BENDS``, ``FAR``): a tap t costs |t - c|, a pair of
  taps |((a + b) >> 1) - c|; the smallest SAD picks the direction, a tie keeps
  the lower index, and a smallest SAD of exactly 0 copies the centre;
* the chosen direction's blend: at radius 1 ``(c0 c + s sum + 32) >> 6``
  along a line and ``(c1 c + s sum + 64) >> 7`` along a bend, at radius 2
  ``(c0 c + s sum + 64) >> 7`` and ``(c1 c + 2s far + s sum + 128) >> 8``,
  with s the strength, c0 = 64 - 2s or 128 - 4s and c1 = 128 - 4s or 256 - 8s;
* where restore != 0, the lifting transform, vertical then horizontal, of
  the lifted original and of the blend: ``d[j] = x[2j+1] - ((x[2j] + x[r]) >> 1)``
  with r = 2j + 2, or n - 2 past the end, and ``a[j] = x[2j] + ((d[j-1] +
  d[j]) >> 2)`` with j - 1 at least 0 and j at most the last detail; the
  LL bands mixed as ``(restore ll_o + (128 - restore) ll_b + 64) >> 7``
  (ll_o alone at 128), then the inverse, horizontal then vertical, from the
  mixed LL and the blend's detail bands;
* the output ``(v + 8) >> 4``, clamped to the sample range.

Planes the call does not select, and those whose strength is 0, come back as
they went in.  Plain torch on whatever device the planes are on; it imports
nothing of the program.

The control (``control=True``) runs the same steps in float32 with every
rounded or floored shift replaced by a multiply by its power of two, and one
rounding half up at the output, ``floor(v / 16 + 0.5)``: the plugin's float
arithmetic (mosquito_nr_float.zig), which the configuration's guarantee of
integer output bit-exact with the plugin rules out.

Covered: integer GRAY and YUV formats of 8-16 bits, one strength, restore
and radius for every selected plane, in the plugin's ranges.  Float formats,
RGB, per-plane argument lists and out-of-range arguments are refused.
"""

from __future__ import annotations

import torch

from ..traffic.cost import plane_bytes

# the 8 directions: the near pair of taps along a line (0-3) and the two
# pairs whose means a bend (4-7) compares with the centre
SAD_LINES = (((0, -1), (0, 1)), ((-1, -1), (1, 1)), ((-1, 0), (1, 0)), ((-1, 1), (1, -1)))
SAD_BENDS = ((((0, -1), (-1, -1)), ((0, 1), (1, 1))),
             (((-1, -1), (-1, 0)), ((1, 1), (1, 0))),
             (((-1, 0), (-1, 1)), ((1, 0), (1, -1))),
             (((0, 1), (-1, 1)), ((0, -1), (1, -1))))
# the two taps radius 2 adds to each direction's SAD (and its blend)
FAR = (((0, -2), (0, 2)), ((-2, -2), (2, 2)), ((-2, 0), (2, 0)), ((-2, 2), (2, -2)),
       ((-1, -2), (1, 2)), ((-2, -1), (2, 1)), ((-2, 1), (2, -1)), ((-1, 2), (1, -2)))

# integer operations one selected sample needs, term by term (see ``work``)
LIFT_OPS = 1                        # x << 4
SAD_OPS = {1: 4 * (2 * 2 + 1) + 4 * (2 * 4 + 1),          # 56
           2: 4 * (4 * 2 + 3) + 4 * (2 * 2 + 2 * 4 + 3)}  # 104
CHOICE_OPS = 7 * 3 + 2              # 7 x (compare, select index, select SAD); flat test
BLEND_OPS = {1: 6 + 1, 2: 8 + 1}    # the line arm, then the flat copy's select
OUTPUT_OPS = 4                      # + 8, >> 4, and the clamp's two bounds
LIFT_STEP_OPS = 3                   # a lifting step: add, shift, add or subtract
MIX_OPS = 5                         # two multiplies, two adds, a shift


def _settings(cfg: dict, n_planes: int) -> tuple[list[bool], int, int, int]:
    """(selected planes, strength, restore, radius) of a call this file
    covers; raises ValueError for the others."""
    fmt = cfg["format"]
    if not fmt[-1].isdigit() or not 8 <= cfg["bits"] <= 16:
        raise ValueError(f"the MosquitoNR reference covers integer formats of 8-16 bits only, "
                         f"not {fmt}")
    if fmt.startswith("RGB"):
        raise ValueError(f"the MosquitoNR reference covers GRAY and YUV formats, not {fmt}")
    args = cfg["args"]
    values = []
    for key, default, lo, hi in (("strength", 16, 0, 32), ("restore", 128, 0, 128),
                                 ("radius", 2, 1, 2)):
        v = args.get(key, default)
        if not isinstance(v, int) or isinstance(v, bool):
            raise ValueError(f"the MosquitoNR reference covers one integer {key} for every "
                             f"plane, not {v!r}")
        if not lo <= v <= hi:
            raise ValueError(f"MosquitoNR {key} {v} is outside the plugin's range {lo}..{hi}")
        values.append(v)
    planes = args.get("planes", [0])
    if (not isinstance(planes, list) or len(set(planes)) != len(planes)
            or any(not isinstance(p, int) or not 0 <= p < n_planes for p in planes)):
        raise ValueError(f"MosquitoNR planes {planes!r} do not name distinct planes of "
                         f"{n_planes}")
    return [p in planes for p in range(n_planes)], *values


def _reflect(n: int, device) -> torch.Tensor:
    """Indices of a 2-sample reflect-101 border around an axis of n."""
    return torch.tensor([2, 1] + list(range(n)) + [n - 2, n - 3], device=device)


def _smooth(x: torch.Tensor, strength: int, radius: int, control: bool) -> torch.Tensor:
    """The direction-aware blend of work plane `x` (N, H, W)."""
    n, h, w = x.shape
    p = x.index_select(1, _reflect(h, x.device)).index_select(2, _reflect(w, x.device))

    def tap(t):
        dy, dx = t
        return p[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]

    def halve(v):
        return v * 0.5 if control else v >> 1

    def shift(v, k):
        return v * (1.0 / (1 << k)) if control else (v + (1 << (k - 1))) >> k

    c = tap((0, 0))
    far = radius == 2
    sads = []
    for d in range(8):
        if d < 4:
            terms = [tap(t) for t in SAD_LINES[d] + (FAR[d] if far else ())]
            sad = sum((t - c).abs() for t in terms)
        else:
            sad = sum((halve(tap(a) + tap(b)) - c).abs() for a, b in SAD_BENDS[d - 4])
            if far:
                sad = sad + sum((tap(t) - c).abs() for t in FAR[d])
        sads.append(sad)
    sads = torch.stack(sads)
    best = sads.amin(0)
    order = torch.arange(8, dtype=torch.uint8, device=x.device).view(8, 1, 1, 1)
    direction = torch.where(sads == best, order, 8).amin(0)
    del sads

    s = strength
    c0, c1 = (64 - 2 * s, 128 - 4 * s) if radius == 1 else (128 - 4 * s, 256 - 8 * s)
    line_shift, bend_shift = (6, 7) if radius == 1 else (7, 8)
    arms = []
    for d in range(8):
        if d < 4:
            near = sum(tap(t) for t in SAD_LINES[d] + (FAR[d] if far else ()))
            arms.append(shift(c0 * c + s * near, line_shift))
        else:
            near = sum(tap(t) for pair in SAD_BENDS[d - 4] for t in pair)
            acc = c1 * c + s * near
            if far:
                acc = acc + 2 * s * (tap(FAR[d][0]) + tap(FAR[d][1]))
            arms.append(shift(acc, bend_shift))
    arms = torch.stack(arms)
    chosen = arms.gather(0, direction.clamp(max=7).unsqueeze(0).long())[0]
    return torch.where(direction == 8, c, chosen)


def _pairs(n: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Along an axis of n: each detail's right even neighbour (r = 2j + 2, or
    n - 2 past the end) as an index into the evens, and each approximation's
    left and right detail indices."""
    na, nd = (n + 1) // 2, n // 2
    right = [(2 * j + 2 if 2 * j + 2 < n else n - 2) // 2 for j in range(nd)]
    left_d = [max(j - 1, 0) for j in range(na)]
    right_d = [min(j, nd - 1) for j in range(na)]
    return tuple(torch.tensor(v, device=device) for v in (right, left_d, right_d))


def _forward(x: torch.Tensor, axis: int, control: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The lifting step along `axis`: (approximation, detail)."""
    n = x.shape[axis]
    right, left_d, right_d = _pairs(n, x.device)
    even = x.index_select(axis, torch.arange(0, n, 2, device=x.device))
    odd = x.index_select(axis, torch.arange(1, n, 2, device=x.device))
    nd = odd.shape[axis]
    pred = even.narrow(axis, 0, nd) + even.index_select(axis, right)
    d = odd - (pred * 0.5 if control else pred >> 1)
    upd = d.index_select(axis, left_d) + d.index_select(axis, right_d)
    return even + (upd * 0.25 if control else upd >> 2), d


def _inverse(a: torch.Tensor, d: torch.Tensor, axis: int, n: int,
             control: bool) -> torch.Tensor:
    """The inverse lifting step along `axis` to length `n`."""
    right, left_d, right_d = _pairs(n, a.device)
    upd = d.index_select(axis, left_d) + d.index_select(axis, right_d)
    even = a - (upd * 0.25 if control else upd >> 2)
    pred = even.narrow(axis, 0, d.shape[axis]) + even.index_select(axis, right)
    odd = d + (pred * 0.5 if control else pred >> 1)
    # interleave: even samples at 2j, odd ones at 2j + 1
    shape = list(even.shape)
    shape[axis] = n
    out = torch.empty(shape, dtype=even.dtype, device=even.device)
    out.index_copy_(axis, torch.arange(0, n, 2, device=a.device), even)
    out.index_copy_(axis, torch.arange(1, n, 2, device=a.device), odd)
    return out


def _restore(orig: torch.Tensor, blur: torch.Tensor, restore: int,
             control: bool) -> torch.Tensor:
    h, w = orig.shape[1:]
    ll_o = _forward(_forward(orig, 1, control)[0], 2, control)[0]
    va_b, vd_b = _forward(blur, 1, control)
    ll_b, hd_b = _forward(va_b, 2, control)
    if restore == 128:
        ll = ll_o
    elif control:
        ll = (restore * ll_o + (128 - restore) * ll_b) * (1.0 / 128)
    else:
        ll = (restore * ll_o + (128 - restore) * ll_b + 64) >> 7
    return _inverse(_inverse(ll, hd_b, 2, w, control), vd_b, 1, h, control)


def _plane(x: torch.Tensor, strength: int, restore: int, radius: int, bits: int,
           control: bool) -> torch.Tensor:
    if min(x.shape[1:]) < 4:
        raise ValueError(f"MosquitoNR needs planes of at least 4x4, not {tuple(x.shape[1:])}")
    lifted = x.to(torch.float32) * 16.0 if control else x.to(torch.int32) << 4
    v = _smooth(lifted, strength, radius, control)
    if restore:
        v = _restore(lifted, v, restore, control)
    v = torch.floor(v * (1.0 / 16) + 0.5) if control else (v + 8) >> 4
    return v.clamp(0, (1 << bits) - 1).to(torch.int32).to(x.dtype)


def run(planes, cfg: dict, control: bool = False) -> tuple:
    """Every output plane of the configuration's call on input `planes`."""
    selected, strength, restore, radius = _settings(cfg, len(planes))
    out = []
    for x, sel in zip(planes, selected):
        if x.dtype not in (torch.uint8, torch.uint16):
            raise ValueError(f"the MosquitoNR reference takes uint8/uint16, got {x.dtype}")
        out.append(_plane(x, strength, restore, radius, cfg["bits"], control)
                   if sel and strength else x)
    return tuple(out)


def work(cfg: dict, frames: int) -> tuple[int, int, int]:
    """(bytes, integer operations, f32 operations) one batch of `frames`
    frames needs.  Bytes: each selected plane read once and written once;
    planes passed through cost nothing.  Integer operations, for each
    selected sample, from the formulas above, each counted once as written:

    * the lift: 1;
    * the 8 SADs: a tap's |t - c| is 2 and a pair's |((a + b) >> 1) - c| 4,
      and a SAD of k terms adds them with k - 1 adds: at radius 1 the lines
      4 x (2 x 2 + 1) and the bends 4 x (2 x 4 + 1), 56; at radius 2 the lines
      4 x (4 x 2 + 3) and the bends 4 x (2 x 2 + 2 x 4 + 3), 104;
    * the choice: 7 x (a compare, the index's select, the SAD's select) and
      the flat test's compare and select, 23;
    * one blend arm, the cheaper (a line's; the data picks which arm runs),
      and the flat copy's select: at radius 1 two multiplies, two adds, the
      rounding add and the shift, 6 + 1; at radius 2 four adds, 8 + 1;
    * where restore != 0, the lifting steps at 3 operations a sample they
      produce: the forward transform of two planes, vertical over the whole
      plane and horizontal over its approximation rows, the inverse from
      the same bands; and where 0 < restore < 128 the LL mix at 5 a sample of
      the LL band; at 1080p these come to about 13.5 a sample, 14.75 mixed;
    * the output: + 8, >> 4 and the clamp's two bounds, 4.

    At the defaults (radius 2, restore 128) on the luma of 64 frames of
    1080p: 530,841,600 bytes and 20,503,756,800 operations (154.5 a sample).
    """
    selected, strength, restore, radius = _settings(cfg, len(cfg["planes"]))
    shapes = [tuple(s) for s, sel in zip(cfg["planes"], selected) if sel and strength]
    nbytes = plane_bytes(shapes, frames, 1 if cfg["bits"] <= 8 else 2)
    per_sample = LIFT_OPS + SAD_OPS[radius] + CHOICE_OPS + BLEND_OPS[radius] + OUTPUT_OPS
    ops = 0
    for h, w in shapes:
        ops += per_sample * h * w
        if restore:
            ha, wa = (h + 1) // 2, (w + 1) // 2
            # forward (two planes) and inverse, each vertical over h x w and
            # horizontal over the ha x w approximation rows
            ops += 3 * LIFT_STEP_OPS * (h * w + ha * w)
            if restore < 128:
                ops += MIX_OPS * ha * wa
    return nbytes, frames * ops, 0
