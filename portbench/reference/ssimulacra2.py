"""Plain reference of SSIMULACRA2, version 2.1, as vapoursynth-zip runs it
(src/vapoursynth/ssimulacra2.zig: toRGBS, the sRGB EOTF, then
src/filters/ssimulacra2.zig), written from the published formulas and the
plugin's conventions.  Per frame pair, in float32 up to the XYB planes and
in float64 from there:

* toRGBS, as VapourSynth's resize (zimg) does it for the plugin: integer YUV
  4:2:0 chroma upsampled at its storage depth by zimg's bicubic (b 0, c 0.5),
  left-sited horizontally (shift 0.25 of a chroma sample) and centred
  vertically, horizontal pass first, each pass in Q14 fixed point (the
  coefficients quantised with per-row error feedback, rounded half to even;
  ``(acc + 2^13) >> 14``, clamped to the sample range); every plane to float
  as ``(x - low) * f32(1 / range)`` of the limited range (luma 16-235,
  chroma 16-240, times 2^(bits - 8)); the limited-range matrix, BT.709 where
  the height is over 650 and BT.601 otherwise, coefficients derived in
  double and applied in float32.  Integer RGB is divided by its peak;
* the sRGB EOTF with zimg's continuity constants (alpha 1.055010718947587,
  beta 0.0030412825601275209): ``v / 12.92`` below ``12.92 beta``, else
  ``((v + alpha - 1) / alpha) ^ 2.4``, each division IEEE;
* six scales, each after the first a clamped 2x2 box downscale
  ``(((a + b) + c) + d) * 0.25``, odd sides repeating their last row or column;
* the opsin absorbance matrix right-associated,
  ``k0 r + (k1 g + (k2 b + bias))``, clamped at 0, VCL2's ``cbrt`` (an
  exponent-trick seed, three Newton steps, one refinement) less the bias's
  cube root, then ``X = 14 (cx - cy) / 2 + 0.42``, ``Y = (cx + cy) / 2 +
  0.01``, ``B = cz - (cx + cy) / 2 + 0.55``;
* per (scale, plane) pair the plugin does not prune (its skip table drops a
  term whose two weights are both at most 0.01: 11 of the 18 pairs at
  1080p), the plugin's 9-tap Gaussian, vertical then horizontal, under its
  edge rule (a tap before the start reflects, ``-j``, at most the last
  index; a tap past the end reads the fixed index ``n - 1 - off``), of
  ``mu1``, ``mu2``, ``im1^2 + im2^2`` and ``im1 im2``;
* the SSIM map ``max(1 - num_m num_s / den_s, 0)`` with ``num_m = 1 -
  (mu1 - mu2)^2``, ``num_s = 2 (s12 - mu1 mu2) + C2``, ``den_s = ((s11+s22) -
  mu1^2 - mu2^2) + C2``, C2 = 0.0009; the edge maps from ``d = (1 + |im2 -
  mu2|) / (1 + |im1 - mu1|) - 1``, artifact ``max(d, 0)`` and detail loss
  ``max(-d, 0)``;
* each map's mean and 4-norm ``(mean m^4)^(1/4)``;
* the 108-weight fold in the published order (plane, scale, then the three
  means and the three 4-norms), ``0.9562382616834844`` times it, the cubic
  and ``100 - 10 s^0.6276336467831387`` (100 where s <= 0).

Departures from the plugin: the blurs, the maps and their sums are taken in
float64, the score's exact value for the XYB planes, where the plugin works
in float32: its ``(s11 + s22) - mu1^2 - mu2^2`` cancels, which moved the
score by up to 0.013 points on 144x256 and 270x480 frames of this
configuration's kind, 50 to 180 times the gap between the program and this
reference.  Every product and sum before them rounds on its own (the
plugin's Zig fuses some into FMA, ``cbrt``'s steps among them); the chroma
coefficients' Q14 quantisation follows zimg as the error feedback above
states it.  Departures from libjxl's SSIMULACRA2: the plugin's 9-tap blur for
the recursive Gaussian, its pruning, and six scales even where a side falls
under 8 pixels (libjxl stops there).

Plain torch on whatever device the planes are on, with TF32 switched off;
it imports nothing of the program.  The control (``control=True``) rounds
every plane to bfloat16 between stages: after the conversion to RGB, the
EOTF, each downscale, the XYB transform, each blur and each map.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

F32 = torch.float32

# ssimulacra2 v2.1's fitted weights (the published constants)
WEIGHT = (
    0.0, 0.0007376606707406586, 0.0, 0.0, 0.0007793481682867309, 0.0,
    0.0, 0.0004371155730107379, 0.0, 1.1041726426657346, 0.00066284834129271,
    0.00015231632783718752, 0.0, 0.0016406437456599754, 0.0,
    1.8422455520539298, 11.441172603757666, 0.0, 0.0007989109436015163,
    0.000176816438078653, 0.0, 1.8787594979546387, 10.94906990605142, 0.0,
    0.0007289346991508072, 0.9677937080626833, 0.0, 0.00014003424285435884,
    0.9981766977854967, 0.00031949755934435053, 0.0004550992113792063, 0.0,
    0.0, 0.0013648766163243398, 0.0, 0.0, 0.0, 0.0, 0.0, 7.466890328078848,
    0.0, 17.445833984131262, 0.0006235601634041466, 0.0, 0.0,
    6.683678146179332, 0.00037724407979611296, 1.027889937768264,
    225.20515300849274, 0.0, 0.0, 19.213238186143016, 0.0011401524586618361,
    0.001237755635509985, 176.39317598450694, 0.0, 0.0, 24.43300999870476,
    0.28520802612117757, 0.0004485436923833408, 0.0, 0.0, 0.0,
    34.77906344483772, 44.835625328877896, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0008680556573291698, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0005313191874358747, 0.0, 0.00016533814161379112, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0004179171803251336, 0.0017290828234722833, 0.0,
    0.0020827005846636437, 0.0, 0.0, 8.826982764996862, 23.19243343998926,
    0.0, 95.1080498811086, 0.9863978034400682, 0.9834382792465353,
    0.0012286405048278493, 171.2667255897307, 0.9807858872435379, 0.0, 0.0,
    0.0, 0.0005130064588990679, 0.0, 0.00010854057858411537,
)
PRUNE = 0.01
SCALES = 6
# the plugin's 9-tap Gaussian (sigma 1.5), its float32 values
KERNEL = (0.0076144188642501831054687500, 0.0360749699175357818603515625,
          0.1095860823988914489746093750, 0.2134445458650588989257812500,
          0.2665599882602691650390625000, 0.2134445458650588989257812500,
          0.1095860823988914489746093750, 0.0360749699175357818603515625,
          0.0076144188642501831054687500)
RADIUS = 4
C2 = 0.0009
OPSIN = ((0.30, 1.0 - 0.078 - 0.30, 0.078),
         (0.23, 1.0 - 0.078 - 0.23, 0.078),
         (0.24342269, 0.20476745, 1.0 - 0.24342269 - 0.20476745))
OPSIN_BIAS = 0.0037930734
MATRICES = {709: (0.2126, 0.0722), 601: (0.299, 0.114)}   # (Kr, Kb)
EOTF_ALPHA = 1.055010718947587
EOTF_BETA = 0.0030412825601275209
PROP = "SSIMULACRA2"
# B13's band of rows: its partial sums are one row of 6 sums a column a band
BAND_ROWS = 64

# operations of each stage, term by term as the formulas above write them
UPSAMPLE_INT_OPS = 4 + 3 + 4          # 4 taps: products, adds; round, shift, clamp
TO_FLOAT_OPS = 2                      # subtract the low code, multiply
MATRIX_OPS = 2 + 4 + 2                # r, g, b
RGB_OPS = 1                           # integer RGB: multiply by 1 / peak
EOTF_OPS = 6                          # compare, divide; add, divide, pow; select
DOWNSCALE_OPS = 4                     # three adds, a multiply
CBRT_F32_OPS = 1 + 1 + 3 * 5 + 6 + 2 + 1   # abs, x/3, Newton x3, refine, a^2 x, select
CBRT_INT_OPS = 3 + 1                  # the seed's shift, multiply, subtract; underflow test
XYB_F32_OPS = 3 * (3 + 3 + 1 + CBRT_F32_OPS + 1) + 4 + 3 + 2
XYB_INT_OPS = 3 * CBRT_INT_OPS
BLUR_OPS = 2 * (9 + 8)                # per blur: 9 products and 8 adds an axis
SSIM_PRODUCT_OPS = 3 + 1              # im1^2 + im2^2, im1 im2
SSIM_MAP_OPS = 3 + 4 + 5 + 4          # num_m, num_s, den_s, the map and its clamp
EDGE_MAP_OPS = 8 + 1 + 2              # d, artifact, detail loss
SUM_OPS = 4                           # m^2, m^4, two adds


def _f32(v) -> float:
    return float(np.float32(v))


def _prop_names(cfg: dict) -> list[str]:
    names = cfg.get("compare", {}).get("props", [PROP])
    if names != [PROP]:
        raise ValueError(f"the SSIMULACRA2 reference gives the prop {PROP} alone, not {names}")
    return names


def kept(plane: int, scale: int) -> tuple[bool, bool]:
    """(SSIM map needed, edge maps needed) of a (plane, scale) pair, by the
    plugin's skip table: a term goes when both its weights are at most 0.01."""
    base = plane * 36 + scale * 6
    w = WEIGHT
    ssim = w[base] > PRUNE or w[base + 3] > PRUNE
    edge = any(w[base + k] > PRUNE for k in (1, 2, 4, 5))
    return ssim, edge


# ---------------------------------------------------------------------------
# toRGBS and the EOTF
# ---------------------------------------------------------------------------

def _bicubic(x: float, b: float = 0.0, c: float = 0.5) -> float:
    """The Mitchell-Netravali family's polynomial; b 0, c 0.5 is Catmull-Rom."""
    x = abs(x)
    if x < 1.0:
        return ((12.0 - 9.0 * b - 6.0 * c) * x ** 3 + (-18.0 + 12.0 * b + 6.0 * c) * x ** 2
                + (6.0 - 2.0 * b)) / 6.0
    if x < 2.0:
        return ((-b - 6.0 * c) * x ** 3 + (6.0 * b + 30.0 * c) * x ** 2
                + (-12.0 * b - 48.0 * c) * x + (8.0 * b + 24.0 * c)) / 6.0
    return 0.0


@lru_cache(maxsize=16)
def _q14_taps(src: int, dst: int, shift: float) -> tuple:
    """zimg's bicubic filter resizing an axis of `src` samples to `dst`, in
    Q14: for each output position its (source index, coefficient) pairs in
    index order.  Output i sits at ``(i + 0.5) src / dst + shift`` in source
    units; the window holds 2 x support / step taps from the rounded start;
    a tap before the start reads ``-x``, one past the end ``min(2 src - x,
    src - 0.5)``; weights are normalised by the window's sum, in double."""
    scale = dst / src
    step = min(scale, 1.0)
    size = max(int(math.ceil(2.0 / step)) * 2, 1)
    rows = []
    for i in range(dst):
        pos = (i + 0.5) / scale + shift
        first = pos - size / 2.0
        begin = (math.floor(first + 0.5) if first >= 0 else math.ceil(first - 0.5)) + 0.5
        total = sum(_bicubic((begin + j - pos) * step) for j in range(size))
        acc: dict[int, float] = {}
        for j in range(size):
            x = begin + j
            real = -x if x < 0.0 else (min(2.0 * src - x, src - 0.5) if x >= src else x)
            k = int(math.floor(real))
            acc[k] = acc.get(k, 0.0) + _bicubic((x - pos) * step) / total
        err, row = 0.0, []
        for k in sorted(acc):
            f = acc[k] * 16384.0 + err
            q = int(np.rint(f))
            err = f - q
            row.append((k, q))
        rows.append(tuple(row))
    return tuple(rows)


def _resize_q14(x: torch.Tensor, axis: int, dst: int, shift: float, peak: int) -> torch.Tensor:
    """One integer pass along `axis` of (N, H, W) int32 samples."""
    rows = _q14_taps(x.shape[axis], dst, shift)
    width = max(len(r) for r in rows)
    acc = None
    for t in range(width):
        idx = [r[t][0] if t < len(r) else 0 for r in rows]
        q = [r[t][1] if t < len(r) else 0 for r in rows]
        shape = [1, 1, 1]
        shape[axis] = dst
        term = (x.index_select(axis, torch.tensor(idx, device=x.device))
                * torch.tensor(q, dtype=torch.int32, device=x.device).view(shape))
        acc = term if acc is None else acc + term
    return ((acc + (1 << 13)) >> 14).clamp(0, peak)


def _upsample_chroma(c: torch.Tensor, h: int, w: int, bits: int) -> torch.Tensor:
    """A 4:2:0 chroma plane to luma size at storage depth, horizontal pass
    first (zimg's order where both axes double)."""
    peak = (1 << bits) - 1
    x = c.to(torch.int32)
    if x.shape[2] != w:
        x = _resize_q14(x, 2, w, 0.25, peak)
    if x.shape[1] != h:
        x = _resize_q14(x, 1, h, 0.0, peak)
    return x


def to_rgb(planes, cfg: dict) -> tuple:
    """Float32 R, G, B planes of integer YUV (4:2:0 or 4:4:4) or RGB."""
    bits = cfg["bits"]
    if cfg["family"] == "RGB":
        return tuple(p.to(F32) * _f32(1.0 / ((1 << bits) - 1)) for p in planes)
    if cfg["family"] != "YUV" or tuple(cfg["subsampling"]) not in ((1, 1), (0, 0)):
        raise ValueError(f"the SSIMULACRA2 reference covers integer YUV 4:2:0 and 4:4:4 and "
                         f"integer RGB, not {cfg['format']}")
    s = bits - 8
    h, w = planes[0].shape[1:]
    y = (planes[0].to(F32) - _f32(16 << s)) * _f32(1.0 / (219 << s))
    cb, cr = ((_upsample_chroma(p, h, w, bits).to(F32) - _f32(128 << s))
              * _f32(1.0 / (224 << s)) for p in planes[1:])
    kr, kb = MATRICES[709 if cfg["height"] > 650 else 601]
    kg = 1.0 - kr - kb
    r = y + _f32(2.0 * (1.0 - kr)) * cr
    g = (y + _f32(-2.0 * (1.0 - kb) * kb / kg) * cb) + _f32(-2.0 * (1.0 - kr) * kr / kg) * cr
    b = y + _f32(2.0 * (1.0 - kb)) * cb
    return r, g, b


def eotf(v: torch.Tensor) -> torch.Tensor:
    """sRGB to linear light, zimg's constants; IEEE divisions (a 0-dim
    divisor: a Python one is taken as its reciprocal on the card)."""
    def scalar(x):
        return torch.tensor(_f32(x), dtype=F32, device=v.device)

    low = v / scalar(12.92)
    high = torch.pow((v + _f32(EOTF_ALPHA - 1.0)) / scalar(EOTF_ALPHA), _f32(2.4))
    return torch.where(v < _f32(12.92 * EOTF_BETA), low, high)


# ---------------------------------------------------------------------------
# the metric
# ---------------------------------------------------------------------------

def downscale(x: torch.Tensor) -> torch.Tensor:
    n, h, w = x.shape
    if h % 2 or w % 2:
        x = torch.cat([x, x[:, -1:]], 1) if h % 2 else x
        x = torch.cat([x, x[:, :, -1:]], 2) if w % 2 else x
    return (((x[:, 0::2, 0::2] + x[:, 0::2, 1::2]) + x[:, 1::2, 0::2]) + x[:, 1::2, 1::2]) * 0.25


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """VCL2's ``cbrt_f``: the seed ``0x54800000 - e * 0x002AAAAA`` from the
    exponent bits e, three Newton steps for x^(-1/3), one refinement, then
    ``a^2 x``; 0 at and below 2^-126."""
    third, four_thirds = _f32(1.0 / 3.0), _f32(4.0 / 3.0)
    xa = x.abs()
    xa3 = third * xa
    bits = xa.view(torch.int32)
    a = (0x54800000 - (bits >> 23) * 0x002AAAAA).to(torch.int32).view(F32)
    for _ in range(3):
        a2 = a * a
        a = four_thirds * a - xa3 * (a2 * a2)
    a2 = a * a
    a = a + third * (a - xa * (a2 * a2))
    a = (a * a) * x
    return torch.where(bits <= 0x00800000, torch.zeros_like(a), a)


def to_xyb(r, g, b):
    cube_bias = _f32(np.cbrt(OPSIN_BIAS))
    c = []
    for k0, k1, k2 in OPSIN:
        m = _f32(k0) * r + (_f32(k1) * g + (_f32(k2) * b + _f32(OPSIN_BIAS)))
        c.append(cbrt(m.clamp(min=0.0)) - cube_bias)
    x = 0.5 * (c[0] - c[1])
    y = 0.5 * (c[0] + c[1])
    return x * 14.0 + 0.42, y + 0.01, (c[2] - y) + 0.55


def _taps(n: int, off: int, device) -> torch.Tensor:
    j = torch.arange(n, device=device) + off
    if off < 0:
        return torch.where(j < 0, (-j).clamp(max=n - 1), j)
    return torch.where(j > n - 1, torch.full_like(j, max(n - 1 - off, 0)), j)


def blur(x: torch.Tensor) -> torch.Tensor:
    for axis in (1, 2):
        n = x.shape[axis]
        acc = None
        for k, c in enumerate(KERNEL):
            t = c * x.index_select(axis, _taps(n, k - RADIUS, x.device))
            acc = t if acc is None else acc + t
        x = acc
    return x


def _norms(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per frame: the map's mean and its 4-norm, in float64."""
    d = m.to(torch.float64).flatten(1)
    d2 = d * d
    return d.mean(1), (d2 * d2).mean(1).sqrt().sqrt()


def _pair_terms(im1, im2, ssim: bool, edge: bool, q) -> list:
    """[ssim mean, artifact mean, detail mean, ssim 4-norm, artifact 4-norm,
    detail 4-norm] of one (scale, plane) pair, in float64; None for a term
    not computed."""
    im1, im2 = im1.to(torch.float64), im2.to(torch.float64)
    mu1, mu2 = q(blur(im1)), q(blur(im2))
    out = [None] * 6
    if ssim:
        ss = q(blur(im1 * im1 + im2 * im2))
        s12 = q(blur(im1 * im2))
        md = mu1 - mu2
        num_m = 1.0 - md * md
        num_s = 2.0 * (s12 - mu1 * mu2) + _f32(C2)
        den_s = ((ss - mu1 * mu1) - mu2 * mu2) + _f32(C2)
        out[0], out[3] = _norms(q((1.0 - (num_m * num_s) / den_s).clamp(min=0.0)))
    if edge:
        d = (1.0 + (im2 - mu2).abs()) / (1.0 + (im1 - mu1).abs()) - 1.0
        out[1], out[4] = _norms(q(d.clamp(min=0.0)))
        out[2], out[5] = _norms(q((-d).clamp(min=0.0)))
    return out


def scores(rgb1, rgb2, control: bool = False) -> torch.Tensor:
    """(N,) float64 scores of two clips' linear R, G, B planes."""
    def q(x):
        return x.to(torch.bfloat16).to(x.dtype) if control else x

    n = rgb1[0].shape[0]
    total = torch.zeros(n, dtype=torch.float64, device=rgb1[0].device)
    for scale in range(SCALES):
        if scale:
            rgb1 = tuple(q(downscale(p)) for p in rgb1)
            rgb2 = tuple(q(downscale(p)) for p in rgb2)
        xyb1 = tuple(q(p) for p in to_xyb(*rgb1))
        xyb2 = tuple(q(p) for p in to_xyb(*rgb2))
        for plane in range(3):
            ssim, edge = kept(plane, scale)
            if not (ssim or edge):
                continue
            base = plane * 36 + scale * 6
            for k, v in enumerate(_pair_terms(xyb1[plane], xyb2[plane], ssim, edge, q)):
                if v is not None:
                    total = total + WEIGHT[base + k] * v.abs()
    s = total * 0.9562382616834844
    s = 6.248496625763138e-5 * s * s * s + 2.326765642916932 * s - 0.020884521182843837 * s * s
    return torch.where(s > 0.0, 100.0 - 10.0 * s.clamp(min=0.0) ** 0.6276336467831387,
                       torch.full_like(s, 100.0))


def score(source, distorted, cfg: dict, control: bool = False) -> dict:
    """{"SSIMULACRA2": (N,) float64} of the configuration's call on two
    clips' input planes (integer tensors on one device)."""
    _prop_names(cfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        def linear(planes):
            rgb = to_rgb(planes, cfg)
            if control:
                rgb = tuple(p.to(torch.bfloat16).to(F32) for p in rgb)
            return tuple(eotf(p).to(torch.bfloat16).to(F32) if control else eotf(p)
                         for p in rgb)

        return {PROP: scores(linear(source), linear(distorted), control)}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# ---------------------------------------------------------------------------
# work
# ---------------------------------------------------------------------------

def _pyramid(h: int, w: int) -> list[tuple[int, int]]:
    sides = [(h, w)]
    for _ in range(SCALES - 1):
        h, w = (h + 1) // 2, (w + 1) // 2
        sides.append((h, w))
    return sides


def _pair_work(h: int, w: int, ssim: bool, edge: bool) -> int:
    """f32 operations of one kept pair's blurs, maps and sums, per frame."""
    ops = 2 * BLUR_OPS
    if ssim:
        ops += 2 * BLUR_OPS + SSIM_PRODUCT_OPS + SSIM_MAP_OPS + SUM_OPS
    if edge:
        ops += EDGE_MAP_OPS + 2 * SUM_OPS
    return ops * h * w


def work(cfg: dict, frames: int) -> tuple[int, int, int]:
    """(bytes, integer operations, f32 operations) one batch of `frames`
    frame pairs needs.  Bytes: every plane of both clips read once; the op
    writes no plane (its output is the per-frame score).  Operations, each
    counted once as the formulas above write them, for each of the two
    clips: the chroma upsample's two integer passes (4 taps: 11 an output
    sample), the conversion to float (2 a sample) and the matrix (8 a
    pixel), the EOTF (6 a sample, pow counted as 1), each downscale (4 an
    output sample), the XYB transform at every scale (111 f32 and 12 integer
    operations a pixel, VCL's cbrt 26 and 4 of them); then for each kept
    pair the four blurs (34 an output sample each; two where only the edge
    maps are kept), the products, the maps and their sums
    (``_pair_work``).  At 1080p, 64 frames: 796,262,400 bytes,
    13,004,697,600 integer and 87,988,070,400 f32 operations (1.37 GFLOP a
    frame; B13's share, ``stage_work``, 39,160,089,600)."""
    _prop_names(cfg)
    h, w = cfg["planes"][0]
    bps = 1 if cfg["bits"] <= 8 else 2
    nbytes = 2 * frames * bps * sum(ph * pw for ph, pw in cfg["planes"])
    int_ops = f32_ops = 0
    if cfg["family"] == "RGB":
        f32_ops += RGB_OPS * 3 * h * w
    else:
        for ph, pw in cfg["planes"][1:]:
            if (ph, pw) != (h, w):
                int_ops += UPSAMPLE_INT_OPS * (ph * w + h * w)
        f32_ops += (TO_FLOAT_OPS * 3 + MATRIX_OPS) * h * w
    f32_ops += EOTF_OPS * 3 * h * w
    for scale, (sh, sw) in enumerate(_pyramid(h, w)):
        if scale:
            f32_ops += DOWNSCALE_OPS * 3 * sh * sw
        f32_ops += XYB_F32_OPS * sh * sw
        int_ops += XYB_INT_OPS * sh * sw
    int_ops *= 2
    f32_ops *= 2
    f32_ops += stage_work(cfg, 1)["ssim_sums"][2]
    return nbytes, frames * int_ops, frames * f32_ops


def stage_work(cfg: dict, frames: int) -> dict:
    """{"ssim_sums": (bytes, integer operations, f32 operations)} of B13's
    share of one batch: every kept pair's two XYB planes read once (f32),
    its band partials written (one row of 6 f32 sums a column for each
    BAND_ROWS rows), and the blurs, maps and sums of ``_pair_work``."""
    _prop_names(cfg)
    nbytes = ops = 0
    for scale, (sh, sw) in enumerate(_pyramid(*cfg["planes"][0])):
        for plane in range(3):
            ssim, edge = kept(plane, scale)
            if ssim or edge:
                nbytes += 4 * (2 * sh * sw + 6 * sw * -(-sh // BAND_ROWS))
                ops += _pair_work(sh, sw, ssim, edge)
    return {"ssim_sums": (frames * nbytes, 0, frames * ops)}
