"""XPSNR: Fraunhofer's perceptually weighted PSNR (the port of
``vszip_tpu.ops.xpsnr``; the reference's src/filters/xpsnr.zig and
src/vapoursynth/xpsnr.zig).

Per frame, the luma plane is cut into B x B blocks (``B = trunc(32 *
sqrt(w*h/8294400) + 0.5) * 4``; B < 4 degenerates to plain per-plane SSE).
Each block's visual-activity weight is ``1/sqrt(ms_act^2)``, where
``ms_act`` combines the mean |3x3 Laplacian| over the block's part of the
picture interior (pictures above 2048x1152 use a 2x-downsampled high-pass on
the even grid, skipped for blocks narrower than 13) and, optionally, gamma=2
times the mean |first-order| frame difference (2x2-aggregated on large
pictures), second-order when fps >= 32, with zero for the missing previous
frames.  It is floored at ``2^(depth-6)`` and squared.  Pictures up to
640x480 run the reference's sequential neighbour clamping over the block
raster.  Chroma SSE reuses the luma block weights.  Outputs are the frame
props XPSNR_Y/U/V and the clip average XPSNR_AVG.

The maps are int32 and the block sums int64 (exact, as the JAX package's
f64 sums of exact integers), so ``_XPSNR_WSSE`` equals the JAX package's.
At B = 64 with no downsampling (HD-class pictures, the bench's 1080p) the
luma statistics go through B11 (``kernels.xpsnr.luma_stats``) and chroma
blocks with ``by % 8 == 0`` through B12 (``chroma_sse_uv``, one launch for
U and V); those wrappers run
their kernels on CUDA tensors and their plain versions on CPU tensors.  The
props stay on the planes' device: nothing here reads a value back to the
host except the ``verbose`` line.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import ColorFamily
from ..core.params import VSZipError, compare_clips
from ..core.resample import bit_depth
from ..kernels import xpsnr as kernels
from ..kernels.xpsnr import block_sum, lap_map, prev_frames, temporal_diff
from ..trace import spanned

FILTER_NAME = "XPSNR"
GAMMA = 2

_I32, _F64 = torch.int32, torch.float64


def _block_sum(m, b: int, by: int | None = None):
    """Exact per-block sums of a non-negative int32 map (bx = b, by = b
    unless given), as float64 exact integers."""
    return block_sum(m, b, b if by is None else by).to(_F64)


def _highds_map(x):
    """The >HD downsampled high-pass |f| at even coordinates (zero
    elsewhere).  Taps reach (-2..+3) around each 2x2 cell."""
    n, h, w = x.shape
    xi = torch.nn.functional.pad(x.to(_I32), (3, 4, 3, 4))

    def t(dy, dx):
        return xi[:, 3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w]

    f = (
        12 * (t(0, 0) + t(0, 1) + t(1, 0) + t(1, 1))
        - 3 * (t(-1, 0) + t(-1, 1) + t(2, 0) + t(2, 1))
        - 3 * (t(0, -1) + t(0, 2) + t(1, -1) + t(1, 2))
        - 2 * (t(-1, -1) + t(-1, 2) + t(2, -1) + t(2, 2))
        - (t(-2, -1) + t(-2, 0) + t(-2, 1) + t(-2, 2)
           + t(3, -1) + t(3, 0) + t(3, 1) + t(3, 2)
           + t(-1, -2) + t(0, -2) + t(1, -2) + t(2, -2)
           + t(-1, 3) + t(0, 3) + t(1, 3) + t(2, 3))
    )
    ys = torch.arange(h, device=x.device).view(h, 1)
    xs = torch.arange(w, device=x.device).view(1, w)
    even = (ys % 2 == 0) & (xs % 2 == 0)
    return torch.where(even, f.abs(), 0)


def _cell2_sums(x, p1, p2, order: int):
    """2x2-cell |t| map at even coords; t = cur - p1 (order 1) or
    cur - 2*p1 + p2 (order 2).  p1/p2 are zero-filled shifted frames."""
    t = temporal_diff(x, p1, p2, order)
    cell = t[:, 0::2, 0::2] + t[:, 0::2, 1::2] + t[:, 1::2, 0::2] + t[:, 1::2, 1::2]
    m = torch.zeros(x.shape, dtype=_I32, device=x.device)
    m[:, 0::2, 0::2] = cell.abs()
    return m


def _tempdiff_map(x, p1, p2, order: int):
    return temporal_diff(x, p1, p2, order).abs()


def _smooth_weights(wts, nb_w: int, nb_h: int, b: int, w: int, h: int):
    """The reference's sequential small-picture weight clamping
    (src/filters/xpsnr.zig:450-468); wts (N, nb) f64, every frame at once.
    Only compares and copies values, so it is exact in any order."""
    nb = nb_w * nb_h
    wv = wts.clone()
    zero = torch.zeros_like(wv[:, 0])
    for idx in range(nb):
        col = idx % nb_w
        x = col * b
        prev2 = wv[:, idx - 2] if idx > 1 else zero
        if col == 0:
            map_prev = prev2
        else:
            map_prev = torch.maximum(prev2, wv[:, idx]) if x > b else wv[:, idx]
        if idx > nb_w:
            map_prev = torch.maximum(map_prev, wv[:, idx - 1 - nb_w])
        if idx > 0:
            prev1 = wv[:, idx - 1]
            wv[:, idx - 1] = torch.where(prev1 > map_prev, map_prev, prev1)
        # final-block clamp
        if (idx == nb - 1 and x + b >= w and (nb_h - 1) * b + b >= h
                and idx > nb_w):
            mp2 = torch.maximum(wv[:, idx - 1], wv[:, idx - nb_w])
            cur = wv[:, idx]
            wv[:, idx] = torch.where(cur > mp2, mp2, cur)
    return wv


@lru_cache(maxsize=64)
def _block_consts(w: int, h: int, b: int, b_val: int, device: torch.device):
    """The per-block denominators, (nb_h, nb_w) tensors on `device`: the
    spatial one (1 where the block's active region is empty), the empty
    mask, the >HD narrow-block mask (None at b_val 1) and the temporal one.
    Cached per device: a fresh host-to-device copy would synchronise the
    stream on every call."""
    nb_w, nb_h = -(-w // b), -(-h // b)
    bx0 = np.arange(nb_w) * b
    by0 = np.arange(nb_h) * b
    wax = np.minimum(bx0 + b, w)
    way = np.minimum(by0 + b, h)
    x_lo = np.maximum(bx0, b_val)
    x_hi = np.where(bx0 + b < w, wax, wax - b_val)
    y_lo = np.maximum(by0, b_val)
    y_hi = np.where(by0 + b < h, way, way - b_val)
    nx = np.maximum(x_hi - x_lo, 0).astype(np.float64)
    ny = np.maximum(y_hi - y_lo, 0).astype(np.float64)
    denom_sa = ny[:, None] * nx[None, :]
    empty = denom_sa <= 0
    # highds skipped for narrow blocks (w_act <= 12)
    wide = (np.where(bx0 + b < w, wax - bx0, wax - bx0 - b_val) > 12)[None, :]
    denom_ta = (way - by0).astype(np.float64)[:, None] * (wax - bx0).astype(np.float64)[None, :]

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (on(np.where(empty, 1.0, denom_sa)), on(empty), on(wide) if b_val == 2 else None,
            on(denom_ta))


@lru_cache(maxsize=64)
def _count(n: int, device: torch.device) -> torch.Tensor:
    """n as a 0-dim f64 tensor on `device` (a divisor: CUDA torch divides
    by a host scalar through its reciprocal, which would round differently
    from the CPU)."""
    return torch.tensor(float(n), dtype=_F64, device=device)


def _xpsnr_frame_stats(org, rec, depth: int, frame_rate: int, temporal: bool, dims):
    """Returns wsse per frame and component, (N, num_comps) f64."""
    widths, heights = dims
    w, h = widths[0], heights[0]
    n = org[0].shape[0]
    wh = w * h
    r = wh / (3840.0 * 2160.0)
    b = int(32.0 * math.sqrt(r) + 0.5) * 4  # trunc, like lossyCast
    sft = 1 << (2 * depth - 9)
    avg_act = math.sqrt(16.0 * sft / math.sqrt(max(1e-5, r)))
    num_comps = len(org)

    if b < 4:
        out = []
        for c in range(num_comps):
            d = org[c].to(torch.int64) - rec[c].to(torch.int64)
            out.append((d * d).to(_F64).sum(dim=(1, 2)))
        return torch.stack(out, dim=1)

    b_val = 2 if wh > 2048 * 1152 else 1
    nb_w, nb_h = -(-w // b), -(-h // b)

    order = 2 if frame_rate >= 32 else 1
    use_kernel = b == 64 and b_val == 1
    if use_kernel:
        # B11: maps and exact block sums in one pass
        sse_blk, sa_blk, ta_k = kernels.luma_stats(org[0].contiguous(), rec[0].contiguous(),
                                                   order, temporal)
    else:
        # --- luma block SSE ---
        diff = org[0].to(_I32) - rec[0].to(_I32)
        sse_blk = _block_sum(diff * diff, b)

        # --- spatial activity ---
        ys = torch.arange(h, device=org[0].device).view(h, 1)
        xs = torch.arange(w, device=org[0].device).view(1, w)
        active = (xs >= b_val) & (xs < w - b_val) & (ys >= b_val) & (ys < h - b_val)
        sa_map = _highds_map(org[0]) if b_val == 2 else lap_map(org[0])
        sa_blk = _block_sum(torch.where(active, sa_map, 0), b)

    # per-block active-extent denominators
    denom_sa, empty, wide, denom_ta = _block_consts(w, h, b, b_val, sa_blk.device)
    if wide is not None:
        sa_blk = torch.where(wide, sa_blk, 0.0)
    ms = sa_blk / denom_sa

    # --- temporal activity ---
    if temporal:
        if use_kernel:
            ta_blk = ta_k * GAMMA
        else:
            p1, p2 = prev_frames(org[0], 1), prev_frames(org[0], 2)
            # frame 1 has p1 but no p2; frame 0 has neither — zero fills
            ta_map = (_cell2_sums(org[0], p1, p2, order) if b_val == 2
                      else _tempdiff_map(org[0], p1, p2, order))
            ta_blk = _block_sum(ta_map, b) * GAMMA
        ms = ms + ta_blk / denom_ta

    floor = float(1 << (depth - 6))
    ms = torch.clamp(ms, min=floor)
    weights = 1.0 / torch.sqrt(ms * ms)
    # empty active region -> ms_act stays 1.0 unsquared (reference early out)
    weights = torch.where(empty, 1.0, weights)

    if wh <= 640 * 480:
        weights = _smooth_weights(weights.reshape(n, -1), nb_w, nb_h, b, w, h).reshape(
            n, nb_h, nb_w)

    s = (sse_blk * weights).sum(dim=(1, 2))
    wsse = [torch.where(s <= 0.0, 0.0, torch.trunc(torch.clamp(s, min=0.0) * avg_act + 0.5))]

    # U and V share a shape, so their blocks (rectangular for 422/440) are
    # one size, and B12 takes both planes in one launch
    bx = (b * widths[1]) // w
    by = (b * heights[1]) // h
    if use_kernel and by % 8 == 0:
        chroma = kernels.chroma_sse_uv(org[1].contiguous(), rec[1].contiguous(),
                                       org[2].contiguous(), rec[2].contiguous(), by, bx)
    else:
        chroma = []
        for c in range(1, num_comps):
            dc = org[c].to(_I32) - rec[c].to(_I32)
            chroma.append(_block_sum(dc * dc, bx, by))
    for blk in chroma:
        s = (blk * weights).sum(dim=(1, 2))
        wsse.append(torch.where(s <= 0.0, 0.0, torch.trunc(s * avg_act + 0.5)))

    return torch.stack(wsse, dim=1)


@spanned("vszip.op.xpsnr")
def xpsnr(reference: Clip, distorted: Clip, temporal: bool = True,
          verbose: bool = False, fps: float | None = None) -> Clip:
    """``verbose=True`` prints the reference's end-of-run summary line
    (src/vapoursynth/xpsnr.zig:110-128 prints it on filter free; here the
    whole clip is processed in one call, so it prints before returning).
    ``fps`` overrides the _FpsNum/_FpsDen frame props.

    The output also carries ``_XPSNR_WSSE`` (per-frame wsse, (N, C) f64) and
    ``_XPSNR_Num64`` (the per-component normalizer, (C,) f64): the state a
    chunked run needs to recompute the clip average from totals; they are
    not part of the reference's public prop surface."""
    fmt = reference.format
    if fmt.color_family is not ColorFamily.YUV:
        raise VSZipError(f"{FILTER_NAME} : only supports YUV format clips")
    if fmt.bits_per_sample not in (8, 10):
        raise VSZipError(f"{FILTER_NAME} : only supports 8 or 10 bit clips")
    if reference.width % 2 or reference.height % 2:
        raise VSZipError(f"{FILTER_NAME} : only supports even width and height")

    ref, dist = reference, distorted
    b1, b2 = ref.format.bits_per_sample, dist.format.bits_per_sample
    if b1 < b2:
        ref = _promote(ref, b2)
    elif b1 > b2:
        dist = _promote(dist, b1)
    compare_clips([ref, dist], FILTER_NAME, same_len=True)

    depth = ref.format.bits_per_sample
    if fps is None:
        num = ref.props.get("_FpsNum", dist.props.get("_FpsNum", 0))
        den = ref.props.get("_FpsDen", dist.props.get("_FpsDen", 1))
        frame_rate = int(num) // int(den) if den else 0
    else:
        frame_rate = int(fps)

    widths = tuple(ref.plane_dims(p)[0] for p in range(ref.format.num_planes))
    heights = tuple(ref.plane_dims(p)[1] for p in range(ref.format.num_planes))
    wsse = _xpsnr_frame_stats(tuple(ref.planes), tuple(dist.planes), depth, frame_rate,
                              bool(temporal), (widths, heights))
    num64 = _num64_const(widths, heights, depth, wsse.shape[1], wsse.device)
    cur, avg = _prop_math(wsse, num64)
    names = ["XPSNR_Y", "XPSNR_U", "XPSNR_V"]
    props = {names[c]: cur[:, c] for c in range(wsse.shape[1])}
    props["XPSNR_AVG"] = avg
    props["_XPSNR_WSSE"] = wsse
    props["_XPSNR_Num64"] = num64
    if verbose:
        av = avg.cpu().numpy()
        comps = "".join(f"{c}: {float(av[i]):.4f}  "
                        for i, c in enumerate("yuv"[: wsse.shape[1]]))
        print(f"XPSNR average, {int(wsse.shape[0])} frames  {comps}", flush=True)
    return distorted.with_props(**props)


@lru_cache(maxsize=64)
def _num64_const(widths, heights, depth: int, ncomp: int, device: torch.device):
    """(C,) per-component width*height*max_err normalizer, cached per
    device so that a call makes no host-to-device copy for it."""
    max_err = float(((1 << depth) - 1) ** 2)
    return torch.tensor([float(widths[c]) * heights[c] * max_err for c in range(ncomp)],
                        dtype=_F64, device=device)


def _prop_math(wsse, num64):
    """Per-frame XPSNR per component and the end-of-run aggregate (the
    reference prints it on free), on the device, in f64."""
    n = wsse.shape[0]
    nd = _count(n, wsse.device)
    sq = torch.sqrt(wsse)  # (N, C)
    sum_wdist = sq.sum(dim=0)
    cur = torch.where(sq < 1.0, math.inf,
                      10.0 * torch.log10(num64.view(1, -1) / torch.clamp(sq, min=1.0) ** 2))
    ad = torch.clamp(sum_wdist / nd, min=1e-300)
    avg = torch.where(sum_wdist >= n, 10.0 * torch.log10(num64 / (ad * ad)),
                      cur.sum(dim=0) / nd)
    return cur, avg


def _promote(clip: Clip, bits: int) -> Clip:
    # depth matching via the shared bitDepth analogue (reference
    # src/vapoursynth/xpsnr.zig:165-169 invokes helper.zig bitDepth)
    return bit_depth(clip, bits)
