"""Deband: f3kdb-style debanding (neo_f3kdb-compatible), 7 sample modes.

The PyTorch counterpart of ``vszip_tpu.ops.deband``, with the same
arguments, validation messages, create-time state and arithmetic.
Reference: src/vapoursynth/deband.zig (create-time state incl. the exact
neo RNG consumption order and the i8 refEncode wrap quirk, generated by the
native library in runtime/native/deband_rng.cpp), src/filters/deband_int.zig
and src/filters/deband_float.zig (per-pixel kernels):

* refs: r1 = src[p + ref1], r3 = src[p - ref1]; modes other than 1/3 also
  r2 = src[p + ref2], r4 = src[p - ref2] (the float path's abs(ref2) only
  swaps r2/r4, which every mode treats symmetrically).
* m1/m3: rounded pair average gated by thr.  m2: neo's SIMD avg_4 pairing
  ((r1,r3),(r2,r4)) with the decrement-if-positive quirk (int) / plain mean
  (float).  m4: independent v/h averages, then rounded mean.  m5: flat
  (sum>>2) average with avg/max/mid threshold gates (32-bit diffs).  m6/m7:
  soft blend with factor pow(product_of_gates, 0.1); m7 boosts thresholds
  where the Sobel gradient angle (distance-20 taps, clamped; angle =
  atan(gy/gx)/pi + 0.5, 1.0 where |gx| < 0.03) is stable across the ref
  offsets.
* grain: per-pixel additive grain from the precomputed buffer, indexed by
  row-major position at a 64-byte-aligned virtual stride; dynamic grain
  offsets the buffer per frame.

Int clips below 16 bits are promoted to the 16-bit internal depth by shift
and demoted afterwards with zimg's error diffusion (runtime/dither.py), on
the host, one frame at a time, as the JAX package does.  pow/atan are the
reference's VCL2 polynomial kernels (ops/vcl.py).

Dispatch for an int plane (the kernels take CPU tensors through their plain
versions, CUDA tensors through the kernels in csrc/deband.cu):
* modes 1, 3, 4, 5, 6 with range < 128: ``kernels.deband_center`` (B5);
* mode 2 with symmetric subsampling (ref2 = (-val1, val2)), any range:
  ``kernels.deband_m2_center`` (B6);
* everything else (float planes, m7, m2 on 4:2:2 chroma, range >= 128 for
  modes other than 2) runs plain torch gathers and ``_mode_center`` on the
  plane's device.
"""

from __future__ import annotations

import builtins
from functools import lru_cache

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import ColorFamily, SampleType
from ..core.params import VSZipError, get_array, get_value
from ..kernels import deband as kernels
from ..runtime.deband_rng import deband_precompute
from ..trace import spanned

FILTER_NAME = "Deband"


@lru_cache(maxsize=8)
def _precompute(w, h, n, seed, sample_mode, range_, ssw, ssh, algo_ref,
                algo_grain, param_ref, param_grain, is_float, dynamic,
                agy, agc, gy, gc):
    return deband_precompute(w, h, n, seed, sample_mode, range_, ssw, ssh,
                             algo_ref, algo_grain, param_ref, param_grain,
                             is_float, dynamic, agy, agc, gy, gc)


@lru_cache(maxsize=8)
def _precompute_device(w, h, n, seed, sample_mode, range_, ssw, ssh, algo_ref,
                       algo_grain, param_ref, param_grain, is_float, dynamic,
                       agy, agc, gy, gc, y_vstride, c_vstride, device):
    """Device-resident create-time state, placed once per parameter set and
    device: the ref-offset maps are ~25 MB at 1080p.  Grain offsets stay on
    the host as ints (they slice the grain buffer per frame)."""
    pre = _precompute(w, h, n, seed, sample_mode, range_, ssw, ssh, algo_ref,
                      algo_grain, param_ref, param_grain, is_float, dynamic,
                      agy, agc, gy, gc)
    if is_float:
        # The reference's FLOAT kernel reads ref2 through @abs of the flat
        # stride-baked offset (deband_float.zig:159 `@abs(ref2_row[x+i])`),
        # unlike the int kernel which reads it raw (deband_int.zig:167).
        # For sample_mode 2 with val1>=1 the flat offset is negative, so the
        # abs SWAPS the r2/r4 pixels, which changes the f32 summation order
        # (r1+r2)+r3)+r4 and flips exact-tie threshold pixels.  Negate the
        # (dy,dx) decomposition wherever the flat offset is negative.  Safe
        # for mode 7's angle lookups: they use ±dx symmetrically.
        pre = dict(pre)
        for pref, vs in (("", y_vstride), ("c_", c_vstride)):
            dy, dx = pre[pref + "ref2_dy"], pre[pref + "ref2_dx"]
            neg = dy.astype(np.int64) * vs + dx < 0
            pre[pref + "ref2_dy"] = np.where(neg, -dy, dy).astype(dy.dtype)
            pre[pref + "ref2_dx"] = np.where(neg, -dx, dx).astype(dx.dtype)
    dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in pre.items() if k.endswith(("_dy", "_dx"))}
    offs = [int(o) for o in pre["grain_offsets"][:n]] if dynamic else [0] * n
    max_off = max(offs, default=0)
    for key, vs, hh in (("grain_y", y_vstride, h),
                        ("grain_c", c_vstride, h >> ssh)):
        buf = pre[key]
        need = max_off + hh * vs
        if len(buf) < need:  # pad so every frame's window is in bounds
            buf = np.concatenate([buf, np.zeros(need - len(buf), buf.dtype)])
        dev[key] = torch.from_numpy(buf).to(device)
    dev["grain_offsets"] = tuple(offs)
    return dev


def _angle_plane(srcf: torch.Tensor) -> torch.Tensor:
    """Gradient angle at every coordinate in [-128, dim+127] (Sobel with
    distance-20 clamped taps)."""
    from .vcl import atan

    n, h, w = srcf.shape
    pad = 148  # 128 offset range + 20 tap distance
    dev = srcf.device
    iy = torch.arange(-pad, h + pad, device=dev).clamp(0, h - 1)
    ix = torch.arange(-pad, w + pad, device=dev).clamp(0, w - 1)
    p = srcf.index_select(1, iy).index_select(2, ix)  # edge padding
    hh, ww = h + 256, w + 256

    def tap(dy, dx):
        y0, x0 = pad + dy - 128, pad + dx - 128
        return p[:, y0:y0 + hh, x0:x0 + ww]

    d = 20
    p00, p10, p20 = tap(-d, -d), tap(-d, 0), tap(-d, d)
    p01, p21 = tap(0, -d), tap(0, d)
    p02, p12, p22 = tap(d, -d), tap(d, 0), tap(d, d)
    gx = (p20 + 2.0 * p21 + p22) - (p00 + 2.0 * p01 + p02)
    gy = (p00 + 2.0 * p10 + p20) - (p02 + 2.0 * p12 + p22)
    # a device tensor divisor: CUDA torch divides by a host scalar through
    # its reciprocal, which would round differently
    pi = torch.tensor(np.float32(np.pi), device=dev)
    ang = atan(gy / gx) / pi + 0.5
    return torch.where(gx.abs() < float(np.float32(0.03)), torch.ones_like(ang), ang)


def _angle_lookup(ang: torch.Tensor, dy, dx) -> torch.Tensor:
    """ang is the (+256)-padded plane; lookup at (y+dy, x+dx), which stays
    inside the padding for offsets in [-128, 127]."""
    n = ang.shape[0]
    h, w = ang.shape[1] - 256, ang.shape[2] - 256
    dev = ang.device
    yy = torch.arange(h, device=dev, dtype=torch.int64).view(h, 1) + dy + 128
    xx = torch.arange(w, device=dev, dtype=torch.int64).view(1, w) + dx + 128
    flat = (yy * (w + 256) + xx).expand(h, w).reshape(-1)
    return ang.reshape(n, -1).index_select(1, flat).view(n, h, w)


def _mode_center(mode: int, blur_first: bool, is_int: bool,
                 c, r1, r3, r2, r4, thr, thr1, thr2, t_planes=None):
    """Per-mode center arithmetic on already-resolved taps (reference
    src/filters/deband_int.zig:93-340 / deband_float.zig), shared by the
    plain path and the kernels' plain versions.  For modes 6/7 `t_planes`
    may supply per-pixel (t_avg, t_max, t_mid) threshold planes (m7's angle
    boost); otherwise the scalar thresholds broadcast."""
    if not is_int:
        thr, thr1, thr2 = (float(np.float32(t)) for t in (thr, thr1, thr2))

    if mode in (1, 3):
        avg = ((r1 + r3 + 1) >> 1) if is_int else ((r1 + r3) * 0.5)
        if blur_first:
            use_orig = (avg - c).abs() >= thr
        else:
            use_orig = ((r1 - c).abs() >= thr) | ((r3 - c).abs() >= thr)
        return torch.where(use_orig, c, avg)
    if mode == 2:
        if is_int:
            # neo's SIMD avg_4: pairs (r1,r3), (r2,r4), first average
            # decremented when positive
            avg1 = (r1 + r3 + 1) >> 1
            avg2 = (r2 + r4 + 1) >> 1
            avg1 = avg1 - (avg1 > 0).to(torch.int32)
            avg = (avg1 + avg2 + 1) >> 1
        else:
            avg = (r1 + r2 + r3 + r4) * 0.25
        if blur_first:
            use_orig = (avg - c).abs() >= thr
        else:
            use_orig = (((r1 - c).abs() >= thr) | ((r2 - c).abs() >= thr)
                        | ((r3 - c).abs() >= thr) | ((r4 - c).abs() >= thr))
        return torch.where(use_orig, c, avg)
    if mode == 4:
        if is_int:
            avg_v = (r1 + r3 + 1) >> 1
            avg_h = (r2 + r4 + 1) >> 1
        else:
            avg_v = (r1 + r3) * 0.5
            avg_h = (r2 + r4) * 0.5
        if blur_first:
            uo_v = (avg_v - c).abs() >= thr
            uo_h = (avg_h - c).abs() >= thr
        else:
            uo_v = ((r1 - c).abs() >= thr) | ((r3 - c).abs() >= thr)
            uo_h = ((r2 - c).abs() >= thr) | ((r4 - c).abs() >= thr)
        dv = torch.where(uo_v, c, avg_v)
        dh = torch.where(uo_h, c, avg_h)
        return ((dv + dh + 1) >> 1) if is_int else ((dv + dh) * 0.5)
    if mode == 5:
        avg = ((r1 + r3 + r2 + r4) >> 2) if is_int else ((r1 + r2 + r3 + r4) * 0.25)
        avg_dif = (avg - c).abs()
        max_dif = torch.maximum(torch.maximum((r1 - c).abs(), (r3 - c).abs()),
                                torch.maximum((r2 - c).abs(), (r4 - c).abs()))
        two_src = (c << 1) if is_int else (c * 2.0)
        mid1 = ((r1 + r3) - two_src).abs()
        mid2 = ((r2 + r4) - two_src).abs()
        use_orig = (avg_dif >= thr) | (max_dif >= thr1) | (mid1 >= thr2) | (mid2 >= thr2)
        return torch.where(use_orig, c, avg)

    # m6 / m7 soft blend
    from .vcl import pow_

    dev = c.device
    eps = np.float32(1e-5)
    if t_planes is None:
        # 0-dim device tensors: CUDA torch divides by a host scalar through
        # its reciprocal, which would round differently from the kernel
        t_avg, t_max, t_mid = (torch.tensor(max(np.float32(t), eps), device=dev)
                               for t in (thr, thr1, thr2))
    else:
        t_avg, t_max, t_mid = (t.clamp(min=float(eps)) for t in t_planes)
    cf = c.to(torch.float32)
    p1, p2 = r1.to(torch.float32), r3.to(torch.float32)
    p3, p4 = r2.to(torch.float32), r4.to(torch.float32)
    avg_refs = (p1 + p2 + p3 + p4) * 0.25
    diff = avg_refs - cf

    def comp(dif, t):
        return (3.0 * (1.0 - dif / t)).clamp(0.0, 1.0)

    max_dif = torch.maximum(torch.maximum((p1 - cf).abs(), (p2 - cf).abs()),
                            torch.maximum((p3 - cf).abs(), (p4 - cf).abs()))
    two_src = cf * 2.0
    product = (comp(diff.abs(), t_avg) * comp(max_dif, t_max)
               * comp(((p1 + p2) - two_src).abs(), t_mid)
               * comp(((p3 + p4) - two_src).abs(), t_mid))
    blended = cf + diff * pow_(product, 0.1)
    if is_int:
        return torch.trunc(blended + 0.5).to(torch.int32)
    return blended


def _deband_plane(x, r1dy, r1dx, r2dy, r2dx, grain_buf, grain_off,
                  mode: int, blur_first: bool, add_grain: bool, is_int: bool,
                  thr3, pix_range, boost, vstride: int, rmax: int,
                  m2_sym: bool = False):
    acc = torch.int32 if is_int else torch.float32
    # Separable modes (everything but m2, and any range small enough that
    # the refEncode -128 wrap can't appear) draw their taps along one axis
    # from one magnitude plane.
    separable = mode != 2 and rmax < 128

    if separable and is_int and mode in kernels.SEPARABLE_MODES:
        center = kernels.deband_center(x, r1dy + r1dx, mode, blur_first, rmax, thr3)
    elif mode == 2 and is_int and m2_sym:
        # val1 = ref1_dx, val2 = ref1_dy; ref2 = (-val1, val2) exactly when
        # the plane's subsampling is symmetric
        key = (r1dx + rmax) * (2 * rmax + 1) + (r1dy + rmax)
        center = kernels.deband_m2_center(x, key, blur_first, rmax, thr3[0])
    else:
        center = _plain_center(x, r1dy, r1dx, r2dy, r2dx, mode, blur_first, is_int,
                               thr3, boost, separable)
    return _deband_tail(center, grain_buf, grain_off, add_grain, acc,
                        pix_range, vstride, x.dtype)


def _plain_center(x, r1dy, r1dx, r2dy, r2dx, mode, blur_first, is_int, thr3,
                  boost, separable):
    """The centre through plain torch gathers, on the plane's device."""
    thr, thr1, thr2 = thr3
    angle_boost, max_angle = boost
    c = x.to(torch.int32 if is_int else torch.float32)
    if separable:
        vmap = r1dy + r1dx  # exactly one of the two holds val1
        r1, r3, r2, r4 = kernels.sep_taps(c, vmap, mode)
    else:
        r1, r3 = kernels.gather(c, r1dy, r1dx), kernels.gather(c, -r1dy, -r1dx)
        r2 = r4 = c
        if mode not in (1, 3):
            r2, r4 = kernels.gather(c, r2dy, r2dx), kernels.gather(c, -r2dy, -r2dx)

    t_planes = None
    if mode == 7:
        ang = _angle_plane(x.to(torch.float32))
        a_org = ang[:, 128:-128, 128:-128]
        if separable:
            # offsets along one axis at ±vmap (vmap in [0, range])
            a1h, a2h = _angle_lookup(ang, vmap, 0), _angle_lookup(ang, -vmap, 0)
            a1w, a2w = _angle_lookup(ang, 0, vmap), _angle_lookup(ang, 0, -vmap)
        else:
            a1h, a2h = _angle_lookup(ang, r1dy, 0), _angle_lookup(ang, -r1dy, 0)
            a1w, a2w = _angle_lookup(ang, 0, r2dx), _angle_lookup(ang, 0, -r2dx)
        mad = torch.maximum((a1h - a_org).abs(), (a2h - a_org).abs())
        mad = torch.maximum(mad, torch.maximum((a1w - a_org).abs(), (a2w - a_org).abs()))
        boostm = mad <= float(np.float32(max_angle))
        ab = np.float32(angle_boost)
        t_planes = tuple(torch.where(boostm, float(np.float32(t) * ab),
                                     float(np.float32(t))).to(torch.float32)
                         for t in (thr, thr1, thr2))
    return _mode_center(mode, blur_first, is_int, c, r1, r3, r2, r4,
                        thr, thr1, thr2, t_planes=t_planes)


def _deband_tail(center, grain_buf, grain_off, add_grain: bool, acc,
                 pix_range, vstride: int, out_dtype):
    n, h, w = center.shape
    if add_grain:
        # grain index = y*vstride + x + off[frame]: one contiguous window of
        # the (padded) buffer per frame
        size = h * vstride
        if any(grain_off):
            seg = torch.stack([grain_buf.narrow(0, o, size) for o in grain_off])
        else:
            seg = grain_buf[:size].unsqueeze(0)
        gvals = seg.view(-1, h, vstride)[:, :, :w]
        center = center + gvals.to(acc)
    lo, hi = pix_range
    if acc == torch.float32:
        lo, hi = float(np.float32(lo)), float(np.float32(hi))
    return center.clamp(lo, hi).to(out_dtype)


@spanned("vszip.op.deband")
def deband(clip: Clip, range=15, thr=None, thr1=None, thr2=None, grain=None,
           sample_mode: int = 2, seed: int = 0, blur_first: bool = True,
           dynamic_grain: bool = False, keep_tv_range: bool = False,
           random_algo_ref: int = 1, random_algo_grain: int = 1,
           random_param_ref: float = 1.0, random_param_grain: float = 1.0,
           angle_boost: float = 1.5, max_angle: float = 0.15) -> Clip:
    """vszip.Deband equivalent (reference src/vapoursynth/deband.zig)."""
    fmt = clip.format
    if fmt.sample_type is SampleType.FLOAT and fmt.bits_per_sample != 32:
        raise VSZipError(
            f"{FILTER_NAME}: only 32-bit format is supported when float clip"
        )
    if fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 32:
        raise VSZipError(f"{FILTER_NAME}: not supported Int format.")

    thr_in = get_array(thr, "thr", 0.99, 0.0, 255.0, FILTER_NAME)
    thr1_in = get_array(thr1, "thr1", thr_in, 0.0, 255.0, FILTER_NAME)
    thr2_in = get_array(thr2, "thr2", thr_in, 0.0, 255.0, FILTER_NAME)
    grain_in = get_array(grain, "grain", 0.0, 0.0, 127.0, FILTER_NAME, max_len=2)
    sample_mode = get_value(sample_mode, "sample_mode", 2, 1, 7, FILTER_NAME)
    range_ = get_value(range, "range", 15, 0, 255, FILTER_NAME)
    seed = get_value(seed, "seed", 0, -(2**31), 2**31 - 1, FILTER_NAME)
    angle_boost = get_value(angle_boost, "angle_boost", 1.5, 0, 65535, FILTER_NAME)
    max_angle = get_value(max_angle, "max_angle", 0.15, 0, 1, FILTER_NAME)
    random_param_ref = get_value(random_param_ref, "random_param_ref", 1.0, 0, 255, FILTER_NAME)
    random_param_grain = get_value(random_param_grain, "random_param_grain", 1.0, 0, 255, FILTER_NAME)
    random_algo_ref = get_value(random_algo_ref, "random_algo_ref", 1, 0, 2, FILTER_NAME)
    random_algo_grain = get_value(random_algo_grain, "random_algo_grain", 1, 0, 2, FILTER_NAME)

    is_int = fmt.sample_type is SampleType.INTEGER
    src_bits = fmt.bits_per_sample
    shift = 16 - src_bits if (is_int and src_bits < 16) else 0
    yuv = fmt.color_family is ColorFamily.YUV

    # 16-bit-internal scaled params (reference Data.scaleValue)
    if is_int:
        t = [int(np.trunc(v * 65535.0 / 255.0 + 0.5)) for v in thr_in]
        t1 = [int(np.trunc(v * 65535.0 / 255.0 + 0.5)) for v in thr1_in]
        t2 = [int(np.trunc(v * 65535.0 / 255.0 + 0.5)) for v in thr2_in]
        g = [int(np.trunc(v * 65535.0 / 255.0 + 0.5)) for v in grain_in]
    else:
        t = [np.float32(v / 255.0) for v in thr_in]
        t1 = [np.float32(v / 255.0) for v in thr1_in]
        t2 = [np.float32(v / 255.0) for v in thr2_in]
        g = [np.float32(v / 255.0) for v in grain_in]

    add_grain = [grain_in[min(i, 1)] > 0 for i in builtins.range(3)]
    dynamic_grain = bool(dynamic_grain) and (grain_in[0] > 0 or grain_in[1] > 0)

    if is_int:
        if keep_tv_range and yuv:
            pmin = [16 << 8] * 3
            pmax = [235 << 8, 240 << 8, 240 << 8]
        else:
            pmin = [0] * 3
            pmax = [65535] * 3
    else:
        if yuv:
            pmin = [0.0, -0.5, -0.5]
            pmax = [1.0, 0.5, 0.5]
        else:
            pmin = [0.0] * 3
            pmax = [1.0] * 3

    nf = clip.num_frames
    # VS frame rows align to 32 bytes on the reference goldens' machine
    # (64 only under AVX-512 CPUID, reference src/helper.zig:496-563).
    align = 16 if is_int else 8
    y_vstride = (clip.width + align - 1) & ~(align - 1)
    c_vstride = ((clip.width >> fmt.subsampling_w) + align - 1) & ~(align - 1)
    pre = _precompute_device(
        clip.width, clip.height, nf, int(seed), int(sample_mode),
        int(range_), fmt.subsampling_w, fmt.subsampling_h,
        int(random_algo_ref), int(random_algo_grain), float(random_param_ref),
        float(random_param_grain), not is_int, dynamic_grain,
        add_grain[0], add_grain[1], g[0], g[1], y_vstride, c_vstride,
        str(clip.planes[0].device),
    )
    goff = pre["grain_offsets"]

    out = []
    for p in builtins.range(fmt.num_planes):
        x = clip.planes[p]
        if shift:
            x = (x.to(torch.int32) << shift).to(torch.uint16)
        x = x.contiguous()
        pref = "c_" if p > 0 else ""
        y16 = _deband_plane(
            x, pre[pref + "ref1_dy"], pre[pref + "ref1_dx"],
            pre[pref + "ref2_dy"], pre[pref + "ref2_dx"],
            pre["grain_c" if p > 0 else "grain_y"], goff,
            int(sample_mode), bool(blur_first), add_grain[p], is_int,
            (t[p], t1[p], t2[p]), (pmin[p], pmax[p]),
            (float(angle_boost), float(max_angle)),
            c_vstride if p > 0 else y_vstride, int(range_),
            p == 0 or fmt.subsampling_w == fmt.subsampling_h,
        )
        if shift:
            # zimg-exact Floyd-Steinberg error-diffusion demote back to the
            # source depth (reference src/vapoursynth/deband.zig:492-497),
            # on the host, one frame at a time
            from ..runtime.dither import error_diffusion_demote

            peak_lo = (1 << src_bits) - 1
            arr = y16.cpu().numpy()
            frames = [error_diffusion_demote(arr[i], 1.0 / (1 << shift), peak_lo)
                      for i in builtins.range(arr.shape[0])]
            y16 = torch.from_numpy(np.stack(frames)).to(
                device=clip.planes[p].device, dtype=clip.planes[p].dtype)
        out.append(y16)
    return clip.with_planes(out)
