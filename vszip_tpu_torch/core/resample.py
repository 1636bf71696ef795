"""Format conversion: the port of ``vszip_tpu.core.resample`` (the analogue
of the reference's Resize-plugin invocations: ``toRGBS`` in
src/helper.zig:225-243, ``bitDepth`` in src/helper.zig:470-494 and
``sRGBtoLinearRGB`` in src/vapoursynth/ssimulacra2.zig:132-162).

Plain PyTorch (the JAX package has no Pallas kernel here), on whatever device
the clip's planes lie on.  The zimg filter coefficients are computed on the
host in NumPy, by functions copied as they are.  Integer resizes run zimg's Q14 fixed point in int32 and equal the
JAX package bit for bit; float paths round every product and sum on its own
(eager torch does not contract ``a*b + c``), where XLA:CPU's jit may form
FMAs, so float planes agree within rtol 2e-6 / atol 1e-6.

Two traps of torch on the card are avoided on purpose: a float tensor divided
by a host scalar is computed through the scalar's reciprocal, so every
division here is by a 0-dim tensor on the plane's device (IEEE division, as
on the CPU); and ``_plane_to_float`` multiplies by ``f32(1/range)``
explicitly, as zimg does.  The float ``resize`` is a plain matrix product
(``torch.matmul``), which torch runs in full f32 on the card by default
(``torch.backends.cuda.matmul.allow_tf32`` is False); nothing in the port
turns TF32 on.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .clip import Clip
from .format import ColorFamily, SampleType, get_format
from .params import VSZipError

# matrix coefficients: (Kr, Kb)
_MATRICES = {1: (0.2126, 0.0722), 6: (0.299, 0.114)}  # 709, 601
_F32 = torch.float32
_I32 = torch.int32


def _f32(v) -> float:
    """A constant rounded to float32 once (NumPy), as the JAX package's
    ``jnp.float32(v)``."""
    return float(np.float32(v))


@lru_cache(maxsize=64)
def _scalar(v: float, device: torch.device) -> torch.Tensor:
    """A 0-dim f32 tensor on `device`: dividing by it is IEEE division on
    the card too.  Cached, like every device constant here: a fresh
    host-to-device copy would synchronise the stream on every call."""
    return torch.tensor(_f32(v), dtype=_F32, device=device)


@lru_cache(maxsize=256)
def _on(key, device: torch.device) -> torch.Tensor:
    """The host array ``key[0](*key[1:])`` as a cached tensor on `device`."""
    fn, *args = key
    return torch.from_numpy(np.ascontiguousarray(fn(*args))).to(device)


def _plane_to_float(x, fmt, chroma: bool):
    """zimg integer->float depth conversion: (x - lo) * f32(1/range)
    (reciprocal multiply, matching zimg's AVX2 depth kernels)."""
    if fmt.sample_type is SampleType.FLOAT:
        return x.to(_F32)
    sh = fmt.bits_per_sample - 8
    if chroma:
        lo, rng = 128 << sh, 224 << sh
    else:
        lo, rng = 16 << sh, 219 << sh
    return (x.to(_F32) - _f32(lo)) * _f32(1.0 / rng)


def _bicubic(x: float, b: float = 0.0, c: float = 0.5) -> float:
    """zimg's BicubicFilter polynomial (VS resize.Bicubic default b=0 c=0.5)."""
    x = abs(x)
    if x < 1.0:
        p0 = (6.0 - 2.0 * b) / 6.0
        p2 = (-18.0 + 12.0 * b + 6.0 * c) / 6.0
        p3 = (12.0 - 9.0 * b - 6.0 * c) / 6.0
        return p0 + p2 * x * x + p3 * x * x * x
    if x < 2.0:
        q0 = (8.0 * b + 24.0 * c) / 6.0
        q1 = (-12.0 * b - 48.0 * c) / 6.0
        q2 = (6.0 * b + 30.0 * c) / 6.0
        q3 = (-b - 6.0 * c) / 6.0
        return q0 + q1 * x + q2 * x * x + q3 * x * x * x
    return 0.0


def _kernel_fn(kind: str, b: float, c: float):
    """(pointwise kernel fn, support) for a zimg resample filter."""
    if kind == "point":
        return (lambda x: 1.0), 0.0
    if kind == "bilinear":
        return (lambda x: max(1.0 - abs(x), 0.0)), 1.0
    if kind == "bicubic":
        return (lambda x: _bicubic(x, b, c)), 2.0
    raise VSZipError(f"resize: unknown kernel '{kind}'.")


@lru_cache(maxsize=64)
def _zimg_weight_matrix(src_dim: int, dst_dim: int, shift: float,
                        kind: str = "bicubic", b: float = 0.0,
                        c: float = 0.5) -> np.ndarray:
    """(dst, src) f32 resize matrix, zimg compute_filter semantics:
    pos = (i+0.5)/scale + shift, double-precision weights, mirror folding
    at the edges, normalization by the in-window sum."""
    fn, support = _kernel_fn(kind, b, c)
    scale = dst_dim / src_dim
    step = min(scale, 1.0)
    filter_size = max(int(math.ceil(support / step)) * 2, 1)
    m = np.zeros((dst_dim, src_dim), np.float64)
    for i in range(dst_dim):
        pos = (i + 0.5) / scale + shift
        begin_pos = (math.floor(pos - filter_size / 2.0 + 0.5)
                     if pos - filter_size / 2.0 >= 0
                     else math.ceil(pos - filter_size / 2.0 - 0.5)) + 0.5
        total = sum(fn((begin_pos + j - pos) * step)
                    for j in range(filter_size))
        for j in range(filter_size):
            xpos = begin_pos + j
            if xpos < 0.0:
                real_pos = -xpos
            elif xpos >= src_dim:
                real_pos = min(2.0 * src_dim - xpos, src_dim - 0.5)
            else:
                real_pos = xpos
            m[i, int(math.floor(real_pos))] += fn((xpos - pos) * step) / total
    return m.astype(np.float32)


@lru_cache(maxsize=64)
def _zimg_filter_taps(src_dim: int, dst_dim: int, shift: float,
                      kind: str = "bicubic", b: float = 0.0, c: float = 0.5):
    """(left int64[dst], w float64[dst, filter_size]) — the taps form of
    _zimg_weight_matrix (zimg FilterContext layout: per output pixel a
    window start and filter_size coefficients, edge weights mirror-folded
    into in-window entries)."""
    fn, support = _kernel_fn(kind, b, c)
    scale = dst_dim / src_dim
    step = min(scale, 1.0)
    filter_size = min(max(int(math.ceil(support / step)) * 2, 1), src_dim)
    left = np.empty(dst_dim, np.int64)
    weights = np.zeros((dst_dim, filter_size), np.float64)
    for i in range(dst_dim):
        pos = (i + 0.5) / scale + shift
        fs = max(int(math.ceil(support / step)) * 2, 1)
        begin_pos = (math.floor(pos - fs / 2.0 + 0.5)
                     if pos - fs / 2.0 >= 0
                     else math.ceil(pos - fs / 2.0 - 0.5)) + 0.5
        total = sum(fn((begin_pos + j - pos) * step) for j in range(fs))
        acc: dict[int, float] = {}
        for j in range(fs):
            xpos = begin_pos + j
            if xpos < 0.0:
                real_pos = -xpos
            elif xpos >= src_dim:
                real_pos = min(2.0 * src_dim - xpos, src_dim - 0.5)
            else:
                real_pos = xpos
            idx = int(math.floor(real_pos))
            acc[idx] = acc.get(idx, 0.0) + fn((xpos - pos) * step) / total
        lo = min(acc)
        lo = min(lo, src_dim - filter_size) if src_dim >= filter_size else 0
        lo = max(lo, 0)
        left[i] = lo
        for idx, wv in acc.items():
            weights[i, idx - lo] += wv
    return left, weights


@lru_cache(maxsize=64)
def _zimg_filter_q14(src_dim: int, dst_dim: int, shift: float,
                     kind: str = "bicubic", b: float = 0.0, c: float = 0.5):
    """(left int64[dst], q int32[dst, taps]): the Q14 fixed-point
    quantization zimg applies for integer pixel resizing — per-row error
    feedback, round-half-even (lrint), coefficients * 2^14.  Each row sums
    to exactly 16384, so the unsigned accumulate below is bit-identical to
    zimg's INT16_MIN-biased SIMD form."""
    left, w = _zimg_filter_taps(src_dim, dst_dim, shift, kind, b, c)
    q = np.zeros(w.shape, np.int32)
    for i in range(w.shape[0]):
        err = 0.0
        for k in range(w.shape[1]):
            f = w[i, k] * 16384.0 + err
            qv = int(np.rint(f))
            err = f - qv
            q[i, k] = qv
    return left, q


def _tap_index(filt, k: int, src_dim: int, *args):
    """Clamped window index ``left + k`` of every output position."""
    return np.clip(filt(src_dim, *args)[0] + k, 0, src_dim - 1)


def _tap_weights(ndim: int, axis: int, f32: bool, filt, k: int, src_dim: int, *args):
    """Column k of the filter's coefficients, shaped to broadcast along
    `axis` (f32-rounded for the float ladder)."""
    v = filt(src_dim, *args)[1][:, k]
    shape = [1] * ndim
    shape[axis] = v.shape[0]
    return (v.astype(np.float32) if f32 else v).reshape(shape)


def _tap_terms(x, filt, src_dim: int, dst_dim: int, shift: float, axis: int, kind: str,
               b: float, c: float, f32: bool):
    """Products tap_k * w_k of every tap k, in tap order."""
    args = (src_dim, dst_dim, shift, kind, b, c)
    for k in range(filt(*args)[1].shape[1]):
        idx = _on((_tap_index, filt, k, *args), x.device)
        wk = _on((_tap_weights, x.ndim, axis, f32, filt, k, *args), x.device)
        yield x.index_select(axis, idx) * wk


def _resize_axis_q14(x, src_dim: int, dst_dim: int, shift: float, axis: int,
                     pixel_max: int, kind: str = "bicubic", b: float = 0.0,
                     c: float = 0.5):
    """One integer resize pass, zimg WORD semantics: i32 accumulate of Q14
    taps, pack ``clamp((acc + 2^13) >> 14, 0, pixel_max)``."""
    if dst_dim == src_dim and shift == 0.0:
        return x
    acc = None
    for term in _tap_terms(x.to(_I32), _zimg_filter_q14, src_dim, dst_dim, shift, axis,
                           kind, b, c, False):
        acc = term if acc is None else acc + term
    return ((acc + (1 << 13)) >> 14).clamp(0, pixel_max)


def _resize_h_first(xscale: float, yscale: float) -> bool:
    """zimg resize.cpp pass-order cost rule (horizontal taps cost 2x)."""
    h_first_cost = max(xscale, 1.0) * 2.0 + xscale * max(yscale, 1.0)
    v_first_cost = max(yscale, 1.0) + yscale * max(xscale, 1.0) * 2.0
    return h_first_cost < v_first_cost


def _upsample_chroma_int(c, ssw: int, ssh: int, w: int, h: int, bits: int):
    """Integer chroma upsample at storage depth (zimg resizes integer
    pixels in Q14 fixed point BEFORE the float depth conversion)."""
    ch, cw = c.shape[1], c.shape[2]
    pixel_max = (1 << bits) - 1
    hshift = (1.0 - 1.0 / (1 << ssw)) / 2.0 if ssw else 0.0

    def do_h(x):
        return _resize_axis_q14(x, cw, w, hshift, x.ndim - 1, pixel_max)

    def do_v(x):
        return _resize_axis_q14(x, ch, h, 0.0, x.ndim - 2, pixel_max)

    if _resize_h_first(w / cw, h / ch):
        return do_v(do_h(c))
    return do_h(do_v(c))


def _resize_axis_f32_seq(x, src_dim: int, dst_dim: int, shift: float,
                         axis: int, kind: str = "bicubic", b: float = 0.0,
                         c: float = 0.5):
    """One float resize pass in zimg's FLOAT-pixel kernel order: f32
    coefficients (derived in double, rounded once), sequential per-tap
    accumulate ``acc = w_k * x_k + acc`` left to right, each product and
    sum rounded on its own."""
    if dst_dim == src_dim and shift == 0.0:
        return x
    acc = None
    for term in _tap_terms(x, _zimg_filter_taps, src_dim, dst_dim, shift, axis, kind, b,
                           c, True):
        acc = term if acc is None else acc + term
    return acc


def _upsample_chroma(c, ssw: int, ssh: int, w: int, h: int):
    """zimg-convention chroma upsample to luma dims: Catmull-Rom, left-sited
    horizontally (chroma sample k is co-sited with luma column k*2^ssw,
    i.e. shift +0.25 in chroma units for 2x), centered vertically, zimg's
    sequential per-tap f32 ladders, zimg pass order."""
    if ssw == 0 and ssh == 0:
        return c
    ch, cw = c.shape[1], c.shape[2]
    hshift = (1.0 - 1.0 / (1 << ssw)) / 2.0 if ssw else 0.0

    def do_h(x):
        if not ssw:
            return x
        return _resize_axis_f32_seq(x, cw, w, hshift, x.ndim - 1)

    def do_v(x):
        if not ssh:
            return x
        return _resize_axis_f32_seq(x, ch, h, 0.0, x.ndim - 2)

    if _resize_h_first(w / cw, h / ch):
        return do_v(do_h(c))
    return do_h(do_v(c))


def pick_matrix(clip: Clip) -> int:
    """The matrix zimg actually uses for toRGBS: the reference passes
    ``matrix_in = height > 650 ? 709 : 601`` (src/helper.zig:231), but VS
    resize treats ``matrix_in`` as a FALLBACK -- the frame's ``_Matrix``
    prop takes precedence when present and specified.  Only a Python or
    NumPy integer counts; any other value (a tensor included) falls back to
    the height rule, as in the JAX package."""
    m = clip.props.get("_Matrix")
    if isinstance(m, (int, np.integer)):
        m = int(m)
        if m in (5, 6):  # bt470bg / smpte170m: both BT.601 coefficients
            return 6
        if m in _MATRICES:
            return m
    return 1 if clip.height > 650 else 6


def to_rgbs(clip: Clip, matrix: int | None = None) -> Clip:
    """YUV/Gray/RGB -> RGBS (reference toRGBS, src/helper.zig:225-243:
    resize.Bicubic(format=RGBS), matrix from the _Matrix frame prop with
    the height>650 ? 709 : 601 rule as fallback, limited-range YUV
    assumed).  ``matrix`` overrides prop-based selection."""
    fmt = clip.format
    if fmt.color_family is ColorFamily.RGB:
        if fmt.sample_type is SampleType.FLOAT and fmt.bits_per_sample == 32:
            return clip
        peak = (1 << fmt.bits_per_sample) - 1
        planes = tuple(p.to(_F32) * _f32(1.0 / peak) for p in clip.planes)
        return Clip(planes, get_format("RGBS"), dict(clip.props))

    if matrix is None:
        matrix = pick_matrix(clip)
    kr, kb = _MATRICES[matrix]
    kg = 1.0 - kr - kb
    w, h = clip.width, clip.height
    y = _plane_to_float(clip.planes[0], fmt, False)
    if fmt.color_family is ColorFamily.GRAY:
        planes = (y, y, y)
    else:
        ssw, ssh = fmt.subsampling_w, fmt.subsampling_h
        if fmt.sample_type is SampleType.INTEGER and (ssw or ssh):
            # zimg resizes integer pixels at storage depth (Q14 fixed
            # point), then depth-converts to float for the matrix.
            bits = fmt.bits_per_sample
            cb, cr = (_plane_to_float(
                _upsample_chroma_int(p, ssw, ssh, w, h, bits), fmt, True)
                for p in clip.planes[1:])
        else:
            cb, cr = (_upsample_chroma(_plane_to_float(p, fmt, True), ssw, ssh, w, h)
                      for p in clip.planes[1:])
        # ncl inverse matrix coefficients, derived in double, applied in f32
        cr_r = _f32(2.0 * (1.0 - kr))
        cb_b = _f32(2.0 * (1.0 - kb))
        cb_g = _f32(-2.0 * (1.0 - kb) * kb / kg)
        cr_g = _f32(-2.0 * (1.0 - kr) * kr / kg)
        r = y + cr_r * cr
        g = (y + cb_g * cb) + cr_g * cr
        b = y + cb_b * cb
        planes = (r, g, b)
    return Clip(tuple(p.to(_F32) for p in planes), get_format("RGBS"), dict(clip.props))


# Bayer 8x8 ordered-dither matrix (index dither; the documented stand-in for
# zimg error diffusion in ``dither="ordered"``).
_BAYER8 = np.array(
    [
        [0, 48, 12, 60, 3, 51, 15, 63],
        [32, 16, 44, 28, 35, 19, 47, 31],
        [8, 56, 4, 52, 11, 59, 7, 55],
        [40, 24, 36, 20, 43, 27, 39, 23],
        [2, 50, 14, 62, 1, 49, 13, 61],
        [34, 18, 46, 30, 33, 17, 45, 29],
        [10, 58, 6, 54, 9, 57, 5, 53],
        [42, 26, 38, 22, 41, 25, 37, 21],
    ],
    np.int32,
)


def _ordered_bias(h: int, w: int, shift: int) -> np.ndarray:
    """Per-pixel rounding bias for a >>shift demote: (bayer+0.5)/64 * 2^shift."""
    by = _BAYER8[np.arange(h)[:, None] & 7, np.arange(w)[None, :] & 7]
    return np.round((by + 0.5) / 64.0 * (1 << shift)).astype(np.int32)


def _int_dtype(bits: int) -> torch.dtype:
    return torch.uint8 if bits <= 8 else (torch.uint16 if bits <= 16 else torch.uint32)


def bit_depth(clip: Clip, bits: int, sample_type: SampleType | None = None,
              dither: str = "ordered") -> Clip:
    """Depth conversion (the analogue of the reference's ``bitDepth``
    Resize.Point invoke, src/helper.zig:470-494, used by XPSNR's depth
    matching).

    Integer<->integer conversions are bit shifts; integer demotes apply an
    ordered Bayer dither, zimg-exact Floyd-Steinberg with
    ``dither="error_diffusion"`` (native C++ on the host, one frame at a
    time, ``runtime/dither.py``), or round-half-up with ``dither="none"``.
    Integer<->float converts through full-range normalization.
    """
    fmt = clip.format
    st = sample_type or (SampleType.FLOAT if bits == 32 and
                         fmt.sample_type is SampleType.FLOAT else
                         SampleType.INTEGER if bits <= 16 else fmt.sample_type)
    if dither not in ("ordered", "none", "error_diffusion"):
        raise VSZipError(f"bit_depth: unknown dither '{dither}'.")
    out_fmt = fmt.replace(bits_per_sample=bits, sample_type=st)
    if (dither == "error_diffusion" and fmt.sample_type is SampleType.INTEGER
            and st is SampleType.INTEGER and bits < fmt.bits_per_sample):
        from ..runtime.dither import error_diffusion_demote

        shift = fmt.bits_per_sample - bits
        peak = (1 << bits) - 1
        out = []
        for p in clip.planes:
            arr = p.cpu().numpy().astype(np.uint16)
            frames = [error_diffusion_demote(arr[i], 1.0 / (1 << shift), peak)
                      for i in range(arr.shape[0])]
            out.append(torch.from_numpy(np.stack(frames).astype(np.int32))
                       .to(_int_dtype(bits)).to(p.device))
        return Clip(tuple(out), out_fmt, dict(clip.props))
    if st is fmt.sample_type and bits == fmt.bits_per_sample:
        return clip

    out = []
    for p in clip.planes:
        if fmt.sample_type is SampleType.INTEGER and st is SampleType.INTEGER:
            v = p.to(torch.int64)
            if bits >= fmt.bits_per_sample:
                y = (v << (bits - fmt.bits_per_sample)).to(_int_dtype(bits))
            else:
                shift = fmt.bits_per_sample - bits
                if dither == "ordered":
                    v = v + _on((_ordered_bias, p.shape[1], p.shape[2], shift), p.device)
                else:
                    v = v + (1 << (shift - 1))
                y = (v >> shift).clamp(0, (1 << bits) - 1).to(_int_dtype(bits))
        elif fmt.sample_type is SampleType.INTEGER:  # int -> float
            pf = p.to(_F32)
            y = (pf / _scalar((1 << fmt.bits_per_sample) - 1, pf.device)).to(
                torch.float16 if bits == 16 else _F32)
        elif st is SampleType.INTEGER:  # float -> int
            peak = (1 << bits) - 1
            y = torch.round(p.to(_F32) * float(peak)).clamp(0, peak).to(
                torch.int64).to(_int_dtype(bits))
        else:  # float -> float
            y = p.to(torch.float16 if bits == 16 else _F32)
        out.append(y)
    return Clip(tuple(out), out_fmt, dict(clip.props))


# ---------------------------------------------------------------------------
# spatial resize
# ---------------------------------------------------------------------------
#
# zimg semantics: Q14 fixed point for integer pixels (bit-exact), f32 weight
# matrix products for float pixels, left-sited chroma siting shifts, zimg's
# h-first/v-first pass-order cost rule.


def _resize_plane_q14(x, dst_h: int, dst_w: int, shift_w: float,
                      shift_h: float, pixel_max: int, kind: str, b: float,
                      c: float):
    """Integer plane resize, zimg WORD pipeline (one Q14 pass per axis)."""
    src_h, src_w = x.shape[-2], x.shape[-1]

    def do_h(v):
        return _resize_axis_q14(v, src_w, dst_w, shift_w, v.ndim - 1,
                                pixel_max, kind, b, c)

    def do_v(v):
        return _resize_axis_q14(v, src_h, dst_h, shift_h, v.ndim - 2,
                                pixel_max, kind, b, c)

    if _resize_h_first(dst_w / src_w, dst_h / src_h):
        return do_v(do_h(x))
    return do_h(do_v(x))


def _resize_plane_f32(x, dst_h: int, dst_w: int, shift_w: float,
                      shift_h: float, kind: str, b: float, c: float):
    """Float plane resize as two f32 matrix products with zimg
    compute_filter weight matrices (f64-built, f32-applied)."""
    src_h, src_w = x.shape[-2], x.shape[-1]

    def weights(src, dst, shift):
        return _on((_zimg_weight_matrix, src, dst, shift, kind, b, c), x.device)

    def do_h(v):
        if dst_w == src_w and shift_w == 0.0:
            return v
        return torch.matmul(v, weights(src_w, dst_w, shift_w).T)

    def do_v(v):
        if dst_h == src_h and shift_h == 0.0:
            return v
        return torch.matmul(weights(src_h, dst_h, shift_h), v)

    if _resize_h_first(dst_w / src_w, dst_h / src_h):
        return do_v(do_h(x.to(_F32)))
    return do_h(do_v(x.to(_F32)))


def resize(clip: Clip, width: int, height: int, kernel: str = "bicubic",
           b: float = 0.0, c: float = 0.5) -> Clip:
    """Spatial resize of every plane with zimg/VS Resize semantics.
    Integer formats run the Q14 fixed-point pipeline (bit-exact vs zimg);
    float formats run f32 weight-matrix products.  Chroma planes take the
    left-sited (MPEG2, VS default) horizontal siting shift
    0.25*(1 - src_c/dst_c); vertical siting is centered.  Defaults to
    Catmull-Rom bicubic (b=0, c=0.5), the VS Resize.Bicubic default."""
    fmt = clip.format
    if width % (1 << fmt.subsampling_w) or height % (1 << fmt.subsampling_h):
        raise VSZipError(
            "resize: dimensions must respect the format's subsampling.")
    out = []
    for i, p in enumerate(clip.planes):
        ssw = fmt.subsampling_w if i else 0
        ssh = fmt.subsampling_h if i else 0
        dst_w, dst_h = width >> ssw, height >> ssh
        src_w = p.shape[-1]
        shift_w = 0.25 * (1.0 - src_w / dst_w) if ssw else 0.0
        if fmt.sample_type is SampleType.INTEGER:
            peak = (1 << fmt.bits_per_sample) - 1
            y = _resize_plane_q14(p, dst_h, dst_w, shift_w, 0.0, peak,
                                  kernel, b, c).to(p.dtype)
        else:
            y = _resize_plane_f32(p, dst_h, dst_w, shift_w, 0.0,
                                  kernel, b, c).to(p.dtype)
        out.append(y)
    return Clip(tuple(out), fmt, dict(clip.props))


def srgb_to_linear(clip: Clip) -> Clip:
    """sRGB EOTF on an RGBS clip (skipped when the clip already carries
    _Transfer=LINEAR, like the reference's prop check).  zimg gamma.cpp's
    exact-continuity constants (ALPHA=1.055010718947587,
    BETA=0.0030412825601275209), not the canonical 1.055/0.04045 pair."""
    if clip.props.get("_Transfer") == 8:  # LINEAR
        return clip

    alpha = 1.055010718947587
    beta = 0.0030412825601275209

    def lin(v):
        v = v.to(_F32)
        # divisors as 0-dim device tensors: IEEE division on the card too
        lin_part = v / _scalar(12.92, v.device)
        pow_part = torch.pow((v + _f32(alpha - 1.0)) / _scalar(alpha, v.device), _f32(2.4))
        return torch.where(v < _f32(12.92 * beta), lin_part, pow_part)

    planes = tuple(lin(p) for p in clip.planes)
    return Clip(planes, clip.format, {**clip.props, "_Transfer": 8})
