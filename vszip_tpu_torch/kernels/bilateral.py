"""Bilateral's algorithm 2 window: the CUDA wrapper, its plain PyTorch version,
the range weight both algorithms share, and the launch counter.

``bilateral_window(windows)`` filters every plane of one Bilateral call that
takes algorithm 2 (the "truncated" spatial window of
src/filters/bilateral.zig), each described by a ``Window``: taps at
``(+-yy, +-xx)`` for yy, xx in 1, 1 + step, ... <= radius around each sample,
edges replicated, spatial weights from the Gaussian LUT ``gs`` and range
weights ``exp(((min(i, upper) * scale)^2) * -0.5) * c`` of the index ``i``
of the key difference (``_range_index``).  Sums keep the reference's (yy,
xx) order and its four-offset grouping, each product and sum rounded on its
own.  The JAX package computes this in plain jnp; no Pallas kernel stands
behind it.

The wrapper dispatches on the planes' device: CPU tensors take the plain
version (one torch op per step of each tap over a padded copy), CUDA tensors
launch ``window_kernel`` in ``csrc/bilateral.cu`` once for all the call's
planes, or raise.  Nothing falls back.  The kernel keeps every weight,
product and sum in registers and rounds as the plain version does on the
card (``-fmad=false``, CUDA's ``expf``, IEEE division), so the two agree bit
for bit there.  The spatial weights go to the device once per set of
windows and device (``_spatial_on``); a call after that allocates its
outputs and launches, nothing else.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import _build, trace

# Launches made on the CUDA path; the plain version never counts.
LAUNCHES = trace.register_launches({"bilateral_window": 0})

MAX_PLANES = 3
_DTYPES = (torch.uint8, torch.uint16, torch.float16, torch.float32)


class Window(NamedTuple):
    """One plane of an algorithm-2 call: the (N, H, W) source, the plane its
    range keys come from (the source itself, or the joint ref's plane), the
    flat (radius + 1)^2 spatial LUT, sigmaR, the format's histogram length,
    the window's radius and tap step, the integer output's peak and whether
    the plane holds integers."""

    src: torch.Tensor
    ref: torch.Tensor
    gs: np.ndarray
    sigma_r: float
    hist_len: int
    radius: int
    step: int
    peak: float
    is_int: bool


# ---------------------------------------------------------------------------
# the range weight (both algorithms)
# ---------------------------------------------------------------------------

def _gr_consts(hist_len: int, sigma_r: float):
    """(upper, scale, c) of the range weight ``exp(((min(idx, upper) *
    scale)^2) * -0.5) * c`` in f32 (the reference's LUT formula,
    src/filters/bilateral.zig:306-348, with its two f64 divisions folded
    into one f32 scale, as the JAX package evaluates it)."""
    rng = float(hist_len - 1)
    upper = float(np.trunc(min(rng, sigma_r * 8.0 * rng + 0.5)))
    scale = np.float32(1.0 / (rng * float(sigma_r)))
    c = np.float32(1.0 / (math.sqrt(2.0 * math.pi) * sigma_r))
    return float(np.float32(upper)), float(scale), float(c)


def _weight_(idx: torch.Tensor, consts) -> torch.Tensor:
    """Range weight of the int32 index plane `idx`, as a new f32 tensor;
    every step rounds to f32 on its own."""
    upper, scale, c = consts
    t = idx.to(torch.float32).clamp_(max=upper).mul_(scale)
    return t.mul_(t).mul_(-0.5).exp_().mul_(c)


def _range_index(cx, nb, is_int: bool) -> torch.Tensor:
    """int32 LUT index of |cx - nb|: integers as int32 differences; floats
    subtract in the storage dtype, then ``trunc(min(1, |d|) * 65535 + 0.5)``
    in f32."""
    if is_int:
        return torch.sub(cx, nb).abs_()
    ad = torch.sub(cx, nb).abs_().to(torch.float32)
    return ad.clamp_(max=1.0).mul_(65535.0).add_(0.5).to(torch.int32)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _pad_edges(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H+2r, W+2r) copy of `x` with replicated edges (any dtype)."""
    h, w = x.shape[1], x.shape[2]
    iy = torch.arange(-r, h + r, device=x.device).clamp_(0, h - 1)
    ix = torch.arange(-r, w + r, device=x.device).clamp_(0, w - 1)
    return x[:, iy][:, :, ix]


def window_ref(src, ref, gs: np.ndarray, sigma_r: float, hist_len: int, radius: int,
               step: int, peak: float, is_int: bool):
    """Plain version of one ``Window``: full-plane torch ops per step of
    each tap over replicate-padded copies."""
    consts = _gr_consts(hist_len, sigma_r)
    n, h, w = src.shape
    work = torch.int32 if is_int else src.dtype
    refp = _pad_edges(ref.to(work), radius)
    srcp = (refp if src is ref else _pad_edges(src.to(work), radius)).to(torch.float32)

    def tap(a, dy, dx):
        return a[:, radius + dy: radius + dy + h, radius + dx: radius + dx + w]

    cx = tap(refp, 0, 0)
    # gs[0] * grf(0): exp(-0) is exactly 1 in every implementation
    w0 = float(np.float32(gs[0]) * np.float32(consts[2]))
    wsum = torch.full(src.shape, w0, dtype=torch.float32, device=src.device)
    s = tap(srcp, 0, 0).mul(w0)
    radius2 = radius + 1
    for yy in range(1, radius2, step):
        for xx in range(1, radius2, step):
            swei = float(gs[yy * radius2 + xx])
            rsum, acc = None, None
            for dy, dx in ((-yy, xx), (yy, xx), (-yy, -xx), (yy, -xx)):
                rw = _weight_(_range_index(cx, tap(refp, dy, dx), is_int), consts)
                rsum = rw.clone() if rsum is None else rsum.add_(rw)
                prod = rw.mul_(tap(srcp, dy, dx))
                acc = prod if acc is None else acc.add_(prod)
                del rw, prod
            wsum.add_(rsum.mul_(swei))
            s.add_(acc.mul_(swei))
            del rsum, acc
    r = s.div_(wsum)
    del wsum, srcp, refp
    if is_int:
        return r.add_(0.5).clamp_(0.0, peak).trunc_().to(torch.int32).to(src.dtype)
    return r.to(src.dtype)


def bilateral_window_ref(windows) -> tuple:
    """Plain version of ``bilateral_window``: each window on its own."""
    return tuple(window_ref(*win) for win in windows)


# ---------------------------------------------------------------------------
# entry points (the library is built by ``_build`` at the first launch)
# ---------------------------------------------------------------------------

# pointers, ints and floats per plane, then planes, n, dtype, has_ref, peak
_WINDOW = _build.kernel("bilateral", "vz_bilateral_window", *[ctypes.c_void_p] * 3,
                        *[ctypes.c_int] * 4, ctypes.c_float)
_WINDOW_ON_CHIP = _build.entry("bilateral", "vz_bilateral_window_on_chip", ctypes.c_int,
                               ctypes.c_int)


def _samples(radius: int, step: int) -> int:
    return len(range(1, radius + 1, step))


def spatial_weights(win: Window) -> np.ndarray:
    """The window's spatial weights gs(yy, xx) in the kernel's order: yy,
    then xx, each over 1, 1 + step, ... <= radius (f32, samples^2)."""
    r1 = win.radius + 1
    return np.asarray(win.gs, dtype=np.float32).reshape(r1, r1)[1::win.step, 1::win.step].ravel()


@lru_cache(maxsize=64)
def _spatial_on(device: str, blob: bytes) -> torch.Tensor:
    """The f32 values of `blob` on `device`, copied there once."""
    return torch.frombuffer(bytearray(blob), dtype=torch.float32).to(device)


def _check(windows) -> None:
    """Raise unless ``window_kernel`` takes these windows as they are."""
    if not 1 <= len(windows) <= MAX_PLANES:
        raise ValueError(f"vszip_tpu_torch: bilateral_window takes 1 to {MAX_PLANES} planes, "
                         f"got {len(windows)}")
    first = windows[0].src
    for win in windows:
        x, ref = win.src, win.ref
        if x.dtype not in _DTYPES or x.dim() != 3 or not x.is_contiguous():
            raise ValueError("vszip_tpu_torch: bilateral_window takes contiguous (N, H, W) uint8, "
                             f"uint16, float16 or float32 planes, got {x.dtype} {tuple(x.shape)}")
        if (ref.device != x.device or ref.dtype != x.dtype or ref.shape != x.shape
                or not ref.is_contiguous()):
            raise ValueError("vszip_tpu_torch: bilateral_window's ref must be a contiguous "
                             "plane like its source")
        if (x.device != first.device or x.dtype != first.dtype
                or x.shape[0] != first.shape[0] or win.peak != windows[0].peak):
            raise ValueError("vszip_tpu_torch: bilateral_window's planes must share their "
                             "device, dtype, frame count and peak")
        if win.is_int != (not x.is_floating_point()):
            raise ValueError("vszip_tpu_torch: bilateral_window's is_int must follow the dtype")
        if (win.radius < 1 or win.step < 1
                or np.asarray(win.gs).size != (win.radius + 1) ** 2):
            raise ValueError(f"vszip_tpu_torch: bilateral_window does not take radius "
                             f"{win.radius}, step {win.step} with {np.asarray(win.gs).size} "
                             "spatial weights")
    if first.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no Bilateral kernel for device {first.device}")


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

@trace.spanned("vszip.kernel.bilateral_window", profiled=False)
def bilateral_window(windows) -> tuple:
    """Algorithm 2 on every window of one call (1-3 planes of one device,
    dtype and frame count), one launch on the card; returns their outputs in
    order."""
    windows = tuple(windows)
    if windows and all(win.src.device.type == "cpu" for win in windows):
        return bilateral_window_ref(windows)
    _check(windows)
    x = windows[0].src
    weights = [spatial_weights(win) for win in windows]
    table = _spatial_on(str(x.device), np.concatenate(weights).tobytes())
    outs = tuple(torch.empty_like(win.src) for win in windows)
    ptrs, ints, flts = [], [], []
    offset = 0
    for win, wts, out in zip(windows, weights, outs):
        upper, scale, c = _gr_consts(win.hist_len, win.sigma_r)
        w0 = float(np.float32(win.gs[0]) * np.float32(c))
        ptrs += [win.src.data_ptr(), win.ref.data_ptr(), out.data_ptr(),
                 table.data_ptr() + 4 * offset]
        ints += [*win.src.shape[1:], win.radius, win.step, _samples(win.radius, win.step)]
        flts += [upper, scale, c, w0]
        offset += wts.size
    has_ref = any(win.ref.data_ptr() != win.src.data_ptr() for win in windows)
    _WINDOW(x.device, (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(flts))(*flts), len(windows), x.shape[0],
            _DTYPES.index(x.dtype), int(has_ref), windows[0].peak)
    LAUNCHES["bilateral_window"] += 1
    return outs
